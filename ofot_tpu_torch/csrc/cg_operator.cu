// The stepA system operator of the CG stepA, for Hopper (sm_90a):
//
//   y = -r * L_st(x) + r*eps * x
//
// on an (Nt, Ny, Nx) float32 field, with L_st the 7-point space-time
// Laplacian and the reference 'N' boundary rows on every axis: row 0 is
// -x0 + x1 and the last row -x_last + x_prev (reference operators.py:104-108).
//
// Replaces both TPU forms of the operator: _cg_op_blocked_kernel /
// cg_operator_pallas_blocked (ofot_tpu/ops/pallas/kernels.py:528 and :589)
// and _cg_op_kernel / cg_operator_pallas (:488 and :495).  The TPU kernels
// stage halo rows into VMEM by DMA from a zero-padded HBM copy with 8-row
// halos and 8/128-rounded extents; those are Mosaic tiling rules.  Here the
// field is read unpadded and each axis selects its 'N' row itself.
//
// Bound: bytes moved.  The field is read once and the result written once:
// at (16, 240, 320) that is 9.8 MB, 2.9 us at the H100 SXM's 3.35 TB/s; the
// ~20 float operations a point are far below the card's float32 rate.
//
// Design: a flat grid with no idle threads, each thread computing 4
// consecutive x points from 16-byte loads of its quad and of the quads
// one t-plane and one y-row away (5 vector loads and 2 scalar loads for
// the x neighbours across the quad's edges, which the neighbouring quads'
// loads have just brought into L1), and one 16-byte store.  That takes
// Nx % 4 == 0 and 16-byte aligned fields; any other field runs the same
// arithmetic one point a thread.  On an H100 this took half the time of
// one point a thread in 128-thread x-row blocks, and less than half that
// of blocks walking t with each plane's tile and halo staged in shared
// memory by cp.async (300 blocks at the sweep shape, 2-3 an SM, one
// barrier a plane).
//
// Every output is the plain version's expression in its order (t, then x,
// then y), the same in both forms, so repeat launches are bitwise-equal.
//
// A lockstep batch of B pairs, (B, Nt, Ny, Nx) pair-major, is one launch
// over its B*Nt planes: a plane's t index is its index mod Nt, so the 'N'
// time rows apply at each pair's own first and last plane and never read
// across pairs, and pair b's r and r*eps come from r_pairs[b] and
// reps_pairs[b] where per-pair values are given.  Each pair's output is
// bitwise that of a single-pair launch; the bound is B times the
// single-pair bound.
//
// Tile form (ofot_cg_operator_tile): the operator on one rank's (Nt, ty,
// tx) tile of a field split over a (y, x) mesh of ranks, the counterpart of
// what cg_operator_pallas_blocked computes on the part of the field a
// device holds when XLA partitions the solve.  The tile comes with the four
// lines next to it (the neighbouring ranks' edge rows and columns), and the
// 'N' rows apply only where a side has no line, i.e. on the global edge.
// Each point evaluates the shared expression of cg_operator.cuh on the
// values it has in the whole field, so the tiles' outputs put together are
// bitwise the whole-field launch's.  Bound: bytes, the tile in and out plus
// the lines, read once: 2.5 MB at a (16, 120, 160) tile, 0.74 us, under
// the ~1.1 us a launch of one thread takes on an H100.  So the kernel is
// short of work, not of bandwidth, and its design shortens what each
// thread does before its loads: a grid whose coordinates are the tile's
// own (plane, row, group of x points), 32-bit offsets and no division (a
// flat grid's index split costs two or three 64-bit divide routines a
// thread before its first load), neighbour addresses chosen by selects
// with every address inside the tile or a line, and a block shape that
// loads the SMs evenly in one wave.  A thread takes 4 x points from 16-byte
// loads (tx % 4 == 0, aligned tile and row lines; the column lines come in
// as scalars) or one point; marching a thread over t planes (each plane
// read once) or over rows, and exchanging x neighbours by warp shuffles,
// measured slower at these shapes: fewer threads hide less latency.
//
// Plain C interface (no PyTorch header); the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cg_operator.cuh"

namespace {

using ofot::apply;

constexpr int kThreads = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Nx % 4 == 0, x and y 16-byte aligned: one thread per 4 consecutive x.
__global__ void __launch_bounds__(kThreads)
cg_operator_quad_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int planes, int Nt, int Ny, int Nx, float r,
                        float reps, const float* __restrict__ r_pairs,
                        const float* __restrict__ reps_pairs) {
  const int nq = Nx / 4;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= (long long)planes * Ny * nq) return;
  const int xq = (int)(q % nq);
  const long long row = q / nq;
  const int iy = (int)(row % Ny), ip = (int)(row / Ny), it = ip % Nt;
  if (r_pairs != nullptr) {
    r = r_pairs[ip / Nt];
    reps = reps_pairs[ip / Nt];
  }
  const long long plane = (long long)Ny * Nx;
  const long long i = row * Nx + 4 * xq;

  const bool t0 = it == 0, t1 = it == Nt - 1;
  const bool y0 = iy == 0, y1 = iy == Ny - 1;
  const float4 c4 = load4(x + i);
  const float4 tp4 = t0 ? c4 : load4(x + i - plane);
  const float4 tn4 = t1 ? c4 : load4(x + i + plane);
  const float4 yp4 = y0 ? c4 : load4(x + i - Nx);
  const float4 yn4 = y1 ? c4 : load4(x + i + Nx);
  const float left = xq == 0 ? 0.f : x[i - 1];
  const float right = xq == nq - 1 ? 0.f : x[i + 4];

  const float c[4] = {c4.x, c4.y, c4.z, c4.w};
  const float tp[4] = {tp4.x, tp4.y, tp4.z, tp4.w};
  const float tn[4] = {tn4.x, tn4.y, tn4.z, tn4.w};
  const float yp[4] = {yp4.x, yp4.y, yp4.z, yp4.w};
  const float yn[4] = {yn4.x, yn4.y, yn4.z, yn4.w};
  const float xp[4] = {left, c4.x, c4.y, c4.z};
  const float xn[4] = {c4.y, c4.z, c4.w, right};
  float out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ix = 4 * xq + k;
    out[k] = apply(c[k], tp[k], tn[k], xp[k], xn[k], yp[k], yn[k], t0, t1,
                   ix == 0, ix == Nx - 1, y0, y1, r, reps);
  }
  *reinterpret_cast<float4*>(y + i) =
      make_float4(out[0], out[1], out[2], out[3]);
}

// Any field: one thread per point.
__global__ void __launch_bounds__(kThreads)
cg_operator_point_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int planes, int Nt, int Ny, int Nx, float r,
                         float reps, const float* __restrict__ r_pairs,
                         const float* __restrict__ reps_pairs) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long plane = (long long)Ny * Nx;
  if (i >= planes * plane) return;
  const int ix = (int)(i % Nx);
  const int iy = (int)((i / Nx) % Ny), ip = (int)(i / plane), it = ip % Nt;
  if (r_pairs != nullptr) {
    r = r_pairs[ip / Nt];
    reps = reps_pairs[ip / Nt];
  }
  const bool t0 = it == 0, t1 = it == Nt - 1;
  const bool x0 = ix == 0, x1 = ix == Nx - 1;
  const bool y0 = iy == 0, y1 = iy == Ny - 1;
  y[i] = apply(x[i], t0 ? 0.f : x[i - plane], t1 ? 0.f : x[i + plane],
               x0 ? 0.f : x[i - 1], x1 ? 0.f : x[i + 1],
               y0 ? 0.f : x[i - Nx], y1 ? 0.f : x[i + Nx], t0, t1, x0, x1,
               y0, y1, r, reps);
}

// ---------------------------------------------------------- tile form
//
// One rank's (Nt, ty, tx) tile of a (y, x)-split field.  up/down are the
// (Nt, tx) rows just above and below the tile, left/right the (Nt, ty)
// columns just left and right of it, each a neighbouring rank's edge line;
// a null line is a global edge, where the 'N' row applies.  A neighbour
// across a tile edge is read from its line, so each point sees the values
// and boundary flags it has in the whole field.

struct Halos {
  const float* up;
  const float* down;
  const float* left;
  const float* right;
};

// A block holds the x groups of a row (at most kTileRowThreads, split
// evenly over as few blocks as that takes) times rows, for kTileMinThreads
// to kTileMaxThreads threads.
constexpr int kTileRowThreads = 64;
constexpr int kTileMinThreads = 128;
constexpr int kTileMaxThreads = 320;

template <int W>
struct Group {
  float v[W];
};

template <int W>
__device__ __forceinline__ Group<W> load_group(const float* p) {
  Group<W> g;
  if constexpr (W == 4) {
    const float4 q = load4(p);
    g.v[0] = q.x;
    g.v[1] = q.y;
    g.v[2] = q.z;
    g.v[3] = q.w;
  } else {
    g.v[0] = *p;
  }
  return g;
}

// One thread a group of W x points at (it, iy): blockIdx.z is the plane,
// blockIdx.y and threadIdx.y the row, blockIdx.x and threadIdx.x the group
// along x.  32-bit offsets (the host refuses 2^31 points or more), no
// division; the t edges are block-uniform.  Each neighbour is read from
// the tile or from the line across the tile's edge; where a line is null
// (a global edge) x stands in for it, so every address is inside x and
// the value read there is one apply ignores.  W = 4: tx % 4 == 0 and x, y,
// up, down 16-byte aligned.
template <int W>
__global__ void __launch_bounds__(kTileMaxThreads)
cg_operator_tile_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int Nt, int ty, int tx, Halos h, float r,
                        float reps) {
  const int ix = W * (blockIdx.x * blockDim.x + threadIdx.x);
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const int it = blockIdx.z;
  if (ix >= tx || iy >= ty) return;
  const int plane = ty * tx;
  const int i = it * plane + iy * tx + ix;
  const int line_y = it * tx + ix;   // in up/down
  const int line_x = it * ty + iy;   // in left/right
  const float* c = x + i;

  const bool t0 = it == 0, t1 = it == Nt - 1;
  const bool y0 = iy == 0 && h.up == nullptr;
  const bool y1 = iy == ty - 1 && h.down == nullptr;
  const bool x0 = ix == 0 && h.left == nullptr;
  const bool x1 = ix + W == tx && h.right == nullptr;
  const float* up = h.up != nullptr ? h.up : x;
  const float* down = h.down != nullptr ? h.down : x;
  const float* left = h.left != nullptr ? h.left : x;
  const float* right = h.right != nullptr ? h.right : x;
  const float* tp = t0 ? c : c - plane;
  const float* tn = t1 ? c : c + plane;
  const float* yp = iy > 0 ? c - tx : up + line_y;
  const float* yn = iy < ty - 1 ? c + tx : down + line_y;
  const float* xp = ix > 0 ? c - 1 : left + line_x;
  const float* xn = ix + W < tx ? c + W : right + line_x;

  const Group<W> gc = load_group<W>(c);
  const Group<W> gtp = load_group<W>(tp), gtn = load_group<W>(tn);
  const Group<W> gyp = load_group<W>(yp), gyn = load_group<W>(yn);
  const float xpv = *xp, xnv = *xn;
  float out[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    out[k] = apply(gc.v[k], gtp.v[k], gtn.v[k], k == 0 ? xpv : gc.v[k - 1],
                   k == W - 1 ? xnv : gc.v[k + 1], gyp.v[k], gyn.v[k], t0,
                   t1, k == 0 && x0, k == W - 1 && x1, y0, y1, r, reps);
  }
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(y + i) =
        make_float4(out[0], out[1], out[2], out[3]);
  } else {
    y[i] = out[0];
  }
}

// The launch of the tile kernel: the x groups of a row in as few blocks as
// hold at most kTileRowThreads each, split evenly; then, among the row
// counts that give kTileMinThreads to kTileMaxThreads a block, the one
// whose grid loads the card's SMs most evenly (blocks / (SMs * the most
// blocks an SM gets); ties: more rows).  All blocks are resident at once
// at the shapes the tiled solves give, so that grid is one balanced wave.
template <int W>
int launch_tile(const float* x, float* y, int Nt, int ty, int tx,
                const Halos& h, float r, float reps, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int groups = tx / W;
  const int xblocks = (groups + kTileRowThreads - 1) / kTileRowThreads;
  const int bx = (groups + xblocks - 1) / xblocks;
  const int hi = kTileMaxThreads / bx < ty ? kTileMaxThreads / bx : ty;
  const int lo_threads = (kTileMinThreads + bx - 1) / bx;
  const int lo = lo_threads < hi ? lo_threads : hi;
  int by = hi;
  double best = -1.0;
  for (int rows = lo; rows <= hi; ++rows) {
    const long long blocks =
        (long long)xblocks * ((ty + rows - 1) / rows) * Nt;
    const double fill = (double)blocks / (sms * ((blocks + sms - 1) / sms));
    if (fill >= best) {
      best = fill;
      by = rows;
    }
  }
  const int yblocks = (ty + by - 1) / by;
  if (yblocks > 65535 || Nt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(xblocks, yblocks, Nt), block(bx, by);
  cg_operator_tile_kernel<W><<<grid, block, 0, stream>>>(x, y, Nt, ty, tx, h,
                                                         r, reps);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x and y are contiguous float32 (batch, Nt, Ny, Nx) arrays, every extent
// >= 2.  reps = r * eps.  r_pairs == nullptr: every pair uses r and reps;
// else pair b uses r_pairs[b] and reps_pairs[b] (batch floats each).
// Returns cudaGetLastError().
int ofot_cg_operator(const float* x, float* y, int batch, int Nt, int Ny,
                     int Nx, float r, float reps, const float* r_pairs,
                     const float* reps_pairs, cudaStream_t stream) {
  if (batch < 1 || Nt < 2 || Ny < 2 || Nx < 2 ||
      (long long)batch * Nt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int planes = batch * Nt;
  const long long n = (long long)planes * Ny * Nx;
  if (Nx % 4 == 0 && aligned16(x) && aligned16(y)) {
    const long long blocks = (n / 4 + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cg_operator_quad_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, planes, Nt, Ny, Nx, r, reps, r_pairs, reps_pairs);
  } else {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cg_operator_point_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, planes, Nt, Ny, Nx, r, reps, r_pairs, reps_pairs);
  }
  return (int)cudaGetLastError();
}

// x and y are one rank's contiguous float32 (Nt, ty, tx) tile, Nt >= 2,
// of fewer than 2^31 points, with at most 65535 planes and few enough
// rows for 65535 row blocks.  up/down: the contiguous (Nt, tx) rows above
// and below it; left/right: the contiguous (Nt, ty) columns left and right
// of it; nullptr where the tile lies on the global edge.  A tile one line
// wide needs a line on at least one side of that axis (the field is >= 2
// wide).  reps = r * eps.  Refuses other tiles before any launch; returns
// cudaGetLastError().
int ofot_cg_operator_tile(const float* x, float* y, int Nt, int ty, int tx,
                          const float* up, const float* down,
                          const float* left, const float* right, float r,
                          float reps, cudaStream_t stream) {
  if (Nt < 2 || ty < 1 || tx < 1 ||
      (long long)Nt * ty * tx > 0x7fffffffLL ||
      (ty < 2 && up == nullptr && down == nullptr) ||
      (tx < 2 && left == nullptr && right == nullptr))
    return (int)cudaErrorInvalidValue;
  const Halos h{up, down, left, right};
  if (tx % 4 == 0 && aligned16(x) && aligned16(y) &&
      (up == nullptr || aligned16(up)) &&
      (down == nullptr || aligned16(down)))
    return launch_tile<4>(x, y, Nt, ty, tx, h, r, reps, stream);
  return launch_tile<1>(x, y, Nt, ty, tx, h, r, reps, stream);
}

}  // extern "C"
