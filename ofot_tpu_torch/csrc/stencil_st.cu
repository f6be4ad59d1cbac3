// Space-time finite differences of one FOTO ALG2 iteration, for Hopper
// (sm_90a): the gradient of the potential, and stepA's right-hand side.
//
//   grad_st:   phi (B, Nt, Ny, Nx) -> (B, 3, Nt, Ny, Nx) = (d/dt, d/dx, d/dy)
//   stepA_rhs: F = div_st(mu - r*q) on (B, 3, Nt, Ny, Nx) fields, with the
//              time-boundary terms that inject rho0 / rhoT into F's first
//              and last planes: F[0] += -(rho0 - mu0[0] + r*q0[0]),
//              F[Nt-1] += rhoT - mu0[Nt-1] + r*q0[Nt-1]
//
// B = 1 is a single pair.  Every axis takes the reference's
// grad_central_weird stencil with bc='N' and unit spacing (reference
// operators.py:34-48 and :114-142, benamou_brenier.py:72-82): the
// interior is (f[i+1] - f[i-1]) / 2, the boundary rows the one-sided
// differences f[1] - f[0] and f[n-1] - f[n-2], not halved.
//
// Replaces no TPU kernel: the JAX package leaves grad_st and div_st to
// XLA, which fuses the shifts into their consumers.  In plain torch they
// are shifted copies (torch.cat), subtractions, scalings and boundary-row
// copies: about 75 kernels and 81 field-sized passes over memory an ALG2
// iteration, where the arithmetic needs 11.
//
// Bound: bytes moved.  grad_st reads phi once and writes its three
// components, 4 fields; stepA_rhs reads mu and q (6 fields) and writes F,
// 7 fields.  At (16, 240, 320) float32 a field is 4.9 MB: 19.7 and
// 34.4 MB, 5.9 and 10.3 us at the H100 SXM's 3.35 TB/s.  The few float
// operations a point are far below the card's float32 rate.
//
// Design: one thread a group of 4 consecutive x points (16-byte loads and
// stores; Nx % 4 == 0 and 16-byte aligned fields) or of one point (any
// other field), on a grid of the field's own coordinates: blockIdx.z the
// plane of the batch (b * Nt + t), blockIdx.y and threadIdx.y the row,
// blockIdx.x and threadIdx.x the group along x.  Each thread reads its
// group and the groups one plane and one row away, and the single points
// left and right of its group; a block's rows share their y neighbours in
// L1, and the planes a wave holds share their t neighbours in L2, so each
// input byte comes from device memory about once.  32-bit offsets (the
// host refuses 2^31 elements or more), no division (the plane splits into
// b and t by a multiply-high), and the boundary rows by selects: where a
// neighbour lies beyond the boundary the point itself stands in for it,
// so the difference is the one-sided one, and only its halving is
// skipped.
//
// Bitwise: every output is the plain torch version's float32 expression
// in its order, each rounding spelled out (__fsub_rn, __fmul_rn,
// __fadd_rn) so that nvcc cannot contract r*q into a fused multiply-add:
// x = mu - r*q per component, each 1-D stencil on x, (t + x) + y, then
// the boundary plane's g = (frame - mu0) + r*q0 added as F + (-g) on the
// first plane and F + g on the last.  The halving is a multiply by 0.5,
// as torch's division by the scalar 2.0 is on the card, and exact either
// way.  A lockstep batch's pair b reads r_pairs[b] where per-pair
// penalties are given; each pair is bitwise a single-pair launch.
//
// Plain C interface (no PyTorch header); the launchers return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block takes at most kRowThreads groups of a row and about
// kBlockThreads threads in all.
constexpr int kRowThreads = 128;
constexpr int kBlockThreads = 256;

template <int W>
struct Group {
  float v[W];
};

template <int W>
__device__ __forceinline__ Group<W> load_group(const float* p) {
  Group<W> g;
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    g.v[0] = q.x;
    g.v[1] = q.y;
    g.v[2] = q.z;
    g.v[3] = q.w;
  } else {
    g.v[0] = *p;
  }
  return g;
}

template <int W>
__device__ __forceinline__ void store_group(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// One axis of grad_central_weird at a point, from its next and previous
// neighbours along the axis (the point itself standing in for the one
// beyond a boundary): halved inside, not on the boundary rows.
__device__ __forceinline__ float central(float next, float prev, bool edge) {
  const float d = __fsub_rn(next, prev);
  return edge ? d : __fmul_rn(d, 0.5f);
}

// x = mu - r*q, rounded as torch rounds its two kernels.
__device__ __forceinline__ float shifted_mu(float m, float q, float r) {
  return __fsub_rn(m, __fmul_rn(r, q));
}

// Where a thread lies: its group's first x, its row, its pair b and time
// t (plane p = b * Nt + t, split as b = umulhi(p, nt_div) with nt_div =
// floor(2^32 / Nt) + 1, exact for p and Nt below 2^16).
struct Point {
  int ix, iy, b, t;
};

template <int W>
__device__ __forceinline__ Point locate(int Nt, unsigned nt_div) {
  Point p;
  p.ix = W * (blockIdx.x * blockDim.x + threadIdx.x);
  p.iy = blockIdx.y * blockDim.y + threadIdx.y;
  p.b = (int)__umulhi(blockIdx.z, nt_div);
  p.t = (int)blockIdx.z - p.b * Nt;
  return p;
}

// grad_st: out (B, 3, Nt, Ny, Nx) from phi (B, Nt, Ny, Nx).
template <int W>
__global__ void __launch_bounds__(kBlockThreads)
stencil_grad_st_kernel(const float* __restrict__ phi,
                       float* __restrict__ out, int Nt, int Ny, int Nx,
                       unsigned nt_div) {
  const Point p = locate<W>(Nt, nt_div);
  if (p.ix >= Nx || p.iy >= Ny) return;
  const int plane = Ny * Nx, at = p.iy * Nx + p.ix;
  const float* c = phi + (int)blockIdx.z * plane + at;
  const bool t0 = p.t == 0, t1 = p.t == Nt - 1;
  const bool y0 = p.iy == 0, y1 = p.iy == Ny - 1;

  const Group<W> gc = load_group<W>(c);
  const Group<W> tp = load_group<W>(t0 ? c : c - plane);
  const Group<W> tn = load_group<W>(t1 ? c : c + plane);
  const Group<W> yp = load_group<W>(y0 ? c : c - Nx);
  const Group<W> yn = load_group<W>(y1 ? c : c + Nx);
  const float left = p.ix > 0 ? c[-1] : gc.v[0];
  const float right = p.ix + W < Nx ? c[W] : gc.v[W - 1];

  float gt[W], gx[W], gy[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int i = p.ix + k;
    gt[k] = central(tn.v[k], tp.v[k], t0 || t1);
    gx[k] = central(k == W - 1 ? right : gc.v[k + 1],
                    k == 0 ? left : gc.v[k - 1], i == 0 || i == Nx - 1);
    gy[k] = central(yn.v[k], yp.v[k], y0 || y1);
  }
  // component 0 of pair b at plane t: ((3 b + 0) Nt + t) planes in
  float* o = out + ((int)blockIdx.z + 2 * p.b * Nt) * plane + at;
  const int vol = Nt * plane;
  store_group<W>(o, gt);
  store_group<W>(o + vol, gx);
  store_group<W>(o + 2 * vol, gy);
}

// stepA_rhs: F (B, Nt, Ny, Nx) from mu, q (B, 3, Nt, Ny, Nx) and the
// frames rho0, rhoT (B, Ny, Nx).
template <int W>
__global__ void __launch_bounds__(kBlockThreads)
stencil_stepA_rhs_kernel(const float* __restrict__ mu,
                         const float* __restrict__ q,
                         const float* __restrict__ rho0,
                         const float* __restrict__ rhoT,
                         float* __restrict__ F, int Nt, int Ny, int Nx,
                         unsigned nt_div, float r,
                         const float* __restrict__ r_pairs) {
  const Point p = locate<W>(Nt, nt_div);
  if (p.ix >= Nx || p.iy >= Ny) return;
  if (r_pairs != nullptr) r = r_pairs[p.b];
  const int plane = Ny * Nx, vol = Nt * plane, at = p.iy * Nx + p.ix;
  const bool t0 = p.t == 0, t1 = p.t == Nt - 1;
  const bool y0 = p.iy == 0, y1 = p.iy == Ny - 1;
  // component 0 of mu and q at the point; components 1 and 2 a field on
  const int c0 = ((int)blockIdx.z + 2 * p.b * Nt) * plane + at;

  // component 0 along t (on the boundary planes the point stands in for
  // the missing plane, so tp or tn is the point's own rho and a)
  const int tp = t0 ? c0 : c0 - plane, tn = t1 ? c0 : c0 + plane;
  const Group<W> m0p = load_group<W>(mu + tp), q0p = load_group<W>(q + tp);
  const Group<W> m0n = load_group<W>(mu + tn), q0n = load_group<W>(q + tn);
  // component 1 along x
  const int c1 = c0 + vol;
  const Group<W> m1 = load_group<W>(mu + c1), q1 = load_group<W>(q + c1);
  const bool has_left = p.ix > 0, has_right = p.ix + W < Nx;
  const float m1l = has_left ? mu[c1 - 1] : m1.v[0];
  const float q1l = has_left ? q[c1 - 1] : q1.v[0];
  const float m1r = has_right ? mu[c1 + W] : m1.v[W - 1];
  const float q1r = has_right ? q[c1 + W] : q1.v[W - 1];
  // component 2 along y
  const int c2 = c0 + 2 * vol;
  const int yp = y0 ? c2 : c2 - Nx, yn = y1 ? c2 : c2 + Nx;
  const Group<W> m2p = load_group<W>(mu + yp), q2p = load_group<W>(q + yp);
  const Group<W> m2n = load_group<W>(mu + yn), q2n = load_group<W>(q + yn);
  // the frame injected on a boundary plane
  Group<W> frame = {};
  if (t0 || t1) frame = load_group<W>((t0 ? rho0 : rhoT) + p.b * plane + at);

  float x1[W + 2];   // component 1 of mu - r*q at ix - 1 .. ix + W
  x1[0] = shifted_mu(m1l, q1l, r);
#pragma unroll
  for (int k = 0; k < W; ++k) x1[k + 1] = shifted_mu(m1.v[k], q1.v[k], r);
  x1[W + 1] = shifted_mu(m1r, q1r, r);

  float f[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int i = p.ix + k;
    const float gt = central(shifted_mu(m0n.v[k], q0n.v[k], r),
                             shifted_mu(m0p.v[k], q0p.v[k], r), t0 || t1);
    const float gx = central(x1[k + 2], x1[k], i == 0 || i == Nx - 1);
    const float gy = central(shifted_mu(m2n.v[k], q2n.v[k], r),
                             shifted_mu(m2p.v[k], q2p.v[k], r), y0 || y1);
    f[k] = __fadd_rn(__fadd_rn(gt, gx), gy);
    if (t0) {
      const float g0 = __fadd_rn(__fsub_rn(frame.v[k], m0p.v[k]),
                                 __fmul_rn(r, q0p.v[k]));
      f[k] = __fadd_rn(f[k], -g0);
    } else if (t1) {
      const float gN = __fadd_rn(__fsub_rn(frame.v[k], m0n.v[k]),
                                 __fmul_rn(r, q0n.v[k]));
      f[k] = __fadd_rn(f[k], gN);
    }
  }
  store_group<W>(F + (int)blockIdx.z * plane + at, f);
}

// The grid of a (B, Nt, Ny, Nx) field for groups of W x points: the
// groups of a row in as few blocks as hold at most kRowThreads each,
// split evenly, and as many rows a block as make about kBlockThreads
// threads.  False where the grid exceeds the card's limits.
bool grid_of(int W, int planes, int Ny, int Nx, dim3* grid, dim3* block) {
  const int groups = Nx / W;
  const int xblocks = (groups + kRowThreads - 1) / kRowThreads;
  const int bx = (groups + xblocks - 1) / xblocks;
  int by = kBlockThreads / bx;
  if (by < 1) by = 1;
  if (by > Ny) by = Ny;
  const int yblocks = (Ny + by - 1) / by;
  if (yblocks > 65535 || planes > 65535) return false;
  *grid = dim3(xblocks, yblocks, planes);
  *block = dim3(bx, by);
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Shapes the kernels take: every extent >= 2, at most 65535 planes (b, t)
// and 3 B Nt Ny Nx below 2^31 (32-bit offsets).
bool takes(int batch, int Nt, int Ny, int Nx) {
  return batch >= 1 && Nt >= 2 && Ny >= 2 && Nx >= 2 &&
         (long long)batch * Nt <= 65535 &&
         3LL * batch * Nt * Ny * Nx < 0x80000000LL;
}

unsigned nt_divisor(int Nt) {
  return (unsigned)(0x100000000ULL / (unsigned)Nt + 1);
}

}  // namespace

extern "C" {

// phi: contiguous float32 (batch, Nt, Ny, Nx); out: contiguous float32
// (batch, 3, Nt, Ny, Nx).  Refuses other shapes before any launch;
// returns cudaGetLastError().
int ofot_stencil_grad_st(const float* phi, float* out, int batch, int Nt,
                         int Ny, int Nx, cudaStream_t stream) {
  if (!takes(batch, Nt, Ny, Nx)) return (int)cudaErrorInvalidValue;
  const bool quad = Nx % 4 == 0 && aligned16(phi) && aligned16(out);
  dim3 grid, block;
  if (!grid_of(quad ? 4 : 1, batch * Nt, Ny, Nx, &grid, &block))
    return (int)cudaErrorInvalidValue;
  if (quad)
    stencil_grad_st_kernel<4><<<grid, block, 0, stream>>>(
        phi, out, Nt, Ny, Nx, nt_divisor(Nt));
  else
    stencil_grad_st_kernel<1><<<grid, block, 0, stream>>>(
        phi, out, Nt, Ny, Nx, nt_divisor(Nt));
  return (int)cudaGetLastError();
}

// mu, q: contiguous float32 (batch, 3, Nt, Ny, Nx); rho0, rhoT: contiguous
// float32 (batch, Ny, Nx); F: contiguous float32 (batch, Nt, Ny, Nx).
// r_pairs == nullptr: every pair uses r; else pair b uses r_pairs[b].
// Refuses other shapes before any launch; returns cudaGetLastError().
int ofot_stencil_stepA_rhs(const float* mu, const float* q,
                           const float* rho0, const float* rhoT, float* F,
                           int batch, int Nt, int Ny, int Nx, float r,
                           const float* r_pairs, cudaStream_t stream) {
  if (!takes(batch, Nt, Ny, Nx)) return (int)cudaErrorInvalidValue;
  const bool quad = Nx % 4 == 0 && aligned16(mu) && aligned16(q) &&
                    aligned16(rho0) && aligned16(rhoT) && aligned16(F);
  dim3 grid, block;
  if (!grid_of(quad ? 4 : 1, batch * Nt, Ny, Nx, &grid, &block))
    return (int)cudaErrorInvalidValue;
  if (quad)
    stencil_stepA_rhs_kernel<4><<<grid, block, 0, stream>>>(
        mu, q, rho0, rhoT, F, Nt, Ny, Nx, nt_divisor(Nt), r, r_pairs);
  else
    stencil_stepA_rhs_kernel<1><<<grid, block, 0, stream>>>(
        mu, q, rho0, rhoT, F, Nt, Ny, Nx, nt_divisor(Nt), r, r_pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
