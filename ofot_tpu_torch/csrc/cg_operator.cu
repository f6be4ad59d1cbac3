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
// Plain C interface (no PyTorch header); the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One axis of the 'N' Laplacian at a point: c is the point, prev/next its
// neighbours along the axis (read only where they exist).  The rounding is
// spelled out, so that both kernels below round alike.
__device__ __forceinline__ float lap_n(float c, float prev, float next,
                                       bool first, bool last) {
  if (first) return __fadd_rn(-c, next);
  if (last) return __fadd_rn(-c, prev);
  return __fadd_rn(__fmaf_rn(-2.f, c, next), prev);
}

// The operator at one point, from its six neighbours (each used only where
// it exists) and which boundaries the point lies on.
__device__ __forceinline__ float apply(float c, float tp, float tn, float xp,
                                      float xn, float yp, float yn, bool t0,
                                      bool t1, bool x0, bool x1, bool y0,
                                      bool y1, float r, float reps) {
  const float lt = lap_n(c, tp, tn, t0, t1);
  const float lx = lap_n(c, xp, xn, x0, x1);
  const float ly = lap_n(c, yp, yn, y0, y1);
  // the order of laplacian_st: t, then x, then y
  return __fmaf_rn(reps, c, __fmul_rn(-r, __fadd_rn(__fadd_rn(lt, lx), ly)));
}

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

}  // extern "C"
