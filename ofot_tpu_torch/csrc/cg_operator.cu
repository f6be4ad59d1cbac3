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
// halos and 8/128-rounded extents; those are Mosaic tiling rules.  Here one
// thread computes one point, x fastest, reading its six neighbours straight
// from device memory with the boundary rows selected per axis: no padded
// copy and no rounding.
//
// Bound: bytes moved.  The field is read once and the result written once:
// at (16, 240, 320) that is 9.8 MB, 2.9 us at the H100 SXM's 3.35 TB/s.  The
// neighbours' re-reads hit L1/L2 (a block's x row and the rows above and
// below it are touched by neighbouring blocks in the same wave); the ~20
// float operations a point are far below the card's float32 rate.
//
// Plain C interface (no PyTorch header); the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// One axis of the 'N' Laplacian at a point: c is the point, prev/next its
// neighbours along the axis (read only where they exist).
__device__ __forceinline__ float lap_n(float c, float prev, float next,
                                       bool first, bool last) {
  if (first) return -c + next;
  if (last) return -c + prev;
  return (next - 2.f * c) + prev;
}

__global__ void __launch_bounds__(kThreads)
cg_operator_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int Nt, int Ny, int Nx, float r, float reps) {
  const int ix = blockIdx.x * kThreads + threadIdx.x;
  if (ix >= Nx) return;
  const int iy = blockIdx.y;
  const int it = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const long long i = it * plane + (long long)iy * Nx + ix;

  const float c = x[i];
  const bool t0 = it == 0, t1 = it == Nt - 1;
  const bool y0 = iy == 0, y1 = iy == Ny - 1;
  const bool x0 = ix == 0, x1 = ix == Nx - 1;
  const float lt = lap_n(c, t0 ? 0.f : x[i - plane], t1 ? 0.f : x[i + plane],
                         t0, t1);
  const float lx = lap_n(c, x0 ? 0.f : x[i - 1], x1 ? 0.f : x[i + 1], x0, x1);
  const float ly = lap_n(c, y0 ? 0.f : x[i - Nx], y1 ? 0.f : x[i + Nx], y0,
                         y1);
  // the order of laplacian_st: t, then x, then y
  y[i] = -r * ((lt + lx) + ly) + reps * c;
}

}  // namespace

extern "C" {

// x and y are contiguous float32 (Nt, Ny, Nx) arrays, every extent >= 2,
// Ny and Nt <= 65535 (grid limits).  reps = r * eps.  Returns
// cudaGetLastError().
int ofot_cg_operator(const float* x, float* y, int Nt, int Ny, int Nx,
                     float r, float reps, cudaStream_t stream) {
  if (Nt < 2 || Ny < 2 || Nx < 2 || Ny > 65535 || Nt > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Nx + kThreads - 1) / kThreads, Ny, Nt);
  cg_operator_kernel<<<grid, kThreads, 0, stream>>>(x, y, Nt, Ny, Nx, r,
                                                    reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
