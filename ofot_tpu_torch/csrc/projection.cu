// Standalone paraboloid projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel _projection_kernel / project_paraboloid_pallas
// (ofot_tpu/ops/pallas/kernels.py:130 and :193).  For every point of the
// (1+K, L) field p (K = 2 balanced, K = 3 source-extended), out = Proj_K(p)
// onto a + |b|^2/2 <= 0, with project_point<K> of paraboloid.cuh (the
// projection the fused stepB/stepC/criterion kernel uses too).
//
// Bound: bytes moved.  One thread per point reads its 1+K components and
// writes them once, coalesced (thread i touches element i of every plane);
// no padding, where the TPU kernel pads L to (8, cols) lane chunks.  At
// (3, 16, 240, 320) float32 that is 29.5 MB, 8.8 us at the H100 SXM's
// 3.35 TB/s; the ~60 float operations a point are far below the card's
// float32 rate.
//
// Plain C interface (no PyTorch header): raw device pointers, the element
// count and the stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include "paraboloid.cuh"

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
projection_kernel(const float* __restrict__ p, float* __restrict__ out,
                  long long L) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  float a = p[i];
  float b[K];
#pragma unroll
  for (int c = 0; c < K; ++c) b[c] = p[(c + 1) * L + i];
  ofot::project_point<K>(a, b);
  out[i] = a;
#pragma unroll
  for (int c = 0; c < K; ++c) out[(c + 1) * L + i] = b[c];
}

}  // namespace

extern "C" {

// ncomp = 1 + K with K in {2, 3}; p and out are contiguous float32 arrays
// of ncomp * L elements.  Returns cudaGetLastError().
int ofot_project_paraboloid(const float* p, float* out, int ncomp,
                            long long L, cudaStream_t stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  const long long nblocks = (L + kThreads - 1) / kThreads;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (ncomp == 3)
    projection_kernel<2><<<(unsigned)nblocks, kThreads, 0, stream>>>(p, out,
                                                                     L);
  else if (ncomp == 4)
    projection_kernel<3><<<(unsigned)nblocks, kThreads, 0, stream>>>(p, out,
                                                                     L);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
