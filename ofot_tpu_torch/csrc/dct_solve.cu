// The per-slice body of the exact spectral stepA solve, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _dct_solve_slice_kernel / dct_solve_pallas
// (ofot_tpu/ops/pallas/kernels.py:355 and :383).  The stepA operator
// A = -r*L_st + r*eps*I is diagonal in the orthonormal DCT-II basis; after
// the t-axis transform (a plain matrix product outside this file, as the
// JAX function leaves it to XLA), every t-frequency slice S of shape
// (Ny, Nx) is solved by
//
//   T1 = Cy @ S                  y forward
//   T2 = (T1 @ Cx^T) / D_t       x forward, then the spectral divide
//   T3 = Cy^T @ T2               y inverse
//   out = T3 @ Cx                x inverse
//
// with D_t[y, x] = (-r*(ly[y] + lx[x]) + r*eps) + (-r*lt[t]) assembled from
// the three 1-D Neumann eigenvalue vectors in the epilogue, so no
// (Nt, Ny, Nx) spectrum exists anywhere (as in the JAX function).
//
// Design: one batched fp32 SIMT GEMM kernel, launched four times (one launch
// per contraction, the batch over the Nt slices on grid z).  Each block
// computes a 64x64 output tile from 16-deep shared-memory tiles of both
// operands; each of its 256 threads keeps a 4x4 micro-tile in registers,
// rows ty + 16*i and columns tx + 16*j so that a half-warp reads 16
// consecutive shared-memory words and stores 16 consecutive floats.  The
// transposed operands (Cx^T, Cy^T) are read by index arithmetic at the
// shared-memory load, never materialised; each operand's load is laid out so
// that neighbouring threads read neighbouring addresses.  Out-of-range rows,
// columns and depths are zero-filled, so any Ny and Nx work.
//
// Precision: full float32 (the JAX kernel runs at Precision.HIGHEST and the
// design is fp32 end to end): no TF32, no tensor cores, no split-K.  Every
// output is one fixed-order chain of fused multiply-adds over k, so repeat
// calls are bitwise-equal.
//
// Bound: operations.  The four contractions at (Nt, Ny, Nx) =
// (16, 240, 320) are 2*Nt*Ny*Nx*(2*Ny + 2*Nx) = 2.75 GFLOP, 41 us at the
// H100 SXM's 67 TFLOP/s float32 outside the tensor cores; the bytes (the
// slices in and out, the two matrices) are ~10 MB, 3 us.  A register-tiled
// SIMT GEMM of this simple kind reaches a fraction of that rate; wgmma or
// TF32 would be the way past it, and both are out of scope for an fp32
// port.
//
// Plain C interface (no PyTorch header): raw device pointers, the extents,
// r, r*eps and the stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each

// The spectral divisor's 1-D factors (used by the x-forward launch only).
struct Spectrum {
  const float* lt;   // (Nt,) Neumann eigenvalues along t
  const float* ly;   // (Ny,)
  const float* lx;   // (Nx,)
  float r;
  float reps;        // r * eps
};

// C[b] (M x N) = op(A)[b] (M x K) @ op(B)[b] (K x N), row-major, for every
// batch index b = blockIdx.z.  op(A)(m, k) = A[m*K + k], or A[k*M + m] when
// kTransA; op(B)(k, n) = B[k*N + n], or B[n*K + k] when kTransB.  A batch
// stride of 0 shares one matrix across the batch.  kDivide divides every
// output by the slice's spectral divisor (M = Ny rows, N = Nx columns).
template <bool kTransA, bool kTransB, bool kDivide>
__global__ void __launch_bounds__(kThreads)
batched_gemm_kernel(const float* __restrict__ A, long long strideA,
                    const float* __restrict__ B, long long strideB,
                    float* __restrict__ C, int M, int N, int K,
                    Spectrum spec) {
  // +1 column: the loads write along k for some operands, and the padding
  // spreads those writes over the banks
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];

  const int batch = blockIdx.z;
  A += batch * strideA;
  B += batch * strideB;
  C += (long long)batch * M * N;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      // A tile: contiguous along k (plain) or along m (transposed)
      const int am = kTransA ? idx % kBM : idx / kBK;
      const int ak = kTransA ? idx / kBM : idx % kBK;
      const int gm = m0 + am, gak = k0 + ak;
      float a = 0.f;
      if (gm < M && gak < K)
        a = kTransA ? A[(long long)gak * M + gm] : A[(long long)gm * K + gak];
      As[ak][am] = a;
      // B tile: contiguous along n (plain) or along k (transposed)
      const int bn = kTransB ? idx / kBK : idx % kBN;
      const int bk = kTransB ? idx % kBK : idx / kBN;
      const int gn = n0 + bn, gbk = k0 + bk;
      float b = 0.f;
      if (gn < N && gbk < K)
        b = kTransB ? B[(long long)gn * K + gbk] : B[(long long)gbk * N + gn];
      Bs[bk][bn] = b;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (kDivide) {
        const float sb = -spec.r * (spec.ly[m] + spec.lx[n]) + spec.reps;
        v = v / (sb + -spec.r * spec.lt[batch]);
      }
      C[(long long)m * N + n] = v;
    }
  }
}

template <bool kTransA, bool kTransB, bool kDivide>
void launch_gemm(const float* A, long long strideA, const float* B,
                 long long strideB, float* C, int M, int N, int K, int batch,
                 const Spectrum& spec, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  batched_gemm_kernel<kTransA, kTransB, kDivide>
      <<<grid, kThreads, 0, stream>>>(A, strideA, B, strideB, C, M, N, K,
                                      spec);
}

}  // namespace

extern "C" {

// Solve every t-frequency slice of Fz (Nt, Ny, Nx) into out (same shape),
// using tmp (same shape) as scratch.  Cy (Ny, Ny) and Cx (Nx, Nx) are the
// DCT-II analysis matrices (rows = frequencies); lt, ly, lx the Neumann
// eigenvalue vectors; reps = r * eps.  All arrays are contiguous float32 on
// one device and must not overlap.  Four launches on `stream`; returns the
// first launch error, else cudaGetLastError().
int ofot_dct_solve(const float* Fz, float* out, float* tmp, const float* Cy,
                   const float* Cx, const float* lt, const float* ly,
                   const float* lx, int Nt, int Ny, int Nx, float r,
                   float reps, cudaStream_t stream) {
  if (Nt < 1 || Ny < 1 || Nx < 1 || Nt > 65535)
    return (int)cudaErrorInvalidValue;
  const long long slice = (long long)Ny * Nx;
  const Spectrum spec{lt, ly, lx, r, reps};
  cudaError_t err;
  // tmp = Cy @ S
  launch_gemm<false, false, false>(Cy, 0, Fz, slice, tmp, Ny, Nx, Ny, Nt,
                                   spec, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // out = (tmp @ Cx^T) / D_t
  launch_gemm<false, true, true>(tmp, slice, Cx, 0, out, Ny, Nx, Nx, Nt,
                                 spec, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // tmp = Cy^T @ out
  launch_gemm<true, false, false>(Cy, 0, out, slice, tmp, Ny, Nx, Ny, Nt,
                                  spec, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // out = tmp @ Cx
  launch_gemm<false, false, false>(tmp, slice, Cx, 0, out, Ny, Nx, Nx, Nt,
                                   spec, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
