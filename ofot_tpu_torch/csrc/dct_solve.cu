// The per-slice body of the exact spectral stepA solve, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _dct_solve_slice_kernel / dct_solve_pallas
// (ofot_tpu/ops/pallas/kernels.py:355 and :383).  The stepA operator
// A = -r*L_st + r*eps*I is diagonal in the orthonormal DCT-II basis; after
// the t-axis transform (a plain matrix product outside this file, as the
// JAX function leaves it to XLA), every t-frequency slice S of shape
// (Ny, Nx) is solved by four row-major products
//
//   T1 = Cy @ S                  y forward
//   T2 = (T1 @ CxT) / D_t        x forward, then the spectral divide
//   T3 = CyT @ T2                y inverse
//   out = T3 @ Cx                x inverse
//
// with CyT and CxT the transposes, stored contiguous by the caller, and
// D_t[y, x] = (-r*(ly[y] + lx[x]) + r*eps) + (-r*lt[t]) assembled from the
// three 1-D Neumann eigenvalue vectors in the epilogue, so no (Nt, Ny, Nx)
// spectrum exists anywhere (as in the JAX function).
//
// Precision: float32 accuracy on the tensor cores, by 3xTF32 -- Hopper's
// counterpart of the JAX kernel's Precision.HIGHEST, which on the TPU is a
// multi-pass bf16 emulation of float32.  Each operand value a is split as
// big = rna_tf32(a) and small = rna_tf32(a - big) as its fragment is read
// from shared memory; each k-step runs mma.sync m16n8k8 TF32 three times:
// small*big, big*small, big*big (small*small is below float32's rounding).
// The tensor cores' accumulation does not round like a float32 add: chained
// over a whole contraction it drifted twice the 5e-6 (of max|phi|) the
// plain version is held to at (16, 240, 320) on an H100.  So each 32-deep
// k-tile is summed into a fresh accumulator, which is then added into the
// running sum with a float32 add; that stays well inside the tolerance.  Each output is one fixed
// sequence of steps, so repeat launches are bitwise-equal.
//
// Bound: operations.  The four contractions at (Nt, Ny, Nx) =
// (16, 240, 320) are 2*Nt*Ny*Nx*(2*Ny + 2*Nx) = 2.75 GFLOP: 41 us at the
// H100 SXM's 67 TFLOP/s float32 outside the tensor cores, and 17 us for the
// three TF32 products each at 495 TFLOP/s, the rate of the units this
// design uses; the bytes (the slices in and out, the matrices) are ~10 MB,
// 3 us.
//
// Design: one batched GEMM kernel, launched four times (one launch per
// contraction, the batch over the Nt slices on grid z).  A block of 4 warps
// computes a 64 x 64 output tile, each warp 32 x 32 (2 x 4 m16n8 tiles);
// the K loop walks 32-deep tiles of both operands through two shared-memory
// stages filled by cp.async, so the next tile loads while this one is
// multiplied: 16-byte copies where a row is 16-byte aligned, 4-byte copies
// otherwise, zero-filled at ragged edges, so any Ny and Nx work.
// Shared-memory rows are padded (A: 32 + 4, B: 64 + 8 floats) so that the
// fragment reads hit 32 distinct banks.  At (16, 240, 320) a launch is
// 5 x 4 x 16 = 320 blocks of 128 threads.  On an H100 this took two
// thirds of the time of the float32 SIMT kernel it replaces.  It is far
// from the tensor-core bound, held there by its loads, barriers and
// epilogue rather than its mma steps.  Splitting the DCT matrices once on
// the host and staging both parts was slower (a third tile a stage), as
// were 128-wide tiles and splitting K across two or four warp groups of a
// block; 3 or 4 stages were no faster than 2.

// A lockstep batch of B pairs is one call over B*Nt slices (grid z, at
// most 65535): slice s is t-frequency s % Nt of pair s / Nt, and its
// divisor reads lt[s % Nt] and, where per-pair values are given, that
// pair's r and r*eps.  Each slice runs the same steps as in a single-pair
// call, so each pair's output is bitwise that of a single-pair call on the
// same t-transformed field.
//
// Plain C interface (no PyTorch header): raw device pointers, the extents,
// r, r*eps (or their per-pair arrays) and the stream; the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;   // m16 tiles a warp
constexpr int kNT = kBN / kWarpsN / 8;    // n8 tiles a warp
constexpr int kStages = 2;
constexpr int kAStride = kBK + 4;
constexpr int kBStride = kBN + 8;
constexpr int kATile = kBM * kAStride;
constexpr int kBTile = kBK * kBStride;

// cp.async: each copy names its byte count and how many of those bytes to
// read; the rest of the destination is zero-filled, so a ragged edge is
// loaded as zeros with src_bytes = 0 (the source address must still be a
// valid one).  16-byte copies need 16-byte aligned source and destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight; a __syncthreads() after it makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The spectral divisor's 1-D factors (used by the x-forward launch only).
struct Spectrum {
  const float* lt;   // (Nt,) Neumann eigenvalues along t
  const float* ly;   // (Ny,)
  const float* lx;   // (Nx,)
  int nt;            // Nt: slice s is t-frequency s % nt of pair s / nt
  float r;
  float reps;        // r * eps
  const float* r_pairs;     // per-pair r and r * eps, or nullptr
  const float* reps_pairs;
};

// One operand of a batched product: a row-major (rows x cols) float32
// matrix at p + b * stride for batch index b (stride 0: one matrix for the
// whole batch).  vec: 16-byte copies (cols % 4 == 0, stride % 4 == 0,
// 16-byte aligned).
struct Operand {
  const float* p;
  long long stride;
  bool vec;
};

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(out) : "f"(v));
  return out;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// d += a @ b for one m16n8k8 TF32 tile (a row-major, b column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start the copies of the (kRowsT x kColsT) tile at (r0, c0) of a
// row-major (rows x cols) matrix into shared memory (row stride ld_s);
// points outside the matrix are zero-filled.
template <int kRowsT, int kColsT>
__device__ __forceinline__ void stage_tile(float* dst, int ld_s,
                                           const float* src, int rows,
                                           int cols, int r0, int c0,
                                           bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kChunksRow = kColsT / 4;
    for (int c = tid; c < kRowsT * kChunksRow; c += kThreads) {
      const int row = c / kChunksRow, col = 4 * (c % kChunksRow);
      const int gr = r0 + row, gc = c0 + col;
      const int n = gr < rows ? min(4, max(cols - gc, 0)) : 0;
      cp_async16(dst + row * ld_s + col,
                       n ? src + (long long)gr * cols + gc : src, 4 * n);
    }
  } else {
    for (int c = tid; c < kRowsT * kColsT; c += kThreads) {
      const int row = c / kColsT, col = c % kColsT;
      const int gr = r0 + row, gc = c0 + col;
      const bool ok = gr < rows && gc < cols;
      cp_async4(dst + row * ld_s + col,
                      ok ? src + (long long)gr * cols + gc : src,
                      ok ? 4 : 0);
    }
  }
}

// C[b] (M x N) = A[b] (M x K) @ B[b] (K x N), all row-major, for batch
// index b = blockIdx.z.  kDivide divides every output by the slice's
// spectral divisor (M = Ny rows, N = Nx columns).
template <bool kDivide>
__global__ void __launch_bounds__(kThreads)
gemm_3xtf32_kernel(Operand A, Operand B, float* __restrict__ C, int M,
                   int N, int K, Spectrum spec) {
  constexpr int kStage = kATile + kBTile;
  __shared__ __align__(16) float smem[kStages * kStage];

  const int batch = blockIdx.z;
  const float* a = A.p + batch * A.stride;
  const float* b = B.p + batch * B.stride;
  C += (long long)batch * M * N;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;            // mma group, thread in it
  const int wm = (warp / kWarpsN) * (kBM / kWarpsM);
  const int wn = (warp % kWarpsN) * (kBN / kWarpsN);

  auto stage_k_tile = [&](int kt) {
    float* s = smem + (kt % kStages) * kStage;
    stage_tile<kBM, kBK>(s, kAStride, a, M, K, m0, kt * kBK, A.vec);
    stage_tile<kBK, kBN>(s + kATile, kBStride, b, K, N, kt * kBK, n0, B.vec);
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_tiles = (K + kBK - 1) / kBK;
  // tiles 0 .. kStages-2 in flight; one commit group a tile (empty past
  // the last), so group kt always holds tile kt
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) stage_k_tile(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // every warp is past tile kt-1, so its stage takes tile kt+kStages-1
    if (kt + kStages - 1 < k_tiles) stage_k_tile(kt + kStages - 1);
    cp_async_commit();

    const float* sa = smem + (kt % kStages) * kStage;
    const float* sb = sa + kATile;
    // this k-tile's sum, added into acc with float32 adds below
    float part[kMT][kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[kMT][4], as[kMT][4], bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int row = wm + 16 * i + g;
        split_tf32(sa[row * kAStride + kk + q], ab[i][0], as[i][0]);
        split_tf32(sa[(row + 8) * kAStride + kk + q], ab[i][1], as[i][1]);
        split_tf32(sa[row * kAStride + kk + q + 4], ab[i][2], as[i][2]);
        split_tf32(sa[(row + 8) * kAStride + kk + q + 4], ab[i][3],
                   as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = wn + 8 * j + g;
        split_tf32(sb[(kk + q) * kBStride + col], bb[j][0], bs[j][0]);
        split_tf32(sb[(kk + q + 4) * kBStride + col], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_tf32(part[i][j], as[i], bb[j]);
          mma_tf32(part[i][j], ab[i], bs[j]);
          mma_tf32(part[i][j], ab[i], bb[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // accumulator e of tile (i, j): row g (+8 for e >= 2), column 2q + e%2
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + g + 8 * (e / 2);
        const int n = n0 + wn + 8 * j + 2 * q + e % 2;
        if (m >= M || n >= N) continue;
        float v = acc[i][j][e];
        if (kDivide) {
          float r = spec.r, reps = spec.reps;
          if (spec.r_pairs != nullptr) {
            r = spec.r_pairs[batch / spec.nt];
            reps = spec.reps_pairs[batch / spec.nt];
          }
          const float sb = -r * (spec.ly[m] + spec.lx[n]) + reps;
          v = v / (sb + -r * spec.lt[batch % spec.nt]);
        }
        C[(long long)m * N + n] = v;
      }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A field of (rows x cols) slices, one per batch index.
Operand field(const float* p, int rows, int cols) {
  const long long stride = (long long)rows * cols;
  return {p, stride, cols % 4 == 0 && stride % 4 == 0 && aligned16(p)};
}

// One (n x n) matrix for the whole batch.
Operand matrix(const float* p, int n) {
  return {p, 0, n % 4 == 0 && aligned16(p)};
}

template <bool kDivide>
cudaError_t launch_gemm(const Operand& A, const Operand& B, float* C, int M,
                        int N, int K, int batch, const Spectrum& spec,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  gemm_3xtf32_kernel<kDivide>
      <<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, spec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Solve every t-frequency slice of Fz (batch, Nt, Ny, Nx) into out (same
// shape), using tmp (same shape) as scratch.  Cy (Ny, Ny) and Cx (Nx, Nx)
// are the DCT-II analysis matrices (rows = frequencies), CyT and CxT their
// transposes; lt, ly, lx the Neumann eigenvalue vectors; reps = r * eps.
// r_pairs == nullptr: every pair uses r and reps; else pair b uses
// r_pairs[b] and reps_pairs[b] (batch floats each).  All arrays are
// contiguous float32 on one device and must not overlap.  Four launches on
// `stream`; returns the first launch error, else cudaGetLastError().
int ofot_dct_solve(const float* Fz, float* out, float* tmp, const float* Cy,
                   const float* CyT, const float* Cx, const float* CxT,
                   const float* lt, const float* ly, const float* lx,
                   int batch, int Nt, int Ny, int Nx, float r, float reps,
                   const float* r_pairs, const float* reps_pairs,
                   cudaStream_t stream) {
  if (batch < 1 || Nt < 1 || Ny < 1 || Nx < 1 ||
      (long long)batch * Nt > 65535)
    return (int)cudaErrorInvalidValue;
  const Spectrum spec{lt, ly, lx, Nt, r, reps, r_pairs, reps_pairs};
  const int slices = batch * Nt;
  cudaError_t err;
  // tmp = Cy @ S
  if ((err = launch_gemm<false>(matrix(Cy, Ny), field(Fz, Ny, Nx), tmp, Ny,
                                Nx, Ny, slices, spec, stream)) != cudaSuccess)
    return (int)err;
  // out = (tmp @ CxT) / D_t
  if ((err = launch_gemm<true>(field(tmp, Ny, Nx), matrix(CxT, Nx), out, Ny,
                               Nx, Nx, slices, spec, stream)) != cudaSuccess)
    return (int)err;
  // tmp = CyT @ out
  if ((err = launch_gemm<false>(matrix(CyT, Ny), field(out, Ny, Nx), tmp, Ny,
                                Nx, Ny, slices, spec, stream)) != cudaSuccess)
    return (int)err;
  // out = tmp @ Cx
  return (int)launch_gemm<false>(field(tmp, Ny, Nx), matrix(Cx, Nx), out, Ny,
                                 Nx, Nx, slices, spec, stream);
}

}  // extern "C"
