// Fused stepB + stepC + criterion pass of one FOTO ALG2 iteration, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _fused_pointwise_kernel / fused_pointwise_pallas
// (ofot_tpu/ops/pallas/kernels.py:224 and :288).  For every grid point of
// the (1+K, L) fields (K = 2 balanced, K = 3 source-extended):
//
//   x     = grad_phi                              (alpha = 1), or
//           alpha*grad_phi + (1-alpha)*q_prev     (over-relaxed ADMM)
//   q     = Proj_K(x + mu/r)     paraboloid a + |b|^2/2 <= 0
//   mu'   = mu + r*(x - q),      density component clamped at >= 0
//   num  += mu'_0 * |g_0 + |g_b|^2/2|,  den += mu'_0 * |g_b|^2
//
// with the criterion on the TRUE grad_phi g.  The host computes
// crit = sqrt(num / (den + 1e-10)).
//
// Bound: bytes moved.  Each component plane is read once and written once,
// coalesced (thread i touches element i of every plane).  At the production
// shape (3, 16, 240, 320) float32 one field is 14.75 MB; the relaxed form
// reads 3 fields and writes 2 (73.7 MB), the alpha = 1 form reads 2 and
// writes 2 (59.0 MB): 22.0 us and 17.6 us at the H100 SXM's 3.35 TB/s.
// The arithmetic (~100 float operations a point) is far below the card's
// float32 rate, so nothing here is tuned for it.
//
// The criterion is reduced in two deterministic stages and with no float
// atomics: every block writes its partial sums to partials[blockIdx.x], and
// a second one-block kernel sums those in a fixed order.  For a given L and
// block count the sums are bitwise-repeatable from run to run, so the ALG2
// stagnation stop |prev - crit| < 1e-5 cannot flip with reduction order.
//
// The projection is project_point<K> of paraboloid.cuh, shared with the
// standalone projection kernel (projection.cu).
//
// A lockstep batch of B pairs (fields of shape (B, 1+K, L), pair-major) is
// one launch on a (blocks per pair, B) grid: grid row b works on pair b's
// fields exactly as a single-pair launch works on them (the same block
// count, the same partition of the points, the same per-block tree), with
// pair b's r read from r_pairs[b] where a per-pair r is given, and the
// second stage reduces each pair's partials in its own block, in the same
// order.  So each pair's q, mu', num and den are bitwise those of a
// single-pair launch on that pair, and a pair's stagnation stop cannot
// flip between a sequential and a lockstep batch.  The bound is B times
// the single-pair bound.
//
// Plain C interface (no PyTorch header): raw device pointers, the element
// count, the batch, r (or r_pairs), alpha and the stream; the launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include "paraboloid.cuh"

namespace {

using ofot::project_point;

constexpr int kThreads = 256;

// Sum v over the block in a fixed tree order; the result is in thread 0.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  smem[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) smem[threadIdx.x] += smem[threadIdx.x + s];
    __syncthreads();
  }
  return smem[0];
}

template <int K, bool kRelaxed>
__global__ void __launch_bounds__(kThreads)
fused_pointwise_kernel(const float* __restrict__ gphi,
                       const float* __restrict__ mu,
                       const float* __restrict__ qprev,
                       float* __restrict__ q_out,
                       float* __restrict__ mu_out,
                       float* __restrict__ partials,
                       long long L, float r,
                       const float* __restrict__ r_pairs, float alpha) {
  __shared__ float smem[kThreads];
  // grid row blockIdx.y is one pair of a batch (row 0 alone otherwise)
  const long long base = (long long)blockIdx.y * (K + 1) * L;
  gphi += base;
  mu += base;
  if (kRelaxed) qprev += base;
  q_out += base;
  mu_out += base;
  partials += 2LL * blockIdx.y * gridDim.x;
  if (r_pairs != nullptr) r = r_pairs[blockIdx.y];
  float num = 0.f, den = 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < L;
       i += stride) {
    float g[K + 1], m[K + 1], x[K + 1];
#pragma unroll
    for (int c = 0; c <= K; ++c) {
      g[c] = gphi[c * L + i];
      m[c] = mu[c * L + i];
      x[c] = kRelaxed ? alpha * g[c] + (1.f - alpha) * qprev[c * L + i]
                      : g[c];
    }
    float a = x[0] + m[0] / r;
    float b[K];
#pragma unroll
    for (int c = 0; c < K; ++c) b[c] = x[c + 1] + m[c + 1] / r;
    project_point<K>(a, b);

    q_out[i] = a;
    const float n0 = fmaxf(m[0] + r * (x[0] - a), 0.f);
    mu_out[i] = n0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      q_out[(c + 1) * L + i] = b[c];
      mu_out[(c + 1) * L + i] = m[c + 1] + r * (x[c + 1] - b[c]);
    }

    float speed2 = 0.f;
#pragma unroll
    for (int c = 1; c <= K; ++c) speed2 += g[c] * g[c];
    num += n0 * fabsf(g[0] + 0.5f * speed2);
    den += n0 * speed2;
  }
  const float bn = block_sum(num, smem);
  __syncthreads();
  const float bd = block_sum(den, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = bn;
    partials[gridDim.x + blockIdx.x] = bd;
  }
}

// One block a pair b: sums[2b] = sum of partials[2bn:2bn+n], sums[2b+1] =
// sum of the next n, each thread first walking its strided share in order.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, int n,
                       float* __restrict__ sums) {
  __shared__ float smem[kThreads];
  partials += 2LL * blockIdx.x * n;
  sums += 2 * blockIdx.x;
  float num = 0.f, den = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    num += partials[j];
    den += partials[n + j];
  }
  const float bn = block_sum(num, smem);
  __syncthreads();
  const float bd = block_sum(den, smem);
  if (threadIdx.x == 0) {
    sums[0] = bn;
    sums[1] = bd;
  }
}

template <int K, bool kRelaxed>
void launch(const float* gphi, const float* mu, const float* qprev,
            float* q_out, float* mu_out, float* partials, float* sums,
            long long L, int nblocks, int batch, float r,
            const float* r_pairs, float alpha, cudaStream_t stream) {
  fused_pointwise_kernel<K, kRelaxed>
      <<<dim3(nblocks, batch), kThreads, 0, stream>>>(
          gphi, mu, qprev, q_out, mu_out, partials, L, r, r_pairs, alpha);
  reduce_partials_kernel<<<batch, kThreads, 0, stream>>>(partials, nblocks,
                                                         sums);
}

}  // namespace

extern "C" {

// Threads per block of the pointwise kernel; the caller sizes the grid
// (and the partials buffer, 2 * nblocks floats) from it.
int ofot_fused_pointwise_threads(void) { return kThreads; }

// ncomp = 1 + K with K in {2, 3}; qprev == nullptr selects the alpha = 1
// form.  Every array is contiguous float32 of batch * ncomp * L elements
// except partials (batch * 2 * nblocks) and sums (batch * 2).  r_pairs ==
// nullptr: every pair uses r; else pair b uses r_pairs[b] (batch floats).
// Returns cudaGetLastError().
int ofot_fused_pointwise(const float* gphi, const float* mu,
                         const float* qprev, float* q_out, float* mu_out,
                         float* partials, float* sums, int ncomp,
                         long long L, int nblocks, int batch, float r,
                         const float* r_pairs, float alpha,
                         cudaStream_t stream) {
  if (L <= 0 || nblocks <= 0 || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const bool relaxed = qprev != nullptr;
  if (ncomp == 3) {
    if (relaxed)
      launch<2, true>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                      nblocks, batch, r, r_pairs, alpha, stream);
    else
      launch<2, false>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                       nblocks, batch, r, r_pairs, alpha, stream);
  } else if (ncomp == 4) {
    if (relaxed)
      launch<3, true>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                      nblocks, batch, r, r_pairs, alpha, stream);
    else
      launch<3, false>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                       nblocks, batch, r, r_pairs, alpha, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* ofot_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
