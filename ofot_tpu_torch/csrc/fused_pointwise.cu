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
// CUDA has cbrtf and acosf, so the projection uses the direct cubic-root
// form of ofot_tpu/ops/projection.py instead of the TPU kernel's exp/log
// cube root and Newton-iterated cos(acos(x)/3).
//
// Plain C interface (no PyTorch header): raw device pointers, the element
// count, r, alpha and the stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kTrigCoef = 1.6329931618554521f;   // 2*sqrt(2/3)
constexpr float kAcosCoef = 1.8371173070873836f;   // (3/2)^(3/2)
constexpr float kEps = 1e-20f;

// Project (alpha, beta_1..beta_K) onto K in place.
template <int K>
__device__ __forceinline__ void project_point(float& a, float (&b)[K]) {
  float rho2 = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) rho2 += b[c] * b[c];
  if (2.f * a + rho2 <= 0.f) return;  // inside K: the point is its own image

  const float rho = sqrtf(rho2);
  const float ap1 = a + 1.f;
  const float radicand = (4.f / 3.f) * ap1 * ap1 * ap1 + 4.5f * rho2;
  float zh;
  if (radicand > 0.f) {
    // Cardano: single real root
    const float s = 0.25f * kSqrt2 * rho + (1.f / 6.f) * sqrtf(radicand);
    const float c = cbrtf(s);
    const float c_safe = c > 0.f ? c : 1.f;
    zh = -(1.f / 3.f) * ap1 / c_safe + c;
  } else {
    // trigonometric: three real roots (alpha < -1)
    const float nam = fmaxf(-ap1, kEps);
    const float arg =
        fminf(fmaxf(kAcosCoef * rho / (nam * sqrtf(nam)), 0.f), 1.f);
    zh = kTrigCoef * sqrtf(nam) * cosf(acosf(arg) / 3.f);
  }
  const bool single = radicand > 0.f;
  a = single ? -zh * zh : -0.5f * zh * zh;
  const float rho_h = single ? kSqrt2 * zh : zh;
  // the beta direction is kept; at rho = 0 the apex case gives rho_h = 0
  const float scale = rho_h / fmaxf(rho, kEps);
#pragma unroll
  for (int c = 0; c < K; ++c) b[c] *= scale;
}

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
                       long long L, float r, float alpha) {
  __shared__ float smem[kThreads];
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

// One block: sums[0] = sum of partials[0:n], sums[1] = sum of
// partials[n:2n], each thread first walking its strided share in order.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, int n,
                       float* __restrict__ sums) {
  __shared__ float smem[kThreads];
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
            long long L, int nblocks, float r, float alpha,
            cudaStream_t stream) {
  fused_pointwise_kernel<K, kRelaxed><<<nblocks, kThreads, 0, stream>>>(
      gphi, mu, qprev, q_out, mu_out, partials, L, r, alpha);
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(partials, nblocks,
                                                     sums);
}

}  // namespace

extern "C" {

// Threads per block of the pointwise kernel; the caller sizes the grid
// (and the partials buffer, 2 * nblocks floats) from it.
int ofot_fused_pointwise_threads(void) { return kThreads; }

// ncomp = 1 + K with K in {2, 3}; qprev == nullptr selects the alpha = 1
// form.  Every array is contiguous float32 of ncomp * L elements except
// partials (2 * nblocks) and sums (2).  Returns cudaGetLastError().
int ofot_fused_pointwise(const float* gphi, const float* mu,
                         const float* qprev, float* q_out, float* mu_out,
                         float* partials, float* sums, int ncomp,
                         long long L, int nblocks, float r, float alpha,
                         cudaStream_t stream) {
  if (L <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  const bool relaxed = qprev != nullptr;
  if (ncomp == 3) {
    if (relaxed)
      launch<2, true>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                      nblocks, r, alpha, stream);
    else
      launch<2, false>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                       nblocks, r, alpha, stream);
  } else if (ncomp == 4) {
    if (relaxed)
      launch<3, true>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                      nblocks, r, alpha, stream);
    else
      launch<3, false>(gphi, mu, qprev, q_out, mu_out, partials, sums, L,
                       nblocks, r, alpha, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* ofot_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
