// The exactly-stabilized Sinkhorn softmin, for Hopper (sm_90a): the
// per-output-entry max-plus logsumexp of solvers/sinkhorn.py _exact_stats,
// in two stages over a potential h (B, Ny, Nx):
//
//   stage 1, over x': for every (pair, y', x)
//     A(x')  = (h[y',x'] - (x-x')^2) / eps
//     M1     = max_x' A(x'),  den1 = sum_x' exp(A(x') - M1)
//     L1     = M1 + log(den1)                                  (nats)
//   stage 2, over y': for every (pair, y, x)
//     B(y')  = L1[y',x] - (y-y')^2 / eps
//     M2     = max_y' B(y'),  den2 = sum_y' exp(B(y') - M2)
//     S      = eps (M2 + log(den2))                       (the softmin)
//
// M1 and M2 are the true per-entry maxima, formed from the same rounded
// terms as the sums, so every exponent is <= 0 and the largest term is
// exactly 1: no float32 envelope, as in the plain path.  The statistics
// instance (kernels named exact_stats_*) also returns the plan-row means
// in the same passes: stage 1 adds sum E1 x' and sum E1 (x-x')^2 (ex1, ec1
// after the division by den1), stage 2 the weighted sums of y', ex1,
// (y-y')^2 and ec1, which give E[y'], E[x'] and E[C] = E[(y-y')^2] + E[ec1].
// The softmin alone runs the kernels named exact_softmin_*.
//
// Replaces no TPU kernel: the JAX package leaves _exact_stats to XLA
// (ofot_tpu/solvers/sinkhorn.py).  In plain torch it walks chunks of 64
// output columns, each materializing (Ny, Nx, 64) and (Ny, Ny, 64)
// temporaries and making ~16 eager passes over them (~2.4 GB of device
// traffic a Sinkhorn iteration at 240x320).
//
// Bound: one exponential a term, Ny Nx Nx + Ny Ny Nx terms a softmin:
// 24.58 M + 18.43 M = 43.0 M at 240x320, 10.3 us at the H100's 132 SMs x
// 16 exponentials a clock x 1.98 GHz (the clock of its 67 TFLOP/s
// float32).  Each term costs some 15 float32 instructions besides (its
// distance, the max pass, the shift, expf's range reduction, the sum), so
// the FP32 issue rate binds first:
// ~25-30 us a softmin.  Bytes are negligible: h read and S written once,
// L1 once each way, 1.2 MB at 240x320 float32.
//
// Design: nothing of size (Ny, Nx, .) exists; L1 (and ex1, ec1 for the
// statistics) of size (B, Ny, Nx) is the only intermediate, in a scratch
// buffer the caller gives.  Both stages run on a grid of (Nx / 32 column
// tiles, Ny / 4 row tiles, B) blocks of 32 x 4 threads, one thread an
// output entry, and walk their contracted axis twice: first the maximum,
// then the shifted sums, four terms at a time in independent partial sums.
// Stage 1 holds its block's 4 rows of h in shared memory; the 32 threads
// of a warp share a row and read each h[y', x'] as one broadcast.  Stage 2
// reads L1[y', x] from global memory (L1 cache / L2), the threads of a
// warp on neighbouring x so that each read is one coalesced line, and
// holds the table (y-y')^2 / eps of its 2 Ny - 1 distances in shared
// memory, divided exactly as the plain path divides them.
//
// Arithmetic: accurate expf/logf (exp/log in float64), no fast math, no
// tensor cores.  Every term is rounded as the plain path rounds it, with
// explicit roundings (a correctly rounded division by eps included), so
// that the maxima are the plain path's and one of the summed terms bit for
// bit.  Sums run in another order than the plain path's, so values agree
// to rounding, not bitwise.
// Fixed orders, no atomics: a launch repeats bitwise, and each pair of a
// batch is bitwise its single call.  float and double alike (a template).
//
// Plain C interface (no PyTorch header); the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kCols = 32;                 // output columns a block (a warp)
constexpr int kRows = 4;                  // output rows a block
constexpr int kThreads = kCols * kRows;
constexpr size_t kStaticSmem = 48 * 1024;  // above: opt in per kernel

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float exp_of(float a) { return expf(a); }
__device__ __forceinline__ float log_of(float a) { return logf(a); }
__device__ __forceinline__ float max_of(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ double exp_of(double a) { return exp(a); }
__device__ __forceinline__ double log_of(double a) { return log(a); }
__device__ __forceinline__ double max_of(double a, double b) {
  return fmax(a, b);
}

// Stage 1's term at distance d = x - x': t / eps with t = h - d^2, rounded
// as the plain path's division rounds it.  From ie = RN(1 / eps), the
// product q = RN(t ie) lies within an ulp of t / eps, the remainder
// t - q eps is exact in one fma, and RN(q + (t - q eps) ie) is the
// correctly rounded quotient (Markstein's theorem; finite t).  The product
// alone would scale every term by the relative error of ie, a bias that
// the Sinkhorn loop's slowest modes gather over its iterations; a division
// in the loop costs a reciprocal on the exponential's own unit.
template <typename T>
__device__ __forceinline__ T term_x(T h, T d, T eps, T ie) {
  const T t = sub_rn(h, mul_rn(d, d));
  const T q = mul_rn(t, ie);
  return fma_rn(fma_rn(-q, eps, t), ie, q);
}

// Stage 1 for the thread's (pair, y', x): returns L1 and, with kMeans,
// the conditional means ex1 = E[x'] and ec1 = E[(x-x')^2] of the row.
template <typename T, bool kMeans>
__device__ __forceinline__ void softmin_x(const T* __restrict__ h,
                                          T* __restrict__ L1,
                                          T* __restrict__ ex1,
                                          T* __restrict__ ec1, int Ny,
                                          int Nx, T eps, T ie) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rows = reinterpret_cast<T*>(smem);
  const size_t pair = (size_t)blockIdx.z * Ny * Nx;
  const int y0 = blockIdx.y * kRows;
  const int held = min(kRows, Ny - y0) * Nx;
  const T* src = h + pair + (size_t)y0 * Nx;
  for (int k = threadIdx.y * kCols + threadIdx.x; k < held; k += kThreads)
    rows[k] = src[k];
  __syncthreads();
  const int yp = y0 + threadIdx.y;
  const int x = blockIdx.x * kCols + threadIdx.x;
  if (yp >= Ny || x >= Nx) return;
  const T* r = rows + threadIdx.y * Nx;
  const T xf = (T)x;

  // pass 1: the true maximum over x'
  T m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
  int j = 0;
  T d = xf;                                  // x - x', exact in T
  for (; j + 4 <= Nx; j += 4, d -= T(4)) {
    m0 = max_of(m0, term_x(r[j], d, eps, ie));
    m1 = max_of(m1, term_x(r[j + 1], d - T(1), eps, ie));
    m2 = max_of(m2, term_x(r[j + 2], d - T(2), eps, ie));
    m3 = max_of(m3, term_x(r[j + 3], d - T(3), eps, ie));
  }
  for (; j < Nx; ++j, d -= T(1)) m0 = max_of(m0, term_x(r[j], d, eps, ie));
  const T M = max_of(max_of(m0, m1), max_of(m2, m3));

  // pass 2: the shifted sums, every exponent <= 0
  T s[4] = {0, 0, 0, 0}, sx[4] = {0, 0, 0, 0}, sc[4] = {0, 0, 0, 0};
  j = 0;
  d = xf;
  for (; j + 4 <= Nx; j += 4, d -= T(4)) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T dk = d - T(k);
      const T e = exp_of(sub_rn(term_x(r[j + k], dk, eps, ie), M));
      s[k] += e;
      if (kMeans) {
        sx[k] += e * (xf - dk);              // x'
        sc[k] += e * mul_rn(dk, dk);         // (x - x')^2
      }
    }
  }
  for (; j < Nx; ++j, d -= T(1)) {
    const T e = exp_of(sub_rn(term_x(r[j], d, eps, ie), M));
    s[0] += e;
    if (kMeans) {
      sx[0] += e * (xf - d);
      sc[0] += e * mul_rn(d, d);
    }
  }
  const T den = (s[0] + s[1]) + (s[2] + s[3]);   // >= 1
  const size_t o = pair + (size_t)yp * Nx + x;
  L1[o] = M + log_of(den);
  if (kMeans) {
    ex1[o] = ((sx[0] + sx[1]) + (sx[2] + sx[3])) / den;
    ec1[o] = ((sc[0] + sc[1]) + (sc[2] + sc[3])) / den;
  }
}

// Stage 2 for the thread's (pair, y, x): S and, with kMeans, the means
// E[y'], E[x'] (over ex1) and E[C] (over (y-y')^2 and ec1).
template <typename T, bool kMeans>
__device__ __forceinline__ void softmin_y(
    const T* __restrict__ L1, const T* __restrict__ ex1,
    const T* __restrict__ ec1, T* __restrict__ S, T* __restrict__ ty,
    T* __restrict__ tx, T* __restrict__ ec, int Ny, int Nx, T eps) {
  // tbl[Ny - 1 + d] = d^2 / eps for d = y - y' in [-(Ny - 1), Ny - 1]
  extern __shared__ __align__(16) unsigned char smem[];
  T* tbl = reinterpret_cast<T*>(smem);
  for (int k = threadIdx.y * kCols + threadIdx.x; k < 2 * Ny - 1;
       k += kThreads) {
    const T d = (T)(k - (Ny - 1));
    tbl[k] = div_rn(mul_rn(d, d), eps);
  }
  __syncthreads();
  const int y = blockIdx.y * kRows + threadIdx.y;
  const int x = blockIdx.x * kCols + threadIdx.x;
  if (y >= Ny || x >= Nx) return;
  const size_t pair = (size_t)blockIdx.z * Ny * Nx;
  const T* col = L1 + pair + x;              // col[y' Nx] = L1[y', x]
  const T* t = tbl + (Ny - 1) + y;           // t[-y'] = (y - y')^2 / eps
  const size_t step = (size_t)Nx;

  // pass 1: the true maximum over y'
  T m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
  int j = 0;
  for (; j + 4 <= Ny; j += 4) {
    const T* c = col + j * step;
    m0 = max_of(m0, sub_rn(__ldg(c), t[-j]));
    m1 = max_of(m1, sub_rn(__ldg(c + step), t[-j - 1]));
    m2 = max_of(m2, sub_rn(__ldg(c + 2 * step), t[-j - 2]));
    m3 = max_of(m3, sub_rn(__ldg(c + 3 * step), t[-j - 3]));
  }
  for (; j < Ny; ++j) m0 = max_of(m0, sub_rn(__ldg(col + j * step), t[-j]));
  const T M = max_of(max_of(m0, m1), max_of(m2, m3));

  // pass 2: the shifted sums
  T s[4] = {0, 0, 0, 0};
  T sy[4] = {0, 0, 0, 0}, sx[4] = {0, 0, 0, 0};
  T sd[4] = {0, 0, 0, 0}, se[4] = {0, 0, 0, 0};
  const T yf = (T)y;
  j = 0;
  T jf = 0;                                  // y', exact in T
  for (; j + 4 <= Ny; j += 4, jf += T(4)) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t at = (j + k) * step;
      const T e = exp_of(sub_rn(sub_rn(__ldg(col + at), t[-j - k]), M));
      s[k] += e;
      if (kMeans) {
        const T yk = jf + T(k), dk = yf - yk;
        sy[k] += e * yk;
        sx[k] += e * __ldg(ex1 + pair + x + at);
        sd[k] += e * mul_rn(dk, dk);
        se[k] += e * __ldg(ec1 + pair + x + at);
      }
    }
  }
  for (; j < Ny; ++j, jf += T(1)) {
    const size_t at = j * step;
    const T e = exp_of(sub_rn(sub_rn(__ldg(col + at), t[-j]), M));
    s[0] += e;
    if (kMeans) {
      const T dk = yf - jf;
      sy[0] += e * jf;
      sx[0] += e * __ldg(ex1 + pair + x + at);
      sd[0] += e * mul_rn(dk, dk);
      se[0] += e * __ldg(ec1 + pair + x + at);
    }
  }
  const T den = (s[0] + s[1]) + (s[2] + s[3]);   // >= 1
  const size_t o = pair + (size_t)y * Nx + x;
  S[o] = eps * (M + log_of(den));
  if (kMeans) {
    ty[o] = ((sy[0] + sy[1]) + (sy[2] + sy[3])) / den;
    tx[o] = ((sx[0] + sx[1]) + (sx[2] + sx[3])) / den;
    ec[o] = ((sd[0] + sd[1]) + (sd[2] + sd[3])) / den
            + ((se[0] + se[1]) + (se[2] + se[3])) / den;
  }
}

// The softmin's two kernels and the statistics' two, named apart so that
// a trace tells them apart.
template <typename T>
__global__ void __launch_bounds__(kThreads)
exact_softmin_x(const T* __restrict__ h, T* __restrict__ L1, int Ny, int Nx,
                T eps, T ie) {
  softmin_x<T, false>(h, L1, nullptr, nullptr, Ny, Nx, eps, ie);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
exact_softmin_y(const T* __restrict__ L1, T* __restrict__ S, int Ny, int Nx,
                T eps) {
  softmin_y<T, false>(L1, nullptr, nullptr, S, nullptr, nullptr, nullptr, Ny,
                      Nx, eps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
exact_stats_x(const T* __restrict__ h, T* __restrict__ L1,
              T* __restrict__ ex1, T* __restrict__ ec1, int Ny, int Nx,
              T eps, T ie) {
  softmin_x<T, true>(h, L1, ex1, ec1, Ny, Nx, eps, ie);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
exact_stats_y(const T* __restrict__ L1, const T* __restrict__ ex1,
              const T* __restrict__ ec1, T* __restrict__ S,
              T* __restrict__ ty, T* __restrict__ tx, T* __restrict__ ec,
              int Ny, int Nx, T eps) {
  softmin_y<T, true>(L1, ex1, ec1, S, ty, tx, ec, Ny, Nx, eps);
}

// Dynamic shared memory past the default 48 KB needs the kernel's opt-in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Shapes the kernels take: Ny, Nx >= 1, at most 65535 pairs, fewer than
// 2^31 entries a pair, and a stage's shared memory within the card's
// opt-in limit (cudaFuncSetAttribute refuses more).
bool takes(int batch, int Ny, int Nx) {
  return batch >= 1 && batch <= 65535 && Ny >= 1 && Nx >= 1 &&
         (long long)Ny * Nx < 0x80000000LL;
}

template <typename T>
int launch(const void* h, void* out, void* scratch, int batch, int Ny,
           int Nx, double eps, bool means, cudaStream_t stream) {
  const size_t plane = (size_t)batch * Ny * Nx;
  T* o = static_cast<T*>(out);
  T* s = static_cast<T*>(scratch);
  const T* hin = static_cast<const T*>(h);
  const T e = (T)eps;
  const T ie = T(1) / e;                     // RN(1 / eps) in T
  const dim3 grid((Nx + kCols - 1) / kCols, (Ny + kRows - 1) / kRows, batch);
  const dim3 block(kCols, kRows);
  const size_t smem_x = (size_t)kRows * Nx * sizeof(T);
  const size_t smem_y = (size_t)(2 * Ny - 1) * sizeof(T);
  cudaError_t err;
  if (!means) {
    if ((err = allow_smem(exact_softmin_x<T>, smem_x)) != cudaSuccess ||
        (err = allow_smem(exact_softmin_y<T>, smem_y)) != cudaSuccess)
      return (int)err;
    exact_softmin_x<T><<<grid, block, smem_x, stream>>>(hin, s, Ny, Nx, e,
                                                        ie);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    exact_softmin_y<T><<<grid, block, smem_y, stream>>>(s, o, Ny, Nx, e);
    return (int)cudaGetLastError();
  }
  if ((err = allow_smem(exact_stats_x<T>, smem_x)) != cudaSuccess ||
      (err = allow_smem(exact_stats_y<T>, smem_y)) != cudaSuccess)
    return (int)err;
  exact_stats_x<T><<<grid, block, smem_x, stream>>>(hin, s, s + plane,
                                                    s + 2 * plane, Ny, Nx,
                                                    e, ie);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  exact_stats_y<T><<<grid, block, smem_y, stream>>>(
      s, s + plane, s + 2 * plane, o, o + plane, o + 2 * plane,
      o + 3 * plane, Ny, Nx, e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h: contiguous (batch, Ny, Nx); out: contiguous (1, batch, Ny, Nx) for
// the softmin S, (4, batch, Ny, Nx) for S, E[y'], E[x'], E[C] with
// want_means; scratch: contiguous (1, batch, Ny, Nx) (L1), or (3, ...)
// with want_means (L1, ex1, ec1).  All float32 (is_double 0) or all
// float64 (is_double 1); eps > 0.  Two launches on ``stream``: stage 1,
// then stage 2.  Refuses other shapes before any launch; returns
// cudaGetLastError().
int ofot_exact_softmin(const void* h, void* out, void* scratch, int batch,
                       int Ny, int Nx, double eps, int want_means,
                       int is_double, cudaStream_t stream) {
  if (!takes(batch, Ny, Nx) || !(eps > 0.0)) return (int)cudaErrorInvalidValue;
  return is_double ? launch<double>(h, out, scratch, batch, Ny, Nx, eps,
                                    want_means != 0, stream)
                   : launch<float>(h, out, scratch, batch, Ny, Nx, eps,
                                   want_means != 0, stream);
}

}  // extern "C"
