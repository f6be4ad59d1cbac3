// Flow extraction after the ALG2 loop, for Hopper (sm_90a): the
// displacement (u, v) of every pixel's trajectory through the velocities
// of the potential, and the luminosity m = -div(u, v).
//
//   trajectories: phi (B, Nt, Ny, Nx) -> u, v (B, Ny, Nx)
//   divergence:   u, v (B, Ny, Nx)    -> m (B, Ny, Nx)
//
// B = 1 is a single pair.  The function is solvers/flow_extract.py's plain
// path (reference utils.opticalflow_from_benamoubrenier, utils.py:148-183,
// and reconstructTrajectory, utils.py:44-99):
//   * the velocities of slice n, (un, vn) = grad phi_n by central
//     differences (f[i+1] - f[i-1]) / 2 with zero boundary rows ('N');
//     the last slice is zero and never read;
//   * from every pixel (x0, y0), Nt - 1 forward-Euler steps: the cell
//     (tx, ty) = int() of (x, y), truncated toward zero, clamped to
//     [0, N - 2]; offsets dx = x - tx, dy = y - ty from the clamped corner
//     (outside [0, 1) where a trajectory left the grid); the velocity
//     sampled bilinearly with w1 = (1-dy)(1-dx), w2 = dx(1-dy), w3 = dy dx,
//     w4 = (1-dx) dy on the corners (ty, tx), (ty, tx+1), (ty+1, tx+1),
//     (ty+1, tx); (u, v) = (x - x0, y - y0);
//   * m = -(d/dx u + d/dy v), central differences with the Dirichlet
//     boundary: the neighbour beyond the grid reads 0.
//
// Replaces no TPU kernel: the JAX package leaves the extraction to XLA.
// In plain torch it is ~780 small launches a pair (15 steps of 120
// gathers, truncations, clamps and some 30 arithmetic kernels), each
// moving at most 0.3 MB, so the host's launch time is its cost.
//
// Bound: the Nt - 1 dependent steps of a trajectory, each a round of
// gathers from the cache (phi at 320x240 is 4.9 MB, in L2).  Bytes: phi
// read once and u, v, m written once, (Nt + 3) Ny Nx values a pair:
// 5.8 MB at (16, 240, 320) float32, 1.7 us at the H100 SXM's 3.35 TB/s.
//
// Design: two kernels, launched together by one C entry.  The
// trajectories are one thread a start pixel of one pair, on a grid of
// (pixel blocks, B); the thread keeps x and y in registers over the Nt - 1
// steps and forms each corner's velocity from phi as it gathers it (12
// loads a step: rows ty - 1 .. ty + 2, columns tx - 1 .. tx + 2, those
// beyond a boundary skipped where the velocity is zero), so no velocity
// field is written.  The divergence needs the neighbours' (u, v), so it is
// a second launch over the same grid.  32-bit offsets within a pair.
//
// Bitwise: every value is the plain path's float expression in its order,
// each rounding spelled out (add_rn, sub_rn, mul_rn) so that nvcc cannot
// contract a product into a fused multiply-add: the sample is
// ((w1 f00 + w2 f01) + w3 f11) + w4 f10, each product and sum rounded.
// The halving is a multiply by 0.5, as torch's division by the scalar 2.0
// is on the card, and exact either way.  The cell index is the truncating
// conversion torch's trunc().long() makes; a zero velocity is +0, as the
// plain path's boundary fill; m's Dirichlet neighbour is +0, so 0 - u
// keeps the plain path's sign of zero.  float and double alike (a
// template); each pair of a batch is bitwise its single launch.
//
// Plain C interface (no PyTorch header); the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float trunc_of(float a) { return truncf(a); }
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double trunc_of(double a) { return trunc(a); }

// (next - prev) / 2, rounded as the plain path rounds it.
template <typename T>
__device__ __forceinline__ T half_difference(T next, T prev) {
  return mul_rn(sub_rn(next, prev), T(0.5));
}

// The cell of a coordinate: int() toward zero, clamped to [0, n - 2].
template <typename T>
__device__ __forceinline__ int cell_of(T c, int n) {
  const long long t = static_cast<long long>(trunc_of(c));
  return (int)(t < 0 ? 0 : (t > n - 2 ? n - 2 : t));
}

// ((w1 a + w2 b) + w3 c) + w4 d, every product and sum rounded.
template <typename T>
__device__ __forceinline__ T bilinear(T w1, T w2, T w3, T w4, T a, T b, T c,
                                      T d) {
  return add_rn(add_rn(add_rn(mul_rn(w1, a), mul_rn(w2, b)), mul_rn(w3, c)),
                mul_rn(w4, d));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flow_trajectories_kernel(const T* __restrict__ phi, T* __restrict__ u,
                         T* __restrict__ v, int Nt, int Ny, int Nx) {
  const int plane = Ny * Nx;
  const int at = blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= plane) return;
  const int iy = at / Nx, ix = at - iy * Nx;
  const T* p = phi + (size_t)blockIdx.y * Nt * plane;
  const T x0 = (T)ix, y0 = (T)iy;
  T x = x0, y = y0;
  for (int n = 0; n < Nt - 1; ++n, p += plane) {
    const int tx = cell_of(x, Nx), ty = cell_of(y, Ny);
    const T dx = sub_rn(x, (T)tx), dy = sub_rn(y, (T)ty);
    const T ex = sub_rn(T(1), dx), ey = sub_rn(T(1), dy);
    const T w1 = mul_rn(ey, ex), w2 = mul_rn(dx, ey);
    const T w3 = mul_rn(dy, dx), w4 = mul_rn(ex, dy);

    // rows ty and ty + 1 of the slice; a velocity on a boundary row or
    // column is +0 and its neighbours are not read
    const T* r0 = p + ty * Nx;
    const T* r1 = r0 + Nx;
    const bool left = tx == 0, right = tx + 1 == Nx - 1;
    const bool top = ty == 0, bottom = ty + 1 == Ny - 1;
    const T u00 = left ? T(0) : half_difference(r0[tx + 1], r0[tx - 1]);
    const T u01 = right ? T(0) : half_difference(r0[tx + 2], r0[tx]);
    const T u11 = right ? T(0) : half_difference(r1[tx + 2], r1[tx]);
    const T u10 = left ? T(0) : half_difference(r1[tx + 1], r1[tx - 1]);
    const T v00 = top ? T(0) : half_difference(r1[tx], r0[tx - Nx]);
    const T v01 = top ? T(0) : half_difference(r1[tx + 1], r0[tx + 1 - Nx]);
    const T v11 = bottom ? T(0) : half_difference(r1[tx + 1 + Nx],
                                                  r0[tx + 1]);
    const T v10 = bottom ? T(0) : half_difference(r1[tx + Nx], r0[tx]);

    // both samples from the step's (x, y), then both moves
    const T su = bilinear(w1, w2, w3, w4, u00, u01, u11, u10);
    const T sv = bilinear(w1, w2, w3, w4, v00, v01, v11, v10);
    x = add_rn(x, su);
    y = add_rn(y, sv);
  }
  const size_t o = (size_t)blockIdx.y * plane + at;
  u[o] = sub_rn(x, x0);
  v[o] = sub_rn(y, y0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flow_divergence_kernel(const T* __restrict__ u, const T* __restrict__ v,
                       T* __restrict__ m, int Ny, int Nx) {
  const int plane = Ny * Nx;
  const int at = blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= plane) return;
  const int iy = at / Nx, ix = at - iy * Nx;
  const size_t o = (size_t)blockIdx.y * plane + at;
  const T* uo = u + o;
  const T* vo = v + o;
  const T gx = half_difference(ix + 1 < Nx ? uo[1] : T(0),
                               ix > 0 ? uo[-1] : T(0));
  const T gy = half_difference(iy + 1 < Ny ? vo[Nx] : T(0),
                               iy > 0 ? vo[-Nx] : T(0));
  m[o] = -add_rn(gx, gy);
}

// Shapes the kernels take: Nt >= 1, Ny, Nx >= 2, at most 65535 pairs and
// Nt Ny Nx below 2^31 (32-bit offsets within a pair).
bool takes(int batch, int Nt, int Ny, int Nx) {
  return batch >= 1 && batch <= 65535 && Nt >= 1 && Ny >= 2 && Nx >= 2 &&
         (long long)Nt * Ny * Nx < 0x80000000LL;
}

template <typename T>
int launch(const void* phi, void* u, void* v, void* m, int batch, int Nt,
           int Ny, int Nx, cudaStream_t stream) {
  const dim3 grid((Ny * Nx + kThreads - 1) / kThreads, batch);
  flow_trajectories_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(phi), static_cast<T*>(u), static_cast<T*>(v), Nt,
      Ny, Nx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flow_divergence_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), static_cast<T*>(m),
      Ny, Nx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// phi: contiguous (batch, Nt, Ny, Nx); u, v, m: contiguous (batch, Ny, Nx),
// all float32 (is_double 0) or all float64 (is_double 1).  Two launches on
// ``stream``: the trajectories, then the divergence.  Refuses other shapes
// before any launch; returns cudaGetLastError().
int ofot_flow_extract(const void* phi, void* u, void* v, void* m, int batch,
                      int Nt, int Ny, int Nx, int is_double,
                      cudaStream_t stream) {
  if (!takes(batch, Nt, Ny, Nx)) return (int)cudaErrorInvalidValue;
  return is_double
             ? launch<double>(phi, u, v, m, batch, Nt, Ny, Nx, stream)
             : launch<float>(phi, u, v, m, batch, Nt, Ny, Nx, stream);
}

}  // extern "C"
