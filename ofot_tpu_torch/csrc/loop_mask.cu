// The per-pair freeze of the device loop (solvers/device_loop.py), for
// Hopper (sm_90a): two kernels that each iteration of a captured block
// launches once.
//
//   select_scalars: out[f][b] = run[b] ? new[f][b] : old[f][b] for every
//                   per-pair scalar f of the loop's state (criteria,
//                   counters, flags: one element a pair, of 1, 2, 4 or 8
//                   bytes), all of them in one launch;
//   latch_fields:   for every pair b with run[b] && !nxt[b] (the pair
//                   stopped at this iteration), its segment of every
//                   carried field copied into the loop's held buffers:
//                   held[f][b] = src[f][b].  No pair stopped: nothing.
//
// Replaces no TPU kernel: lax.while_loop's carry keeps a stopped loop's
// state for free, and under jax.vmap XLA selects every carried field every
// iteration.  Here that select (torch.where over every field) read two
// whole states and wrote a third at every iteration, though a pair's state
// is needed once, at the iteration where it stops.  The loop now carries
// its fields unmasked, freezes only the per-pair scalars (select_scalars:
// so the running flag stays false once false), and keeps each pair's
// fields as they were at its stop (latch_fields).  Copies are exact, so
// the loop's result is bitwise the host loop's.
//
// Bound: on an iteration where no pair stops (all but one a pair),
// latch_fields is bound by its launch: each block reads the B flags and
// returns.  On the one where a pair stops it is bound by bytes: that
// pair's fields read once and written once (FOTO: 7 fields of Nt Ny Nx
// float32, 34.4 MB each way at (16, 240, 320); WFR 9).  select_scalars
// moves a few bytes a pair and is bound by its launch.
//
// Design: select_scalars is one thread an element of (field, pair), a
// grid-stride loop over at most a few blocks.  latch_fields is a grid of a
// few blocks an SM: every thread reads the flags first, so an iteration
// with no stop costs a launch of blocks that exit at once; where a pair
// fires, the blocks stride over its contiguous segment of each field in
// 16-byte vectors (4 in flight a thread), or 4- or 1-byte words where a
// segment or a pointer is not 16-byte aligned.  The field pointers, sizes
// and segment lengths go by value in the kernel's parameters, so a graph
// that captured the launch replays it with no host work.
//
// Plain C interface (no PyTorch header); the launchers return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kSelectThreads = 128;
constexpr int kLatchThreads = 256;
constexpr int kLatchBlocksPerSM = 4;
constexpr int kUnroll = 4;

struct ScalarArgs {
  const void* nw[kMaxFields];
  const void* old[kMaxFields];
  void* out[kMaxFields];
  int size[kMaxFields];          // bytes an element: 1, 2, 4 or 8
  int nfields;
};

struct LatchArgs {
  const void* src[kMaxFields];
  void* held[kMaxFields];
  long long words[kMaxFields];    // a pair's segment, in words of W bytes
  int nfields;
};

template <typename T>
__device__ __forceinline__ void pick(const ScalarArgs& a, int f, int b,
                                     bool run) {
  const T* src = static_cast<const T*>(run ? a.nw[f] : a.old[f]);
  static_cast<T*>(a.out[f])[b] = src[b];
}

__global__ void __launch_bounds__(kSelectThreads)
loop_select_scalars_kernel(const unsigned char* __restrict__ run, int pairs,
                           ScalarArgs a) {
  const int total = a.nfields * pairs;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int f = i / pairs, b = i - f * pairs;
    const bool r = run[b] != 0;
    switch (a.size[f]) {
      case 1: pick<uint8_t>(a, f, b, r); break;
      case 2: pick<uint16_t>(a, f, b, r); break;
      case 4: pick<uint32_t>(a, f, b, r); break;
      default: pick<uint64_t>(a, f, b, r); break;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLatchThreads)
loop_latch_fields_kernel(const unsigned char* __restrict__ run,
                         const unsigned char* __restrict__ nxt, int pairs,
                         LatchArgs a) {
  bool fires = false;
  for (int b = 0; b < pairs; ++b) fires |= run[b] != 0 && nxt[b] == 0;
  if (!fires) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = 0; b < pairs; ++b) {
    if (run[b] == 0 || nxt[b] != 0) continue;
    for (int f = 0; f < a.nfields; ++f) {
      const long long n = a.words[f];
      const T* __restrict__ src = static_cast<const T*>(a.src[f]) + b * n;
      T* __restrict__ dst = static_cast<T*>(a.held[f]) + b * n;
      long long i = first;
      for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
        T v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) v[k] = src[i + k * stride];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) dst[i + k * stride] = v[k];
      }
      for (; i < n; i += stride) dst[i] = src[i];
    }
  }
}

bool aligned(const void* p, int w) {
  return reinterpret_cast<uintptr_t>(p) % w == 0;
}

// The SM count of the current device, queried once a device (the first
// launch is the device loop's eager warm-up, before any capture).
int sm_count(int* sms) {
  static int known[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (known[device] == 0) {
    err = cudaDeviceGetAttribute(&known[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = known[device];
  return 0;
}

template <typename T>
int launch_latch(const unsigned char* run, const unsigned char* nxt,
                 int pairs, LatchArgs a, const long long* seg_bytes,
                 cudaStream_t stream) {
  for (int f = 0; f < a.nfields; ++f)
    a.words[f] = seg_bytes[f] / (long long)sizeof(T);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  loop_latch_fields_kernel<T>
      <<<sms * kLatchBlocksPerSM, kLatchThreads, 0, stream>>>(run, nxt,
                                                              pairs, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// run: bool (pairs,); nw[f], old[f], out[f]: contiguous (pairs,) elements
// of size[f] bytes (1, 2, 4 or 8).  At most 16 fields; refuses anything
// else before any launch.  nfields == 0 launches nothing.
int ofot_loop_select_scalars(const void* run, int pairs, int nfields,
                             const void* const* nw, const void* const* old,
                             void* const* out, const int* size,
                             cudaStream_t stream) {
  if (pairs < 1 || nfields < 0 || nfields > kMaxFields)
    return (int)cudaErrorInvalidValue;
  if (nfields == 0) return 0;
  ScalarArgs a = {};
  for (int f = 0; f < nfields; ++f) {
    const int s = size[f];
    if (s != 1 && s != 2 && s != 4 && s != 8)
      return (int)cudaErrorInvalidValue;
    a.nw[f] = nw[f];
    a.old[f] = old[f];
    a.out[f] = out[f];
    a.size[f] = s;
  }
  a.nfields = nfields;
  const long long total = (long long)nfields * pairs;
  if (total >= 0x80000000LL) return (int)cudaErrorInvalidValue;
  long long blocks = (total + kSelectThreads - 1) / kSelectThreads;
  if (blocks > 64) blocks = 64;
  loop_select_scalars_kernel<<<(int)blocks, kSelectThreads, 0, stream>>>(
      static_cast<const unsigned char*>(run), pairs, a);
  return (int)cudaGetLastError();
}

// run, nxt: bool (pairs,); src[f], held[f]: contiguous fields of pairs
// segments of seg_bytes[f] bytes each, pair-major.  At most 16 fields;
// refuses anything else before any launch.  nfields == 0 launches nothing.
int ofot_loop_latch_fields(const void* run, const void* nxt, int pairs,
                           int nfields, const void* const* src,
                           void* const* held, const long long* seg_bytes,
                           cudaStream_t stream) {
  if (pairs < 1 || nfields < 0 || nfields > kMaxFields)
    return (int)cudaErrorInvalidValue;
  if (nfields == 0) return 0;
  LatchArgs a = {};
  int width = 16;
  for (int f = 0; f < nfields; ++f) {
    if (seg_bytes[f] < 1) return (int)cudaErrorInvalidValue;
    a.src[f] = src[f];
    a.held[f] = held[f];
    while (width > 1 && (seg_bytes[f] % width != 0 ||
                         !aligned(src[f], width) || !aligned(held[f], width)))
      width /= 4;
  }
  a.nfields = nfields;
  const unsigned char* r = static_cast<const unsigned char*>(run);
  const unsigned char* x = static_cast<const unsigned char*>(nxt);
  if (width == 16) return launch_latch<uint4>(r, x, pairs, a, seg_bytes,
                                              stream);
  if (width == 4) return launch_latch<uint32_t>(r, x, pairs, a, seg_bytes,
                                                stream);
  return launch_latch<uint8_t>(r, x, pairs, a, seg_bytes, stream);
}

}  // extern "C"
