// Kernels of the device-resident ring archive, for sm_90a.
//
// Replace the XLA-jitted device bodies of windflow_tpu/ops/resident.py:
//  * ring_append: the vmapped dynamic_update_slice + astype of
//    _regular_body (resident.py:188-191) and _ring_append (:234-240);
//  * regular_window_sum: the ring-wide cumsum + two-point gather of
//    _regular_body (:192-198), computed here as direct window sums.
// The irregular evaluation (_ring_eval) runs through the windowed_reduce
// kernel on the ring's flat view (ops/resident.py).
//
// ring_append.  For every row r < KP and column j < Rb:
//     ring[r, offs[r] + j] = (Acc) blk[r, j]
// over the whole padded rectangle, zero rows and columns included, so the
// ring holds what the JAX ring holds cell for cell.  The update is in
// place (JAX produced a new array).  The host guards offs + Rb <= cap
// (_check_ring_overflow); the kernel also drops any write outside
// [0, cap), so it never writes past its row.  One thread per cell, 256
// columns of one row per block: the reads of blk and the writes to the
// ring are coalesced.
// Bound on an H100 SXM (3.35 TB/s), by bytes: read KP*Rb*sizeof(Wire) and
// KP*4 offsets, write KP*Rb*sizeof(Acc).
//
// regular_window_sum.  For r < KP and i < C:
//     s = clip(rstart0[r] + i*slide, 0, cap), e = clip(s + rlen[r], 0, cap)
//     out[r, i] = sum(ring[r, s:e])        (rlen >= 0)
// One warp per window, 8 windows per 256-thread block; lanes stride the
// window by 32 (coalesced) and a shuffle tree finishes.  The JAX body
// takes a cumsum over the whole ring, reading and writing all KP*cap cells
// every launch; the windows touch only their own cells (at most
// KP*((C-1)*slide + rlen)), and overlapping windows re-read from L2.
// Bound, by bytes: the ring cells the windows cover, read once, the
// descriptors, and the (KP, C) output written once.
// int32 sums run in uint32 and wrap modulo 2^32: that is bit for bit the
// cumsum difference XLA computes.  float32 sums round differently from a
// cumsum difference; the tests hold them to a stated tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Wire { W_INT8 = 0, W_INT16 = 1, W_INT32 = 2, W_FLOAT32 = 3 };
enum Acc { A_INT32 = 0, A_FLOAT32 = 1 };

constexpr int kAppendThreads = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kSumThreads = 32 * kWarpsPerBlock;
constexpr int kMaxGridY = 65535;

template <typename A, typename W>
__device__ __forceinline__ A widen(W v) {
  return (A)v;
}

// float wire into an int32 ring: truncate toward zero (saturating, NaN to
// 0) rather than rely on a C++ cast that is undefined out of range
template <>
__device__ __forceinline__ int32_t widen<int32_t, float>(float v) {
  return __float2int_rz(v);
}

template <typename W, typename A>
__global__ void __launch_bounds__(kAppendThreads)
ring_append_kernel(A* __restrict__ ring, const W* __restrict__ blk,
                   const int32_t* __restrict__ offs, int KP, long long cap,
                   int Rb) {
  const int j = blockIdx.x * kAppendThreads + threadIdx.x;
  if (j >= Rb) return;
  for (int r = blockIdx.y; r < KP; r += gridDim.y) {
    const long long c = (long long)offs[r] + j;
    if (c >= 0 && c < cap) {
      ring[(long long)r * cap + c] = widen<A, W>(blk[(long long)r * Rb + j]);
    }
  }
}

// working type of the window sum: int32 wraps in uint32 (signed overflow
// is undefined behaviour in C++), float32 sums in float32
template <typename A> struct SumWork { using type = A; };
template <> struct SumWork<int32_t> { using type = uint32_t; };

template <typename A>
__global__ void __launch_bounds__(kSumThreads)
regular_window_sum_kernel(const A* __restrict__ ring,
                          const int32_t* __restrict__ rstart0,
                          const int32_t* __restrict__ rlen,
                          A* __restrict__ out, int KP, long long cap, int C,
                          int slide) {
  using T = typename SumWork<A>::type;
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)KP * C) return;  // uniform across the warp
  const int r = (int)(w / C);
  const int i = (int)(w % C);
  long long s = (long long)rstart0[r] + (long long)i * slide;
  s = s < 0 ? 0 : (s > cap ? cap : s);
  long long e = s + rlen[r];
  e = e < 0 ? 0 : (e > cap ? cap : e);
  const A* row = ring + (long long)r * cap;
  T acc = 0;
  for (long long j = s + lane; j < e; j += 32) {
    acc += (T)__ldg(row + j);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[w] = (A)acc;
}

template <typename W, typename A>
int launch_append(void* ring, const void* blk, const int32_t* offs, int KP,
                  long long cap, int Rb, cudaStream_t st) {
  const dim3 grid((Rb + kAppendThreads - 1) / kAppendThreads,
                  KP < kMaxGridY ? KP : kMaxGridY);
  ring_append_kernel<W, A><<<grid, kAppendThreads, 0, st>>>(
      static_cast<A*>(ring), static_cast<const W*>(blk), offs, KP, cap, Rb);
  return (int)cudaGetLastError();
}

template <typename A>
int launch_append_wire(void* ring, const void* blk, const int32_t* offs,
                       int KP, long long cap, int Rb, int wire,
                       cudaStream_t st) {
  switch (wire) {
    case W_INT8:
      return launch_append<int8_t, A>(ring, blk, offs, KP, cap, Rb, st);
    case W_INT16:
      return launch_append<int16_t, A>(ring, blk, offs, KP, cap, Rb, st);
    case W_INT32:
      return launch_append<int32_t, A>(ring, blk, offs, KP, cap, Rb, st);
    case W_FLOAT32:
      return launch_append<float, A>(ring, blk, offs, KP, cap, Rb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename A>
int launch_sum(const void* ring, const int32_t* rstart0, const int32_t* rlen,
               void* out, int KP, long long cap, int C, int slide,
               cudaStream_t st) {
  const long long windows = (long long)KP * C;
  const dim3 grid((unsigned)((windows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  regular_window_sum_kernel<A><<<grid, kSumThreads, 0, st>>>(
      static_cast<const A*>(ring), rstart0, rlen, static_cast<A*>(out), KP,
      cap, C, slide);
  return (int)cudaGetLastError();
}

}  // namespace

// Appends the (KP, Rb) rectangle `blk` (wire dtype) into the (KP, cap) ring
// (acc dtype) at per-row offsets `offs` (int32), on `stream`.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int wf_ring_append(void* ring, const void* blk, const void* offs,
                              int KP, long long cap, int Rb, int wire,
                              int acc, void* stream) {
  if (KP <= 0 || Rb <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* o = static_cast<const int32_t*>(offs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (acc) {
    case A_INT32:
      return launch_append_wire<int32_t>(ring, blk, o, KP, cap, Rb, wire, st);
    case A_FLOAT32:
      return launch_append_wire<float>(ring, blk, o, KP, cap, Rb, wire, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Writes the (KP, C) regular window sums of the (KP, cap) ring into `out`
// (acc dtype), window i of row r starting at rstart0[r] + i*slide with
// length rlen[r] (both int32), on `stream`.  Returns cudaGetLastError().
extern "C" int wf_regular_window_sum(const void* ring, const void* rstart0,
                                     const void* rlen, void* out, int KP,
                                     long long cap, int C, int slide, int acc,
                                     void* stream) {
  if (KP <= 0 || C <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* s0 = static_cast<const int32_t*>(rstart0);
  const int32_t* ln = static_cast<const int32_t*>(rlen);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (acc) {
    case A_INT32:
      return launch_sum<int32_t>(ring, s0, ln, out, KP, cap, C, slide, st);
    case A_FLOAT32:
      return launch_sum<float>(ring, s0, ln, out, KP, cap, C, slide, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
