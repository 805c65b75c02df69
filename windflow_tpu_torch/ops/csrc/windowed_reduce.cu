// Windowed monoid reduction over a flat staged buffer, for sm_90a.
//
// Replaces the Pallas TPU kernel windflow_tpu/ops/pallas_kernels.py:
// windowed_reduce_pallas (body _kernel).  Window i is
// flat[starts[i] : starts[i] + min(lens[i], pad)], reduced with one monoid:
// sum, count, min, max or prod, over int32 or float32 values.
//
// Design: one warp per window, 8 warps per 256-thread block (the Pallas
// kernel's group of 8 windows per grid step).  Each lane strides over the
// window by 32, so a warp's loads are coalesced; a __shfl_xor_sync tree
// finishes the reduction.  The grid is ceil(B / 8) blocks and a warp whose
// window index is past B returns, so B needs no padding.  The flat buffer
// is read straight from device memory: consecutive sliding windows overlap,
// and the overlap is served from L2 rather than re-staged.
//
// Bound on an H100 SXM (3.35 TB/s): the function must read the flat buffer
// once, starts and lens once, and write the output once:
//   bytes = 4*N + 8*B + 4*B, time >= bytes / 3.35e12 s.
// The operations (one combine per element) are far below the card's peak
// rate, so the kernel is bound by bytes.
//
// Semantics kept identical to the reference (XLA on the TPU):
//  * int32 sum and prod wrap modulo 2^32: they run in uint32, because signed
//    overflow is undefined behaviour in C++;
//  * float min and max propagate NaN, as jnp.min / jnp.max do (fminf and
//    fmaxf would drop it);
//  * the identity (0, 1 or the dtype extremes) is passed in by the caller as
//    its 32-bit pattern, from ops/monoid.py:identity; a window of length 0
//    yields it;
//  * count writes the window length converted to the value dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { OP_SUM = 0, OP_COUNT = 1, OP_MIN = 2, OP_MAX = 3, OP_PROD = 4 };
enum Dtype { DT_INT32 = 0, DT_FLOAT32 = 1 };

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

// working type: int32 sum/prod wrap in uint32, everything else in T itself
template <int OP, typename T> struct Work { using type = T; };
template <> struct Work<OP_SUM, int32_t> { using type = uint32_t; };
template <> struct Work<OP_PROD, int32_t> { using type = uint32_t; };

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_nan(int32_t) { return false; }

template <int OP, typename W>
__device__ __forceinline__ W combine(W a, W b) {
  if constexpr (OP == OP_SUM) {
    return a + b;
  } else if constexpr (OP == OP_PROD) {
    return a * b;
  } else if constexpr (OP == OP_MIN) {
    return (is_nan(a) || a < b) ? a : b;
  } else {
    return (is_nan(a) || a > b) ? a : b;
  }
}

template <typename W>
__device__ __forceinline__ W from_bits(uint32_t bits) {
  W v;
  static_assert(sizeof(W) == sizeof(uint32_t), "32-bit types only");
  memcpy(&v, &bits, sizeof(v));
  return v;
}

template <int OP, typename T>
__global__ void __launch_bounds__(kThreads)
windowed_reduce_kernel(const T* __restrict__ flat,
                       const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ lens,
                       T* __restrict__ out, int B, int pad,
                       uint32_t ident_bits) {
  using W = typename Work<OP, T>::type;
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= B) return;  // uniform across the warp
  const int len = min(lens[w], pad);
  if constexpr (OP == OP_COUNT) {
    if (lane == 0) out[w] = (T)lens[w];
    return;
  } else {
    const T* p = flat + starts[w];
    W acc = from_bits<W>(ident_bits);
    for (int j = lane; j < len; j += 32) {
      acc = combine<OP, W>(acc, (W)__ldg(p + j));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = combine<OP, W>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) out[w] = (T)acc;
  }
}

template <typename T>
int launch_typed(const void* flat, const int32_t* starts, const int32_t* lens,
                 void* out, int B, int pad, int op, uint32_t ident_bits,
                 cudaStream_t stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* f = static_cast<const T*>(flat);
  T* o = static_cast<T*>(out);
  switch (op) {
    case OP_SUM:
      windowed_reduce_kernel<OP_SUM, T><<<grid, kThreads, 0, stream>>>(
          f, starts, lens, o, B, pad, ident_bits);
      break;
    case OP_COUNT:
      windowed_reduce_kernel<OP_COUNT, T><<<grid, kThreads, 0, stream>>>(
          f, starts, lens, o, B, pad, ident_bits);
      break;
    case OP_MIN:
      windowed_reduce_kernel<OP_MIN, T><<<grid, kThreads, 0, stream>>>(
          f, starts, lens, o, B, pad, ident_bits);
      break;
    case OP_MAX:
      windowed_reduce_kernel<OP_MAX, T><<<grid, kThreads, 0, stream>>>(
          f, starts, lens, o, B, pad, ident_bits);
      break;
    case OP_PROD:
      windowed_reduce_kernel<OP_PROD, T><<<grid, kThreads, 0, stream>>>(
          f, starts, lens, o, B, pad, ident_bits);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one windowed reduction on `stream`; returns cudaGetLastError()
// after the launch (0 on success).  B must be > 0.
extern "C" int wf_windowed_reduce(const void* flat, const void* starts,
                                  const void* lens, void* out, int B, int pad,
                                  int op, int dtype, unsigned int ident_bits,
                                  void* stream) {
  const int32_t* s = static_cast<const int32_t*>(starts);
  const int32_t* l = static_cast<const int32_t*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DT_INT32:
      return launch_typed<int32_t>(flat, s, l, out, B, pad, op, ident_bits,
                                   st);
    case DT_FLOAT32:
      return launch_typed<float>(flat, s, l, out, B, pad, op, ident_bits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
