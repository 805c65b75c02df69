// The sp-partitioned windowed reduction of a (kf, wf, sp) device mesh, for
// sm_90a: one shard's clipped window partials, and the merge of the
// partials over the sp axis.
//
// Replaces the body of the shard_map in the JAX package's
// windflow_tpu/parallel/mesh.py:141 (MeshWindowedReduce._build.local) and
// its sp collectives: psum / pmin / pmax and the all_gather fold of prod
// (:167-186), and the ring of n_sp - 1 ppermute hops (:129-139).
//
// wf_sp_window_partial.  For window w < B of one shard whose row slice
// `vals` holds rows [base, base + Ns) of its group (values after the
// user's map_fn, in the reduction's dtype), with keep == null or a (Ns,)
// byte mask (the user's filter_fn):
//     lo = clip(starts[w] - base, 0, Ns), hi = clip(starts[w] + lens[w] -
//     base, 0, Ns)
//     cnt[w]  = #{c in [lo, hi) : keep[c]}
//     part[w] = op-reduce of vals[c], c in [lo, hi) with keep[c]
// (the identity for an empty window; count writes cnt converted to the
// dtype; mean writes the sum).  The clip keeps every load inside the
// slice, as jnp.minimum(lo + iota, Ns - 1) does in JAX: no lane reads past
// hi.  cnt == null skips the counts (ops other than count and mean).
//
// wf_sp_merge.  parts is (n, B), shard-major (n = n_sp partials of every
// window), cnts (n, B) int32 or null; for window w it folds the n values
// in a fixed order: shards 0, 1, ..., n - 1 (psum, pmin, pmax, prod's
// gather fold), or with ring = 1 shards 0, n - 1, n - 2, ..., 1 (the
// order in which sp shard 0 accumulates its ppermute hops, the shard whose
// value JAX returns).  mean writes float32 sum / max(count, 1), the
// integer sum converted to float32 first (JAX's true division of int32).
//
// Semantics kept identical to the reference: int32 sums and products wrap
// modulo 2^32 (they run in uint32); float min/max propagate NaN as jnp.min
// and jnp.max do; the identity comes from the caller as its 32-bit
// pattern (ops/monoid.py:identity).
//
// Order.  One warp reduces one window: lane l combines the cells lo + l,
// lo + l + 32, ... below hi in ascending order from the identity, kept
// cells only, then the warp's lanes combine by a butterfly of
// __shfl_xor_sync over 16, 8, 4, 2, 1 (own value first); lane 0 writes.
// The loads of a lane are issued kUnroll at a time but combined in this
// order, so two launches agree bit for bit and a CPU twin
// (ops/mesh_reduce.py: partial_order_twin, merge_order_twin) reproduces
// both entries.
//
// Design.  The partial reads each cell of a window with a coalesced
// 4-byte load (the 32 lanes of a warp read 128 consecutive bytes) and its
// keep byte beside it; a block is 8 warps, 8 windows.  Windows of one
// shard overlap (sliding windows), so their shared cells come again from
// L1 and L2; the bound counts each covered cell once.  (Tried on the
// H100 at pipe_test's windows and not kept: a block that first stages its
// windows' span in shared memory, reading each cell once, was slower; 8
// or 16 loads in flight a lane instead of 4 gained nothing.)  The merge
// is one thread a window, reading the n partials (and counts) of its
// window.
// Bound on an H100 SXM (3.35 TB/s), by bytes: the cells the windows cover
// (4 bytes + 1 keep byte each) read once, the descriptors (8 B a window)
// and the outputs written once; the merge reads n * B partials (and
// counts) and writes B values.  One 32-bit combine per cell is far below
// the card's peak operation rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { OP_SUM = 0, OP_COUNT = 1, OP_MIN = 2, OP_MAX = 3, OP_PROD = 4,
          OP_MEAN = 5 };
enum Dtype { DT_INT32 = 0, DT_FLOAT32 = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // windows a block
constexpr int kUnroll = 4;              // loads in flight a lane
constexpr int kMergeThreads = 256;

template <int OP, typename T> struct Work { using type = T; };
template <> struct Work<OP_SUM, int32_t> { using type = uint32_t; };
template <> struct Work<OP_MEAN, int32_t> { using type = uint32_t; };
template <> struct Work<OP_PROD, int32_t> { using type = uint32_t; };

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_nan(int32_t) { return false; }

template <int OP, typename W>
__device__ __forceinline__ W combine(W a, W b) {
  if constexpr (OP == OP_SUM || OP == OP_MEAN) {
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
  static_assert(sizeof(W) == sizeof(uint32_t), "32-bit types only");
  W v;
  memcpy(&v, &bits, sizeof(v));
  return v;
}

template <typename W>
__device__ __forceinline__ uint32_t to_bits(W v) {
  uint32_t bits;
  memcpy(&bits, &v, sizeof(bits));
  return bits;
}

__device__ __forceinline__ long long clip(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// one window by one warp (the order at the top); VALUES false reads only
// the keep mask (count)
template <int OP, typename T, bool VALUES>
__device__ __forceinline__ void partial_window(
    const uint32_t* __restrict__ vals, const uint8_t* __restrict__ keep,
    long long lo, long long hi, uint32_t ident, int lane, uint32_t* part,
    int32_t* cnt) {
  using W = typename Work<OP, T>::type;
  W acc = from_bits<W>(ident);
  int n = 0;
  for (long long c0 = lo + lane; c0 < hi; c0 += 32 * kUnroll) {
    uint32_t v[kUnroll];
    bool k[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long c = c0 + 32 * i;
      k[i] = c < hi;
      if (k[i]) {
        if (keep != nullptr) k[i] = __ldg(keep + c) != 0;
        if constexpr (VALUES) v[i] = __ldg(vals + c);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (k[i]) {
        if constexpr (VALUES) acc = combine<OP, W>(acc, from_bits<W>(v[i]));
        ++n;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if constexpr (VALUES) {
      acc = combine<OP, W>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    n += __shfl_xor_sync(0xffffffffu, n, off);
  }
  if (lane == 0) {
    if constexpr (VALUES) {
      *part = to_bits<W>(acc);
    } else if constexpr (std::is_same<T, float>::value) {
      *part = to_bits<float>((float)n);   // count: the kept rows, as float
    } else {
      *part = (uint32_t)n;
    }
    if (cnt != nullptr) *cnt = n;
  }
}

template <int OP, typename T, bool VALUES>
__global__ void __launch_bounds__(kThreads)
sp_partial_kernel(const uint32_t* __restrict__ vals,
                  const uint8_t* __restrict__ keep, long long Ns,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ lens, int B, long long base,
                  uint32_t ident, uint32_t* __restrict__ part,
                  int32_t* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= B) return;   // a whole warp leaves together
  const long long s = starts[w];
  const long long lo = clip(s - base, Ns);
  const long long hi = clip(s + lens[w] - base, Ns);
  partial_window<OP, T, VALUES>(vals, keep, lo, hi, ident, lane, part + w,
                                cnt != nullptr ? cnt + w : nullptr);
}

template <int OP, typename T>
__global__ void __launch_bounds__(kMergeThreads)
sp_merge_kernel(const uint32_t* __restrict__ parts,
                const int32_t* __restrict__ cnts, int n, int B, int ring,
                uint32_t* __restrict__ out) {
  using W = typename Work<OP, T>::type;
  const long long w = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (w >= B) return;
  W acc = from_bits<W>(__ldg(parts + w));
  int c = cnts != nullptr ? __ldg(cnts + w) : 0;
  for (int k = 1; k < n; ++k) {
    const long long r = ring ? n - k : k;
    acc = combine<OP, W>(acc, from_bits<W>(__ldg(parts + r * B + w)));
    if (cnts != nullptr) c += __ldg(cnts + r * B + w);
  }
  if constexpr (OP == OP_MEAN) {
    // JAX: s / max(c, 1), in float32 for both dtypes
    float s;
    if constexpr (std::is_same<T, float>::value) {
      s = acc;
    } else {
      s = (float)(int32_t)acc;
    }
    out[w] = to_bits<float>(s / (float)(c > 1 ? c : 1));
  } else {
    out[w] = to_bits<W>(acc);
  }
}

template <int OP, typename T>
cudaError_t launch_partial(const void* vals, const void* keep, long long Ns,
                           const void* starts, const void* lens, int B,
                           long long base, uint32_t ident, void* part,
                           void* cnt, cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
  constexpr bool values = OP != OP_COUNT;
  sp_partial_kernel<OP, T, values><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(vals), static_cast<const uint8_t*>(keep),
      Ns, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lens), B, base, ident,
      static_cast<uint32_t*>(part), static_cast<int32_t*>(cnt));
  return cudaGetLastError();
}

template <typename T>
cudaError_t partial_for(int op, const void* vals, const void* keep,
                        long long Ns, const void* starts, const void* lens,
                        int B, long long base, uint32_t ident, void* part,
                        void* cnt, cudaStream_t stream) {
  switch (op) {
    case OP_SUM:
      return launch_partial<OP_SUM, T>(vals, keep, Ns, starts, lens, B, base,
                                       ident, part, cnt, stream);
    case OP_MEAN:
      return launch_partial<OP_MEAN, T>(vals, keep, Ns, starts, lens, B,
                                        base, ident, part, cnt, stream);
    case OP_COUNT:
      return launch_partial<OP_COUNT, T>(vals, keep, Ns, starts, lens, B,
                                         base, ident, part, cnt, stream);
    case OP_MIN:
      return launch_partial<OP_MIN, T>(vals, keep, Ns, starts, lens, B, base,
                                       ident, part, cnt, stream);
    case OP_MAX:
      return launch_partial<OP_MAX, T>(vals, keep, Ns, starts, lens, B, base,
                                       ident, part, cnt, stream);
    default:
      return launch_partial<OP_PROD, T>(vals, keep, Ns, starts, lens, B,
                                        base, ident, part, cnt, stream);
  }
}

template <int OP, typename T>
cudaError_t launch_merge(const void* parts, const void* cnts, int n, int B,
                         int ring, void* out, cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + kMergeThreads - 1) / kMergeThreads);
  sp_merge_kernel<OP, T><<<grid, kMergeThreads, 0, stream>>>(
      static_cast<const uint32_t*>(parts), static_cast<const int32_t*>(cnts),
      n, B, ring, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t merge_for(int op, const void* parts, const void* cnts, int n,
                      int B, int ring, void* out, cudaStream_t stream) {
  switch (op) {
    case OP_SUM:
    case OP_COUNT:   // partial counts add in the dtype
      return launch_merge<OP_SUM, T>(parts, nullptr, n, B, ring, out,
                                     stream);
    case OP_MEAN:
      return launch_merge<OP_MEAN, T>(parts, cnts, n, B, ring, out, stream);
    case OP_MIN:
      return launch_merge<OP_MIN, T>(parts, nullptr, n, B, ring, out,
                                     stream);
    case OP_MAX:
      return launch_merge<OP_MAX, T>(parts, nullptr, n, B, ring, out,
                                     stream);
    default:
      return launch_merge<OP_PROD, T>(parts, nullptr, n, B, ring, out,
                                      stream);
  }
}

bool valid(int op, int dtype) {
  return op >= OP_SUM && op <= OP_MEAN &&
         (dtype == DT_INT32 || dtype == DT_FLOAT32);
}

}  // namespace

// Writes the (B,) partials `part` (32-bit words of the dtype) and, when
// `cnt` is not null, the (B,) int32 kept-row counts of one shard: its
// (Ns,) slice `vals` (int32 or float32 per `dtype`) holds rows [base,
// base + Ns); `keep` is a (Ns,) byte mask or null; the windows are
// (starts, lens) in the group's row coordinates; `ident` is the op's
// identity's bits.  mean (op 5) and count need `cnt` for the merge.  One
// launch on `stream`; returns cudaGetLastError() after it.
extern "C" int wf_sp_window_partial(const void* vals, const void* keep,
                                    long long Ns, const void* starts,
                                    const void* lens, int B, long long base,
                                    int op, int dtype, unsigned int ident,
                                    void* part, void* cnt, void* stream) {
  if (B <= 0 || Ns < 0 || !valid(op, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      dtype == DT_FLOAT32
          ? partial_for<float>(op, vals, keep, Ns, starts, lens, B, base,
                               ident, part, cnt, s)
          : partial_for<int32_t>(op, vals, keep, Ns, starts, lens, B, base,
                                 ident, part, cnt, s);
  return (int)rc;
}

// Folds the (n, B) partials `parts` (and for mean the (n, B) int32 counts
// `cnts`) over their first axis into the (B,) `out`: dtype words, or
// float32 for mean.  ring = 0 folds shards 0, 1, ..., n - 1; ring = 1
// folds 0, n - 1, ..., 1.  One launch on `stream`; returns
// cudaGetLastError() after it.
extern "C" int wf_sp_merge(const void* parts, const void* cnts, int n, int B,
                           int op, int dtype, int ring, void* out,
                           void* stream) {
  if (n <= 0 || B <= 0 || !valid(op, dtype) ||
      (op == OP_MEAN && cnts == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      dtype == DT_FLOAT32
          ? merge_for<float>(op, parts, cnts, n, B, ring, out, s)
          : merge_for<int32_t>(op, parts, cnts, n, B, ring, out, s);
  return (int)rc;
}
