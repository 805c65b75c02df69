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
// user's map_fn, in the reduction's dtype: int32, float32, uint32, int64,
// uint64, float64 or float16; a 1- or 2-byte integer dtype comes widened
// to int32 or uint32 by the wrapper, a copy, with that dtype's identity),
// with keep == null or a (Ns,) byte mask (the user's filter_fn):
//     lo = clip(starts[w] - base, 0, Ns), hi = clip(starts[w] + lens[w] -
//     base, 0, Ns)
//     cnt[w]  = #{c in [lo, hi) : keep[c]}
//     part[w] = op-reduce of vals[c], c in [lo, hi) with keep[c]
// (the identity for an empty window; count writes cnt converted to the
// dtype; mean writes the sum).  No load leaves [lo, hi): the clip keeps
// every window inside the slice, as jnp.minimum(lo + iota, Ns - 1) does
// in JAX.  cnt == null skips the counts (ops other than count and mean).
//
// wf_sp_merge.  For window w < B it folds the n partials (and for mean the
// n int32 counts) of the window, each read in place through its own
// pointer, in the order the pointers come: the caller passes shards 0, 1,
// ..., n - 1 (psum, pmin, pmax, prod's gather fold) or 0, n - 1, n - 2,
// ..., 1 (the order in which sp shard 0 accumulates its ppermute hops, the
// shard whose value JAX returns).  mean writes sum / max(count, 1) in
// float32 for a 4-byte dtype and in float64 for an 8-byte one, the integer
// sum converted to that float first (JAX's true division of an integer
// dtype; float64 under x64).  For a 1- or 2-byte integer dtype the
// partials are int32 or uint32 (JAX's sums and products of them; its min,
// max and count the wrapper widens) and mean divides the float32 sum by
// max(count, 1) wrapped into that dtype (JAX's
// jnp.maximum(c, 1).astype(dtype): 0 past 255 for uint8, so inf or nan).
// float16 partials are combined in float and, where JAX's collective
// works on float16 values (psum and the ring's hops: sum, count, mean,
// and prod on the ring), rounded to float16 after every combine (`step`);
// prod's gather fold rounds once.  A float16 mean is a float16 quotient,
// the sum over max(count, 1) rounded to float16.
//
// Semantics kept identical to the reference: integer sums and products
// wrap modulo 2^32 or 2^64 (they run in the unsigned type of their width;
// float16 in float, rounded to float16 once a partial);
// uint32 and uint64 compare unsigned; float min/max propagate NaN as
// jnp.min and jnp.max do; the identity comes from the caller as its 64-bit
// pattern (ops/monoid.py:identity).  The dtypes' storage and work types
// are cells.cuh's.
//
// Order of the partial.  With a = lo mod 4, cell j of a window (0 <= j <
// n = hi - lo) lies in its 4-cell group g = (a + j) / 4, groups counted
// from the window's first aligned group lo - a (aligned in the slice).
//  * A window of n <= split cells is reduced by a team of kLanes = 8 lanes
//    (a warp takes 4 windows): lane g mod 8 takes group g and combines its
//    kept cells in ascending j, starting from the identity; then the
//    team's lanes combine by a butterfly of __shfl_xor_sync over 4, 2, 1,
//    each lane its own value first.
//  * A longer window is cut into chunks of `chunk` groups, chunk c holding
//    groups [c * chunk, (c + 1) * chunk); each chunk is reduced in the
//    order above (lane g mod 8 takes group g), and the chunk partials are
//    folded in chunk order, c = 0, 1, ..., starting from the identity.
// Vector and cell-by-cell loads combine in exactly this order, so two
// launches agree bit for bit and a CPU twin (ops/mesh_reduce.py:
// partial_order_twin, merge_order_twin) reproduces both entries.
//
// Design of the partial.  One launch: its first n_long blocks take one
// long window each, from the caller's list of the windows longer than
// `split` (the host knows the windows: ops/mesh_reduce.py:
// find_long_windows); the other blocks take kShortWindows = 32
// consecutive windows each (their descriptors read once, one a thread,
// into shared memory), kPasses = 1 a team, and skip the long ones.  A
// lane loads a whole group as one 16-byte value load (two for 8-byte
// cells: 4-cell groups at every width) and its 4 keep bytes
// as one word (the bool mask's bytes line up with the cells), kUnroll
// groups before its first combine, and computes its addresses once a
// group; a group that is cut by the window's ends, or a buffer that is
// not aligned, takes cell-by-cell loads of the window's cells only.  A
// long window's block: its 32 teams take chunks 32r + t in round r; each
// team's lane 0 writes its chunk partial to shared memory (two buffers,
// one __syncthreads a round), and thread 0 folds the round's partials in
// chunk order while the teams load the next round.  The launch bounds ask
// for kMinBlocks = 6 resident blocks an SM (at most 42 registers a
// thread; a few bytes spill), 4 for 8-byte values (kMinBlocks8).
// Measured on an H100 (scripts/torch_mesh_kernels.py, PERF.md): the
// block path wins from 2,048 cells at 1,032 windows and from 4,096 at
// 2^24 window cells, so
// the wrapper's split is 2,048; chunks of 512 cells; 8 groups in flight,
// 8 blocks an SM, 2, 4 or 8 windows a team (fewer blocks: slower where B
// is small), or a team's windows consecutive (so that the windows in
// flight together overlap less) were no faster.  The mesh step's CB
// windows (256 cells, slide 64) read each cell about four times through
// L2, where the bound counts it once.  (The first version,
// one warp a window with a 4-byte load and a keep byte a lane a cell, ran
// at 5.4x its bound on those windows, and a window of 37k cells kept one
// warp busy for the whole launch.)
// Bound on an H100 SXM (3.35 TB/s), by bytes: the cells the windows cover
// (4 or 8 bytes + 1 keep byte each) read once, the descriptors (8 B a
// window) and the outputs written once; one combine per window cell sets
// the bound by operations where windows overlap many times.
//
// Design of the merge.  A thread takes kMergeWindows = 4 consecutive
// windows: one 16-byte load a partial (two for 8-byte partials) and a
// count, all of them (up to NB = 2, 4, 8 or 16, the instantiation the
// shard count picks; at most 8 for 8-byte partials) issued before its
// first combine; a thread at the ragged end of B, or any pointer that is
// not 16-byte aligned, loads cell by cell.  The pointers of up to kInline
// = 16 shards (8 for 8-byte partials) travel in the kernel's parameters;
// more come from a device array the caller fills.  No partial is copied: an
// (n, B) tensor's rows or n separate tensors are read where they lie.
// Bound by bytes: n * B partials (and counts) read, B values written.
// int32 and float32 keep their measured instantiations; each new dtype
// is an instantiation of its own (float16: Cells<2>, 8-byte groups; the
// 1- and 2-byte integers the int32 and uint32 ones, and for mean an
// instantiation a divisor type).

#include "cells.cuh"

namespace {

using namespace wf;

constexpr int kThreads = 256;
constexpr int kGroup = 4;                    // cells of a group
constexpr int kLanes = 8;                    // lanes that reduce a window
constexpr int kTeams = kThreads / kLanes;    // windows (chunks) a block
constexpr int kUnroll = 4;                   // groups in flight a lane
constexpr int kPasses = 1;                   // windows a team takes
constexpr int kShortWindows = kTeams * kPasses;  // a short block's windows
static_assert(kShortWindows <= kThreads, "one descriptor a thread");
constexpr int kMinBlocks = 6;                // resident partial blocks an SM
// 8-byte values: 4 (64 registers a thread; at 6 the 8-byte partials
// spilled 536-864 bytes a thread, -Xptxas -v on the H100's toolkit)
constexpr int kMinBlocks8 = 4;
constexpr int kMergeThreads = 256;
constexpr int kMergeWindows = 4;             // windows a merge thread
constexpr int kInline = 16;                  // merge pointers by value

// merge codes of the 1- and 2-byte integer dtypes (ops/mesh_reduce.py
// _NARROW_CODES): their partials are held in int32 or uint32
enum NarrowDtype { DT_INT8 = 7, DT_INT16 = 8, DT_UINT8 = 9, DT_UINT16 = 10 };

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

// merge pointers by value for values of T (8-byte partials: 8, so that
// the shards in flight stay in registers)
template <typename T> constexpr int inline_of() {
  return sizeof(T) == 8 ? 8 : kInline;
}

__device__ __forceinline__ long long clip(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// ------------------------------------------------------------------ partial

struct Partial {
  const void* vals;
  const uint8_t* keep;        // null: every row kept
  long long Ns, base;
  const int32_t* starts;
  const int32_t* lens;
  const int32_t* long_windows;  // the windows of the first n_long blocks
  void* part;
  int32_t* cnt;               // null: no counts
  int B, n_long, split, chunk;  // chunk in groups, a multiple of kLanes
  unsigned long long ident;
  bool vec;                   // vals 16-byte and keep 4-byte aligned
};

// one window's cells: `vals` and `keep` point at its first aligned group
template <typename T>
struct Window {
  const WordOf<T>* vals;
  const uint8_t* keep;
  int a, n;                   // lo mod 4; hi - lo
  __device__ __forceinline__ int groups() const {
    return (int)(((long long)a + n + kGroup - 1) / kGroup);
  }
};

// window w clipped to the slice: its first cell lo and its length n
__device__ __forceinline__ void clipped(const Partial& p, long long w,
                                        long long& lo, int& n) {
  const long long s = p.starts[w];
  lo = clip(s - p.base, p.Ns);
  const long long hi = clip(s + p.lens[w] - p.base, p.Ns);
  n = (int)(hi > lo ? hi - lo : 0);
}

template <typename T>
__device__ __forceinline__ Window<T> window_at(const Partial& p,
                                               long long lo, int n) {
  const int a = (int)(lo & 3);
  const long long g0 = lo - a;
  return Window<T>{static_cast<const WordOf<T>*>(p.vals) + g0,
                   p.keep != nullptr ? p.keep + g0 : nullptr, a, n};
}

// Group g of a window: its 4 values into v and its liveness into k, one
// byte a cell (1: a kept cell of the window, 0: not).  A whole group
// inside the window takes one vector load (and one 4-byte keep word);
// a cut group loads only the window's own cells.
template <typename T, bool VALUES>
__device__ __forceinline__ void load_group(const Window<T>& c, bool vec,
                                           int g,
                                           typename CellsOf<T>::Group& v,
                                           uint32_t& k) {
  using C = CellsOf<T>;
  const long long c0 = (long long)kGroup * g;   // cell of the aligned group
  const long long j0 = c0 - c.a;                // its window cell
  if (vec && j0 >= 0 && j0 + kGroup <= c.n) {
    if constexpr (VALUES) {
      v = C::load(reinterpret_cast<const typename C::Group*>(c.vals) + g);
    }
    k = c.keep != nullptr
            ? __vcmpne4(__ldg(reinterpret_cast<const uint32_t*>(c.keep) + g),
                        0u) & 0x01010101u
            : 0x01010101u;
    return;
  }
  typename C::Word x[kGroup] = {0u, 0u, 0u, 0u};
  k = 0u;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const long long j = j0 + i;
    if (j >= 0 && j < c.n) {
      if constexpr (VALUES) x[i] = __ldg(c.vals + c0 + i);
      if (c.keep == nullptr || __ldg(c.keep + c0 + i) != 0) {
        k |= 1u << (8 * i);
      }
    }
  }
  v = C::make(x);
}

// Lane q's part of groups [gb, ge) (gb a multiple of kLanes): the groups
// g = q (mod kLanes), ascending, their live cells combined into acc and
// counted into cnt.
template <int OP, typename T, typename W, bool VALUES>
__device__ __forceinline__ void fold_groups(const Window<T>& c, bool vec,
                                            int gb, int ge, int q, W& acc,
                                            int& cnt) {
  using C = CellsOf<T>;
  for (int g1 = gb + q; g1 < ge; g1 += kLanes * kUnroll) {
    typename C::Group v[kUnroll];
    uint32_t k[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int g = g1 + kLanes * i;
      k[i] = 0u;
      if (g < ge) load_group<T, VALUES>(c, vec, g, v[i], k[i]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      cnt += __popc(k[i]);
      if constexpr (VALUES) {
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          if (k[i] & (0xffu << (8 * e))) {
            acc = combine<OP, W>(acc, value<T, W>(C::at(v[i], e)));
          }
        }
      }
    }
  }
}

// the butterfly over a team's 8 lanes (every lane of the warp calls it)
template <int OP, typename W, bool VALUES>
__device__ __forceinline__ void team_reduce(W& acc, int& cnt) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    if constexpr (VALUES) {
      acc = combine<OP, W>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
}

template <typename T, typename W, bool VALUES>
__device__ __forceinline__ void write_window(const Partial& p, long long w,
                                             W acc, int cnt) {
  WordOf<T>* part = static_cast<WordOf<T>*>(p.part);
  if constexpr (VALUES) {
    part[w] = stored<T, W>(acc);
  } else {
    part[w] = count_as<T>(cnt);   // count: the kept rows, in the dtype
  }
  if (p.cnt != nullptr) p.cnt[w] = cnt;
}

// a block of kShortWindows windows, kPasses a team; the long ones are
// skipped.  The block's descriptors are read once, one a thread.
template <int OP, typename T, bool VALUES>
__device__ __forceinline__ void short_windows(const Partial& p,
                                              long long blk) {
  using W = typename Work<OP, T>::type;
  __shared__ long long s_lo[kShortWindows];
  __shared__ int s_n[kShortWindows];
  const long long w0 = blk * kShortWindows;
  if (threadIdx.x < kShortWindows && w0 + threadIdx.x < p.B) {
    clipped(p, w0 + threadIdx.x, s_lo[threadIdx.x], s_n[threadIdx.x]);
  }
  __syncthreads();
  const int team = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  for (int i = 0; i < kPasses; ++i) {
    const int k = i * kTeams + team;
    W acc = ident_of<W>(p.ident);
    int cnt = 0;
    const bool mine = w0 + k < p.B && s_n[k] <= p.split;
    if (mine) {
      const Window<T> c = window_at<T>(p, s_lo[k], s_n[k]);
      fold_groups<OP, T, W, VALUES>(c, p.vec, 0, c.groups(), q, acc, cnt);
    }
    team_reduce<OP, W, VALUES>(acc, cnt);
    if (mine && q == 0) write_window<T, W, VALUES>(p, w0 + k, acc, cnt);
  }
}

// one long window by the whole block, chunk by chunk
template <int OP, typename T, bool VALUES>
__device__ __forceinline__ void long_window(const Partial& p, long long w) {
  using W = typename Work<OP, T>::type;
  __shared__ W s_part[2][kTeams];
  __shared__ int s_cnt[2][kTeams];
  if (w < 0 || w >= p.B) return;              // the whole block leaves
  long long lo;
  int n;
  clipped(p, w, lo, n);
  if (n <= p.split) return;                   // the short path's window
  const Window<T> c = window_at<T>(p, lo, n);
  const int team = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int G = c.groups();
  const int chunks = (G + p.chunk - 1) / p.chunk;
  W total = ident_of<W>(p.ident);
  int total_cnt = 0;
  for (int r = 0; r * kTeams < chunks; ++r) {
    const int ch = r * kTeams + team;
    W acc = ident_of<W>(p.ident);
    int cnt = 0;
    if (ch < chunks) {
      const int gb = ch * p.chunk;
      fold_groups<OP, T, W, VALUES>(c, p.vec, gb, min(gb + p.chunk, G), q,
                                    acc, cnt);
    }
    team_reduce<OP, W, VALUES>(acc, cnt);
    const int buf = r & 1;
    if (q == 0) {
      s_part[buf][team] = acc;
      s_cnt[buf][team] = cnt;
    }
    // one barrier a round: the buffer written next round was folded
    // before thread 0 reached this one
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(kTeams, chunks - r * kTeams);
      for (int t = 0; t < m; ++t) {
        if constexpr (VALUES) {
          total = combine<OP, W>(total, s_part[buf][t]);
        }
        total_cnt += s_cnt[buf][t];
      }
    }
  }
  if (threadIdx.x == 0) write_window<T, W, VALUES>(p, w, total, total_cnt);
}

template <int OP, typename T, bool VALUES>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 8 ? kMinBlocks8 : kMinBlocks)
sp_partial_kernel(const __grid_constant__ Partial p) {
  if (blockIdx.x < (unsigned)p.n_long) {
    long_window<OP, T, VALUES>(p, p.long_windows[blockIdx.x]);
  } else {
    short_windows<OP, T, VALUES>(p, (long long)blockIdx.x - p.n_long);
  }
}

template <int OP, typename T>
cudaError_t launch_partial(const Partial& p, cudaStream_t stream) {
  const long long grid =
      p.n_long + ((long long)p.B + kShortWindows - 1) / kShortWindows;
  constexpr bool values = OP != OP_COUNT;
  sp_partial_kernel<OP, T, values><<<(unsigned)grid, kThreads, 0, stream>>>(
      p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t partial_for(int op, const Partial& p, cudaStream_t stream) {
  switch (op) {
    case OP_SUM: return launch_partial<OP_SUM, T>(p, stream);
    case OP_MEAN: return launch_partial<OP_MEAN, T>(p, stream);
    case OP_COUNT: return launch_partial<OP_COUNT, T>(p, stream);
    case OP_MIN: return launch_partial<OP_MIN, T>(p, stream);
    case OP_MAX: return launch_partial<OP_MAX, T>(p, stream);
    default: return launch_partial<OP_PROD, T>(p, stream);
  }
}

// -------------------------------------------------------------------- merge

struct Shards {
  const void* part[kInline];       // in fold order
  const int32_t* cnt[kInline];     // mean only
  const uint64_t* far;             // n > inline_of<T>(): 2n device pointers
  void* out;
  int n, B;
  bool vec;                        // every pointer 16-byte aligned
  bool step;                       // float16: round after every combine
};

template <typename P, typename Q>
__device__ __forceinline__ const P* shard_ptr(const Shards& s,
                                              const Q* const* inl, int k,
                                              int i, int half) {
  return s.far != nullptr
             ? reinterpret_cast<const P*>(s.far[half * s.n + k + i])
             : reinterpret_cast<const P*>(inl[i]);
}

// the kMergeWindows cells of one shard from w0 (cell by cell when cut)
template <typename C>
__device__ __forceinline__ typename C::Group load4(
    const typename C::Word* ptr, long long w0, int B, bool full) {
  if (full) return C::load(reinterpret_cast<const typename C::Group*>(
      ptr + w0));
  typename C::Word x[kMergeWindows] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kMergeWindows; ++j) {
    if (w0 + j < B) x[j] = __ldg(ptr + w0 + j);
  }
  return C::make(x);
}

// D: the type mean's max(count, 1) is converted to before the division
// (int: none; a 1- or 2-byte integer: JAX's astype into the dtype)
template <int OP, typename T, int NB, typename D = int>
__global__ void __launch_bounds__(kMergeThreads)
sp_merge_kernel(const __grid_constant__ Shards s) {
  using W = typename Work<OP, T>::type;
  using C = CellsOf<T>;
  using Word = typename C::Word;
  using C4 = Cells<4>;
  // mean's float: float32 for a 4-byte dtype, float64 for an 8-byte one
  using Out = typename std::conditional<sizeof(T) == 8, double, float>::type;
  constexpr bool kMean = OP == OP_MEAN;
  const long long w0 =
      ((long long)blockIdx.x * kMergeThreads + threadIdx.x) * kMergeWindows;
  if (w0 >= s.B) return;
  const bool full = s.vec && w0 + kMergeWindows <= s.B;
  W acc[kMergeWindows];
  int c[kMergeWindows] = {0, 0, 0, 0};
  for (int k = 0; k < s.n; k += NB) {
    typename C::Group v[NB];
    uint4 cv[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {   // every load before the first combine
      if (k + i < s.n) {
        v[i] = load4<C>(shard_ptr<Word>(s, s.part, k, i, 0), w0, s.B, full);
        if constexpr (kMean) {
          cv[i] = load4<C4>(shard_ptr<uint32_t>(s, s.cnt, k, i, 1), w0, s.B,
                            full);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (k + i < s.n) {
#pragma unroll
        for (int j = 0; j < kMergeWindows; ++j) {
          const W x = value<T, W>(C::at(v[i], j));
          acc[j] = k + i == 0 ? x : combine<OP, W>(acc[j], x);
          if constexpr (kHalf<T>) {
            if (s.step) acc[j] = __half2float(__float2half_rn(acc[j]));
          }
          if constexpr (kMean) c[j] += (int32_t)C4::at(cv[i], j);
        }
      }
    }
  }
  Word o[kMergeWindows];
#pragma unroll
  for (int j = 0; j < kMergeWindows; ++j) {
    if constexpr (kMean && kHalf<T>) {
      // JAX: s / max(c, 1).astype(float16), a float16 quotient
      const float den = __half2float(__float2half_rn(
          (float)(c[j] > 1 ? c[j] : 1)));
      o[j] = stored<T, W>(acc[j] / den);
    } else if constexpr (kMean) {
      // JAX: s / max(c, 1), the sum converted to the float first
      const Out sum = (Out)bit_cast<T>(acc[j]);
      o[j] = bit_cast<Word>(sum / (Out)(D)(c[j] > 1 ? c[j] : 1));
    } else {
      o[j] = stored<T, W>(acc[j]);
    }
  }
  Word* out = static_cast<Word*>(s.out);
  if (full) {
    *reinterpret_cast<typename C::Group*>(out + w0) = C::make(o);
  } else {
#pragma unroll
    for (int j = 0; j < kMergeWindows; ++j) {
      if (w0 + j < s.B) out[w0 + j] = o[j];
    }
  }
}

template <int OP, typename T, typename D = int>
cudaError_t launch_merge(const Shards& s, cudaStream_t stream) {
  const long long threads = ((long long)s.B + kMergeWindows - 1) /
                            kMergeWindows;
  const unsigned grid =
      (unsigned)((threads + kMergeThreads - 1) / kMergeThreads);
  if (s.n <= 2) {
    sp_merge_kernel<OP, T, 2, D><<<grid, kMergeThreads, 0, stream>>>(s);
  } else if (s.n <= 4) {
    sp_merge_kernel<OP, T, 4, D><<<grid, kMergeThreads, 0, stream>>>(s);
  } else if (s.n <= 8) {
    sp_merge_kernel<OP, T, 8, D><<<grid, kMergeThreads, 0, stream>>>(s);
  } else if constexpr (inline_of<T>() == 8) {
    sp_merge_kernel<OP, T, 8, D><<<grid, kMergeThreads, 0, stream>>>(s);
  } else {
    sp_merge_kernel<OP, T, kInline, D><<<grid, kMergeThreads, 0, stream>>>(
        s);
  }
  return cudaGetLastError();
}

// mean over the partials of T for a reduction of code `dtype`: a 1- or
// 2-byte integer dtype divides by the count wrapped into it
template <typename T>
cudaError_t merge_mean(int dtype, const Shards& s, cudaStream_t stream) {
  if constexpr (std::is_same<T, int32_t>::value) {
    if (dtype == DT_INT8) return launch_merge<OP_MEAN, T, int8_t>(s, stream);
    if (dtype == DT_INT16) {
      return launch_merge<OP_MEAN, T, int16_t>(s, stream);
    }
  } else if constexpr (std::is_same<T, uint32_t>::value) {
    if (dtype == DT_UINT8) {
      return launch_merge<OP_MEAN, T, uint8_t>(s, stream);
    }
    if (dtype == DT_UINT16) {
      return launch_merge<OP_MEAN, T, uint16_t>(s, stream);
    }
  }
  return launch_merge<OP_MEAN, T>(s, stream);
}

template <typename T>
cudaError_t merge_for(int op, int dtype, const Shards& s,
                      cudaStream_t stream) {
  switch (op) {
    case OP_SUM:
    case OP_COUNT:   // partial counts add in the dtype
      return launch_merge<OP_SUM, T>(s, stream);
    case OP_MEAN: return merge_mean<T>(dtype, s, stream);
    case OP_MIN: return launch_merge<OP_MIN, T>(s, stream);
    case OP_MAX: return launch_merge<OP_MAX, T>(s, stream);
    default: return launch_merge<OP_PROD, T>(s, stream);
  }
}

// the partial takes the seven value dtypes; the merge also the codes of
// the 1- and 2-byte integers (partials held in int32 or uint32)
bool valid(int op, int dtype, bool merge) {
  return op >= OP_SUM && op <= OP_MEAN &&
         ((dtype >= DT_INT32 && dtype <= DT_FLOAT64) ||
          (merge && dtype >= DT_INT8 && dtype <= DT_UINT16));
}

int width(int dtype) {
  return dtype == DT_INT64 || dtype == DT_UINT64 || dtype == DT_FLOAT64 ? 8
                                                                         : 4;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// fn<T>(args...) for the dtype code (valid() holds; a 1- or 2-byte
// integer code takes its 4-byte holder)
#define WF_BY_DTYPE(fn, dtype, ...)                                    \
  ((dtype) == DT_FLOAT32   ? fn<float>(__VA_ARGS__)                    \
   : (dtype) == DT_INT32 || (dtype) == DT_INT8 || (dtype) == DT_INT16  \
       ? fn<int32_t>(__VA_ARGS__)                                      \
   : (dtype) == DT_UINT32 || (dtype) == DT_UINT8 ||                    \
         (dtype) == DT_UINT16                                          \
       ? fn<uint32_t>(__VA_ARGS__)                                     \
   : (dtype) == DT_INT64   ? fn<long long>(__VA_ARGS__)                \
   : (dtype) == DT_UINT64  ? fn<unsigned long long>(__VA_ARGS__)       \
   : (dtype) == DT_FLOAT16 ? fn<__half>(__VA_ARGS__)                   \
                           : fn<double>(__VA_ARGS__))

}  // namespace

// Writes the (B,) partials `part` (words of the dtype) and, when `cnt` is
// not null, the (B,) int32 kept-row counts of one shard: its (Ns,) slice
// `vals` (of `dtype`, a Dtype code: int32, float32, uint32, int64,
// uint64, float64 or float16) holds rows [base, base + Ns); `keep` is a
// (Ns,) byte mask or null; the windows are (starts, lens) in the group's
// row coordinates; `ident` is the op's identity's bits in the work type
// (the low 4 bytes for a 4-byte one; float16: float32).  `long_windows` lists the n_long windows whose clipped length
// exceeds `split` (each once, any order; null when n_long is 0): they are
// reduced in chunks of `chunk_cells` cells (a multiple of 32), every other
// window by one team; a listed window of split cells or fewer is left to
// its team.  mean (op 5) and count need `cnt` for the merge.  One launch
// on `stream`; returns cudaGetLastError() after it.
extern "C" int wf_sp_window_partial(const void* vals, const void* keep,
                                    long long Ns, const void* starts,
                                    const void* lens, int B, long long base,
                                    int op, int dtype,
                                    unsigned long long ident,
                                    const void* long_windows, int n_long,
                                    int split, int chunk_cells, void* part,
                                    void* cnt, void* stream) {
  if (B <= 0 || Ns < 0 || !valid(op, dtype, false) || n_long < 0 ||
      split < 0 ||
      chunk_cells <= 0 || chunk_cells % (kGroup * kLanes) != 0 ||
      (n_long > 0 && long_windows == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Partial p{};
  p.vals = vals;
  p.keep = static_cast<const uint8_t*>(keep);
  p.Ns = Ns;
  p.base = base;
  p.starts = static_cast<const int32_t*>(starts);
  p.lens = static_cast<const int32_t*>(lens);
  p.long_windows = static_cast<const int32_t*>(long_windows);
  p.part = part;
  p.cnt = static_cast<int32_t*>(cnt);
  p.B = B;
  p.n_long = n_long;
  p.split = split;
  p.chunk = chunk_cells / kGroup;
  p.ident = ident;
  p.vec = aligned(vals, 16) && (keep == nullptr || aligned(keep, 4));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)WF_BY_DTYPE(partial_for, dtype, op, p, s);
}

// Folds, for each of the B windows, the n partials parts[0], ..., parts[n
// - 1] (device pointers to (B,) words of the dtype, already in fold
// order; for mean also the (B,) int32 counts cnts[k]) into the (B,) `out`:
// words of the dtype, or for mean float32 (a 4-byte or narrower integer
// dtype), float64 (an 8-byte one) or float16.  `dtype` is the
// reduction's Dtype code, or for a 1- or 2-byte integer its NarrowDtype
// code (partials in int32 or uint32).  `step` rounds float16 partials to
// float16 after every combine.  `parts` and `cnts` are host arrays of n
// device pointers; past 16 partials (8 for an 8-byte dtype) `far` must be
// a device array of the same 2n pointers (parts, then cnts; unused counts
// may be 0), else null.  One launch on `stream`; returns
// cudaGetLastError() after it.
extern "C" int wf_sp_merge(const void* const* parts, const void* const* cnts,
                           const void* far, int n, int B, int op, int dtype,
                           int step, void* out, void* stream) {
  const bool mean = op == OP_MEAN;
  if (n <= 0 || B <= 0 || !valid(op, dtype, true) ||
      (mean && cnts == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int inl = width(dtype) == 8 ? 8 : kInline;
  if (n > inl && far == nullptr) return (int)cudaErrorInvalidValue;
  Shards s{};
  s.n = n;
  s.B = B;
  s.out = out;
  s.far = n > inl ? static_cast<const uint64_t*>(far) : nullptr;
  s.vec = aligned(out, 16);
  s.step = step != 0;
  for (int k = 0; k < n; ++k) {
    s.vec = s.vec && aligned(parts[k], 16) && (!mean || aligned(cnts[k], 16));
    if (k < inl) {
      s.part[k] = parts[k];
      s.cnt[k] = mean ? static_cast<const int32_t*>(cnts[k]) : nullptr;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)WF_BY_DTYPE(merge_for, dtype, op, dtype, s, st);
}
