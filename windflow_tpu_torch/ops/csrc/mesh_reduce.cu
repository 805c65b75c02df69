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
// dtype; mean writes the sum).  No load leaves [lo, hi): the clip keeps
// every window inside the slice, as jnp.minimum(lo + iota, Ns - 1) does
// in JAX.  cnt == null skips the counts (ops other than count and mean).
//
// wf_sp_merge.  For window w < B it folds the n partials (and for mean the
// n int32 counts) of the window, each read in place through its own
// pointer, in the order the pointers come: the caller passes shards 0, 1,
// ..., n - 1 (psum, pmin, pmax, prod's gather fold) or 0, n - 1, n - 2,
// ..., 1 (the order in which sp shard 0 accumulates its ppermute hops, the
// shard whose value JAX returns).  mean writes float32 sum / max(count,
// 1), the integer sum converted to float32 first (JAX's true division of
// int32).
//
// Semantics kept identical to the reference: int32 sums and products wrap
// modulo 2^32 (they run in uint32); float min/max propagate NaN as jnp.min
// and jnp.max do; the identity comes from the caller as its 32-bit
// pattern (ops/monoid.py:identity).
//
// Order of the partial.  With a = lo mod 4, cell j of a window (0 <= j <
// n = hi - lo) lies in its 16-byte group g = (a + j) / 4, groups counted
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
// lane loads a whole group as one 16-byte value load and its 4 keep bytes
// as one word (the bool mask's bytes line up with the cells), kUnroll
// groups before its first combine, and computes its addresses once a
// group; a group that is cut by the window's ends, or a buffer that is
// not aligned, takes cell-by-cell loads of the window's cells only.  A
// long window's block: its 32 teams take chunks 32r + t in round r; each
// team's lane 0 writes its chunk partial to shared memory (two buffers,
// one __syncthreads a round), and thread 0 folds the round's partials in
// chunk order while the teams load the next round.  The launch bounds ask
// for kMinBlocks = 6 resident blocks an SM (at most 42 registers a
// thread; a few bytes spill).  Measured on an H100
// (scripts/torch_mesh_kernels.py, PERF.md): the block path wins from
// 2,048 cells at 1,032 windows and from 4,096 at 2^24 window cells, so
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
// (4 bytes + 1 keep byte each) read once, the descriptors (8 B a window)
// and the outputs written once; one 32-bit combine per window cell sets
// the bound by operations where windows overlap many times.
//
// Design of the merge.  A thread takes kMergeWindows = 4 consecutive
// windows: one 16-byte load a partial (and a count), all of them (up to
// NB = 2, 4, 8 or 16, the instantiation the shard count picks) issued
// before its first combine; a thread at the ragged end of B, or any
// pointer that is not 16-byte aligned, loads cell by cell.  The pointers
// of up to kInline = 16 shards travel in the kernel's parameters; more
// come from a device array the caller fills.  No partial is copied: an
// (n, B) tensor's rows or n separate tensors are read where they lie.
// Bound by bytes: n * B partials (and counts) read, B values written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { OP_SUM = 0, OP_COUNT = 1, OP_MIN = 2, OP_MAX = 3, OP_PROD = 4,
          OP_MEAN = 5 };
enum Dtype { DT_INT32 = 0, DT_FLOAT32 = 1 };

constexpr int kThreads = 256;
constexpr int kGroup = 4;                    // cells of a 16-byte group
constexpr int kLanes = 8;                    // lanes that reduce a window
constexpr int kTeams = kThreads / kLanes;    // windows (chunks) a block
constexpr int kUnroll = 4;                   // groups in flight a lane
constexpr int kPasses = 1;                   // windows a team takes
constexpr int kShortWindows = kTeams * kPasses;  // a short block's windows
static_assert(kShortWindows <= kThreads, "one descriptor a thread");
constexpr int kMinBlocks = 6;                // resident partial blocks an SM
constexpr int kMergeThreads = 256;
constexpr int kMergeWindows = 4;             // windows a merge thread
constexpr int kInline = 16;                  // merge pointers by value

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

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------------ partial

struct Partial {
  const uint32_t* vals;
  const uint8_t* keep;        // null: every row kept
  long long Ns, base;
  const int32_t* starts;
  const int32_t* lens;
  const int32_t* long_windows;  // the windows of the first n_long blocks
  uint32_t* part;
  int32_t* cnt;               // null: no counts
  int B, n_long, split, chunk;  // chunk in groups, a multiple of kLanes
  uint32_t ident;
  bool vec;                   // vals 16-byte and keep 4-byte aligned
};

// one window's cells: `vals` and `keep` point at its first aligned group
struct Window {
  const uint32_t* vals;
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

__device__ __forceinline__ Window window_at(const Partial& p, long long lo,
                                            int n) {
  const int a = (int)(lo & 3);
  const long long g0 = lo - a;
  return Window{p.vals + g0, p.keep != nullptr ? p.keep + g0 : nullptr, a,
                n};
}

// Group g of a window: its 4 values into v and its liveness into k, one
// byte a cell (1: a kept cell of the window, 0: not).  A whole group
// inside the window takes one 16-byte load (and one 4-byte keep word);
// a cut group loads only the window's own cells.
template <bool VALUES>
__device__ __forceinline__ void load_group(const Window& c, bool vec, int g,
                                           uint4& v, uint32_t& k) {
  const long long c0 = (long long)kGroup * g;   // cell of the aligned group
  const long long j0 = c0 - c.a;                // its window cell
  if (vec && j0 >= 0 && j0 + kGroup <= c.n) {
    if constexpr (VALUES) {
      v = __ldg(reinterpret_cast<const uint4*>(c.vals) + g);
    }
    k = c.keep != nullptr
            ? __vcmpne4(__ldg(reinterpret_cast<const uint32_t*>(c.keep) + g),
                        0u) & 0x01010101u
            : 0x01010101u;
    return;
  }
  uint32_t x[kGroup] = {0u, 0u, 0u, 0u};
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
  v = make_uint4(x[0], x[1], x[2], x[3]);
}

// Lane q's part of groups [gb, ge) (gb a multiple of kLanes): the groups
// g = q (mod kLanes), ascending, their live cells combined into acc and
// counted into cnt.
template <int OP, typename W, bool VALUES>
__device__ __forceinline__ void fold_groups(const Window& c, bool vec, int gb,
                                            int ge, int q, W& acc, int& cnt) {
  for (int g1 = gb + q; g1 < ge; g1 += kLanes * kUnroll) {
    uint4 v[kUnroll];
    uint32_t k[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int g = g1 + kLanes * i;
      k[i] = 0u;
      if (g < ge) load_group<VALUES>(c, vec, g, v[i], k[i]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      cnt += __popc(k[i]);
      if constexpr (VALUES) {
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          if (k[i] & (0xffu << (8 * e))) {
            acc = combine<OP, W>(acc, from_bits<W>(lane_of(v[i], e)));
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
  if constexpr (VALUES) {
    p.part[w] = to_bits<W>(acc);
  } else if constexpr (std::is_same<T, float>::value) {
    p.part[w] = to_bits<float>((float)cnt);   // count: the kept rows, as float
  } else {
    p.part[w] = (uint32_t)cnt;
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
    W acc = from_bits<W>(p.ident);
    int cnt = 0;
    const bool mine = w0 + k < p.B && s_n[k] <= p.split;
    if (mine) {
      const Window c = window_at(p, s_lo[k], s_n[k]);
      fold_groups<OP, W, VALUES>(c, p.vec, 0, c.groups(), q, acc, cnt);
    }
    team_reduce<OP, W, VALUES>(acc, cnt);
    if (mine && q == 0) write_window<T, W, VALUES>(p, w0 + k, acc, cnt);
  }
}

// one long window by the whole block, chunk by chunk
template <int OP, typename T, bool VALUES>
__device__ __forceinline__ void long_window(const Partial& p, long long w) {
  using W = typename Work<OP, T>::type;
  __shared__ uint32_t s_part[2][kTeams];
  __shared__ int s_cnt[2][kTeams];
  if (w < 0 || w >= p.B) return;              // the whole block leaves
  long long lo;
  int n;
  clipped(p, w, lo, n);
  if (n <= p.split) return;                   // the short path's window
  const Window c = window_at(p, lo, n);
  const int team = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int G = c.groups();
  const int chunks = (G + p.chunk - 1) / p.chunk;
  W total = from_bits<W>(p.ident);
  int total_cnt = 0;
  for (int r = 0; r * kTeams < chunks; ++r) {
    const int ch = r * kTeams + team;
    W acc = from_bits<W>(p.ident);
    int cnt = 0;
    if (ch < chunks) {
      const int gb = ch * p.chunk;
      fold_groups<OP, W, VALUES>(c, p.vec, gb, min(gb + p.chunk, G), q, acc,
                                 cnt);
    }
    team_reduce<OP, W, VALUES>(acc, cnt);
    const int buf = r & 1;
    if (q == 0) {
      s_part[buf][team] = to_bits<W>(acc);
      s_cnt[buf][team] = cnt;
    }
    // one barrier a round: the buffer written next round was folded
    // before thread 0 reached this one
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(kTeams, chunks - r * kTeams);
      for (int t = 0; t < m; ++t) {
        if constexpr (VALUES) {
          total = combine<OP, W>(total, from_bits<W>(s_part[buf][t]));
        }
        total_cnt += s_cnt[buf][t];
      }
    }
  }
  if (threadIdx.x == 0) write_window<T, W, VALUES>(p, w, total, total_cnt);
}

template <int OP, typename T, bool VALUES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  const uint32_t* part[kInline];   // in fold order
  const int32_t* cnt[kInline];     // mean only
  const uint64_t* far;             // n > kInline: 2n device pointers
  uint32_t* out;
  int n, B;
  bool vec;                        // every pointer 16-byte aligned
};

template <typename P>
__device__ __forceinline__ const P* shard_ptr(const Shards& s,
                                              const P* const* inl, int k,
                                              int i, int half) {
  return s.far != nullptr
             ? reinterpret_cast<const P*>(s.far[half * s.n + k + i])
             : inl[i];
}

// the kMergeWindows cells of one shard from w0 (cell by cell when cut)
__device__ __forceinline__ uint4 load4(const uint32_t* ptr, long long w0,
                                       int B, bool full) {
  if (full) return __ldg(reinterpret_cast<const uint4*>(ptr + w0));
  uint32_t x[kMergeWindows] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kMergeWindows; ++j) {
    if (w0 + j < B) x[j] = __ldg(ptr + w0 + j);
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

template <int OP, typename T, int NB>
__global__ void __launch_bounds__(kMergeThreads)
sp_merge_kernel(const __grid_constant__ Shards s) {
  using W = typename Work<OP, T>::type;
  constexpr bool kMean = OP == OP_MEAN;
  const long long w0 =
      ((long long)blockIdx.x * kMergeThreads + threadIdx.x) * kMergeWindows;
  if (w0 >= s.B) return;
  const bool full = s.vec && w0 + kMergeWindows <= s.B;
  W acc[kMergeWindows];
  int c[kMergeWindows] = {0, 0, 0, 0};
  for (int k = 0; k < s.n; k += NB) {
    uint4 v[NB], cv[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {   // every load before the first combine
      if (k + i < s.n) {
        v[i] = load4(shard_ptr<uint32_t>(s, s.part, k, i, 0), w0, s.B, full);
        if constexpr (kMean) {
          cv[i] = load4(reinterpret_cast<const uint32_t*>(
                            shard_ptr<int32_t>(s, s.cnt, k, i, 1)),
                        w0, s.B, full);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (k + i < s.n) {
#pragma unroll
        for (int j = 0; j < kMergeWindows; ++j) {
          const W x = from_bits<W>(lane_of(v[i], j));
          acc[j] = k + i == 0 ? x : combine<OP, W>(acc[j], x);
          if constexpr (kMean) c[j] += (int32_t)lane_of(cv[i], j);
        }
      }
    }
  }
  uint32_t o[kMergeWindows];
#pragma unroll
  for (int j = 0; j < kMergeWindows; ++j) {
    if constexpr (kMean) {
      // JAX: s / max(c, 1), in float32 for both dtypes
      float sum;
      if constexpr (std::is_same<T, float>::value) {
        sum = acc[j];
      } else {
        sum = (float)(int32_t)acc[j];
      }
      o[j] = to_bits<float>(sum / (float)(c[j] > 1 ? c[j] : 1));
    } else {
      o[j] = to_bits<W>(acc[j]);
    }
  }
  if (full) {
    *reinterpret_cast<uint4*>(s.out + w0) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kMergeWindows; ++j) {
      if (w0 + j < s.B) s.out[w0 + j] = o[j];
    }
  }
}

template <int OP, typename T>
cudaError_t launch_merge(const Shards& s, cudaStream_t stream) {
  const long long threads = ((long long)s.B + kMergeWindows - 1) /
                            kMergeWindows;
  const unsigned grid =
      (unsigned)((threads + kMergeThreads - 1) / kMergeThreads);
  if (s.n <= 2) {
    sp_merge_kernel<OP, T, 2><<<grid, kMergeThreads, 0, stream>>>(s);
  } else if (s.n <= 4) {
    sp_merge_kernel<OP, T, 4><<<grid, kMergeThreads, 0, stream>>>(s);
  } else if (s.n <= 8) {
    sp_merge_kernel<OP, T, 8><<<grid, kMergeThreads, 0, stream>>>(s);
  } else {
    sp_merge_kernel<OP, T, kInline><<<grid, kMergeThreads, 0, stream>>>(s);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t merge_for(int op, const Shards& s, cudaStream_t stream) {
  switch (op) {
    case OP_SUM:
    case OP_COUNT:   // partial counts add in the dtype
      return launch_merge<OP_SUM, T>(s, stream);
    case OP_MEAN: return launch_merge<OP_MEAN, T>(s, stream);
    case OP_MIN: return launch_merge<OP_MIN, T>(s, stream);
    case OP_MAX: return launch_merge<OP_MAX, T>(s, stream);
    default: return launch_merge<OP_PROD, T>(s, stream);
  }
}

bool valid(int op, int dtype) {
  return op >= OP_SUM && op <= OP_MEAN &&
         (dtype == DT_INT32 || dtype == DT_FLOAT32);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// Writes the (B,) partials `part` (32-bit words of the dtype) and, when
// `cnt` is not null, the (B,) int32 kept-row counts of one shard: its
// (Ns,) slice `vals` (int32 or float32 per `dtype`) holds rows [base,
// base + Ns); `keep` is a (Ns,) byte mask or null; the windows are
// (starts, lens) in the group's row coordinates; `ident` is the op's
// identity's bits.  `long_windows` lists the n_long windows whose clipped
// length exceeds `split` (each once, any order; null when n_long is 0):
// they are reduced in chunks of `chunk_cells` cells (a multiple of 32),
// every other window by one team; a listed window of split cells or fewer
// is left to its team.  mean (op 5) and count need `cnt` for the merge.
// One launch on `stream`; returns cudaGetLastError() after it.
extern "C" int wf_sp_window_partial(const void* vals, const void* keep,
                                    long long Ns, const void* starts,
                                    const void* lens, int B, long long base,
                                    int op, int dtype, unsigned int ident,
                                    const void* long_windows, int n_long,
                                    int split, int chunk_cells, void* part,
                                    void* cnt, void* stream) {
  if (B <= 0 || Ns < 0 || !valid(op, dtype) || n_long < 0 || split < 0 ||
      chunk_cells <= 0 || chunk_cells % (kGroup * kLanes) != 0 ||
      (n_long > 0 && long_windows == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Partial p{};
  p.vals = static_cast<const uint32_t*>(vals);
  p.keep = static_cast<const uint8_t*>(keep);
  p.Ns = Ns;
  p.base = base;
  p.starts = static_cast<const int32_t*>(starts);
  p.lens = static_cast<const int32_t*>(lens);
  p.long_windows = static_cast<const int32_t*>(long_windows);
  p.part = static_cast<uint32_t*>(part);
  p.cnt = static_cast<int32_t*>(cnt);
  p.B = B;
  p.n_long = n_long;
  p.split = split;
  p.chunk = chunk_cells / kGroup;
  p.ident = ident;
  p.vec = aligned(vals, 16) && (keep == nullptr || aligned(keep, 4));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == DT_FLOAT32 ? partial_for<float>(op, p, s)
                                   : partial_for<int32_t>(op, p, s));
}

// Folds, for each of the B windows, the n partials parts[0], ..., parts[n
// - 1] (device pointers to (B,) dtype words, already in fold order; for
// mean also the (B,) int32 counts cnts[k]) into the (B,) `out`: dtype
// words, or float32 for mean.  `parts` and `cnts` are host arrays of n
// device pointers; past kInline = 16 partials `far` must be a device array
// of the same 2n pointers (parts, then cnts; unused counts may be 0), else
// null.  One launch on `stream`; returns cudaGetLastError() after it.
extern "C" int wf_sp_merge(const void* const* parts, const void* const* cnts,
                           const void* far, int n, int B, int op, int dtype,
                           void* out, void* stream) {
  const bool mean = op == OP_MEAN;
  if (n <= 0 || B <= 0 || !valid(op, dtype) || (mean && cnts == nullptr) ||
      (n > kInline && far == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Shards s{};
  s.n = n;
  s.B = B;
  s.out = static_cast<uint32_t*>(out);
  s.far = n > kInline ? static_cast<const uint64_t*>(far) : nullptr;
  s.vec = aligned(out, 16);
  for (int k = 0; k < n; ++k) {
    s.vec = s.vec && aligned(parts[k], 16) && (!mean || aligned(cnts[k], 16));
    if (k < kInline) {
      s.part[k] = static_cast<const uint32_t*>(parts[k]);
      s.cnt[k] = mean ? static_cast<const int32_t*>(cnts[k]) : nullptr;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == DT_FLOAT32 ? merge_for<float>(op, s, st)
                                   : merge_for<int32_t>(op, s, st));
}
