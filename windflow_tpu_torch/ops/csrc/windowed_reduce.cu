// Windowed monoid reductions over 2-D (row, start, len) descriptors, every
// evaluation of a dispatch in one launch, for sm_90a.
//
// Replaces the Pallas TPU kernel windflow_tpu/ops/pallas_kernels.py:
// windowed_reduce_pallas (body _kernel), and the XLA device bodies that
// evaluate windows over a resident ring: _ring_eval via _append_eval
// (windflow_tpu/ops/resident.py:243, :260) and the stats loop of
// _make_multi_step (:599, :614).
//
// Function.  For window w < B, with len = min(lens[w], pad) (0 when it is
// negative or the buffers have no column) and s = max(starts[w], 0), and
// for every evaluation e (buffer buf_e of shape (R, ncols), op, dtype):
//     out_e[w] = op-reduce of buf_e[rows[w], min(s + j, ncols - 1)],
//                j = 0 .. len - 1
// rows == null reads row 0 (the restaging path's one flat row).  The ops
// are sum, count, min, max and prod over int32, float32, uint32, int64,
// uint64, float16 or float64 values; count writes lens[w] (unclamped)
// converted to the dtype.  ncols is 64-bit and
// so is every row offset rows[w] * ncols: a ring may hold 2^31 cells and
// more (the flat int32 starts this kernel once took could not).
//
// Semantics kept identical to the reference (XLA on the TPU):
//  * integer sums and products wrap modulo 2^32 or 2^64: they run in the
//    unsigned type of their width, because signed overflow is undefined
//    behaviour in C++; uint32 and uint64 compare unsigned, int32 and int64
//    signed (cells.cuh: Work);
//  * float16 values are reduced in float and the result is rounded to
//    float16 once, as XLA accumulates a float16 reduction in float32;
//  * float min and max propagate NaN, as jnp.min / jnp.max do (fminf and
//    fmaxf would drop it);
//  * the identity (0, 1 or the dtype extremes) is passed in by the caller as
//    the 64-bit pattern of its work type, from ops/monoid.py:identity; a
//    window of length 0 yields it;
//  * a column past the row's end reads the row's last cell, as the JAX
//    gathers clamp their indices: no load leaves [row*ncols, row*ncols +
//    ncols).
//
// Order.  A window is reduced by kLanes = 8 lanes of a warp (a warp takes
// 4 windows at once).  With f0 = rows[w] * ncols + s the flat index of the
// window's first cell and a = f0 mod 4, cell j lies in the window's 4-cell
// group g = (a + j) / 4 (groups are aligned in the buffer: 16 bytes for
// 4-byte cells, 32 for 8-byte ones, 8 for float16) and belongs to
// lane g mod 8; a lane combines its cells in ascending j, starting from the
// identity, then the window's lanes combine by a butterfly of
// __shfl_xor_sync over 4, 2, 1 (each lane combines its own value with its
// partner's, own first); the first lane writes.  Vector and cell-by-cell
// loads combine in exactly this order, so the result does not depend on
// how the cells were loaded, two launches agree bit for bit, and a CPU
// twin (ops/windowed_reduce.py: lane_order_twin) reproduces it.
//
// Design.  One launch evaluates up to kMaxEvals evaluations (the wrapper
// splits more) of one dtype class: int32 and float32 share a launch (the
// instantiation <int32_t, float>, one switch at run time);
// every other dtype is an instantiation of its own.  A block takes
// kWindows consecutive windows, a warp 4 of them at a time, read straight
// from device memory (overlapping windows re-read their cells through L1
// and L2).  A lane loads its groups as vectors (16 bytes; two of them for
// 8-byte cells), kUnroll of them before the first combine waits on one,
// and combines the 4 cells of a group without a mask where the 32 cells
// its window's lanes cover in that trip all lie inside the window: a
// window of 256 cells is 8 loads and 32 combines a lane.  A lane loads
// only the groups g < ceil((a + len) / 4) of its window, so no vector load
// leaves the window's first and last groups; those lie inside the row, or
// the window takes cell-by-cell loads in the same order (as it does where
// it passes its row's end, with clamped cells, or where a buffer is not
// 16-byte aligned).  (A first version gave each of the 32 lanes of a warp
// one cell at a time, one window a warp, with 64-bit index arithmetic on
// every cell: on the H100 it was issue-bound, more than twice as slow as
// the kernel it replaced.  A staged variant, each block copying its
// windows' span to shared memory once, moved a quarter of the bytes and
// was slower all the same: the blocks' dependent phases ran in one wave
// in lock step; PERF.md.)
//
// Bound on an H100 SXM (3.35 TB/s), by bytes: the cells the windows cover
// read once per distinct buffer, the descriptors read once, every output
// written once; one combine per cell and evaluation (32 or 64 bits) is
// far below the card's peak rate.  At the restaging shape (32,768 windows
// of 256 cells, slide 64) the windows cover each cell 4 times, so this
// design pulls four times the bound's bytes through L2.

#include "cells.cuh"

namespace {

using namespace wf;

constexpr int kMaxEvals = 8;          // evaluations one launch takes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;             // cells of a group (one vector load)
constexpr int kLanes = 8;             // lanes that reduce one window
constexpr int kWinPerWarp = 32 / kLanes;
constexpr int kTrip = kGroup * kLanes;  // cells a window's lanes cover a trip
constexpr int kUnroll = 4;            // group loads in flight a lane
constexpr int kWindows = 64;          // windows a block

struct Evals {
  const void* buf[kMaxEvals];       // the distinct buffers read (nbuf)
  void* out[kMaxEvals];             // one (B,) output an evaluation
  int op[kMaxEvals];
  int dtype[kMaxEvals];
  int src[kMaxEvals];               // index into buf; -1 for count
  unsigned long long ident[kMaxEvals];  // the identity's bits
  int n, nbuf;
};

// where a window's cells come from: one row of a buffer in device memory
// (`grp` is the window's first group, valid where `vec` holds)
template <typename T>
struct Src {
  using C = CellsOf<T>;
  const typename C::Word* row;
  const typename C::Group* grp;
  __device__ __forceinline__ typename C::Group group(int g) const {
    return C::load(grp + g);
  }
  __device__ __forceinline__ typename C::Word cell(long long col) const {
    return __ldg(row + col);
  }
};

// One evaluation over one window, by its kLanes lanes (q = 0 .. kLanes-1;
// the order at the top); every lane of the warp calls it (the butterfly
// needs them all), a lane without a window with len = 0.
template <int OP, typename T>
__device__ __forceinline__ void reduce_window(const Src<T>& src, bool vec,
                                              int a, long long s, int len,
                                              long long last,
                                              unsigned long long ident, int q,
                                              WordOf<T>* out) {
  using W = typename Work<OP, T>::type;
  using C = CellsOf<T>;
  W acc = ident_of<W>(ident);
  const int trips = len > 0 ? (a + len + kTrip - 1) / kTrip : 0;
  if (vec) {
    const int groups = (a + len + kGroup - 1) / kGroup;   // its groups
    for (int t0 = 0; t0 < trips; t0 += kUnroll) {
      // A group past the window's last is not loaded, so the last trip's
      // loads stay inside the window.  v[i] is then left unset (zeroing it
      // cost 5% at the restaging shape on the H100) and never read: a cell
      // is read only where it lies in the window, hence in a loaded group.
      typename C::Group v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int g = q + kLanes * (t0 + i);
        if (g < groups) v[i] = src.group(g);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (t0 + i < trips) {
          const int c0 = kTrip * (t0 + i) - a;   // the trip's first cell
          if (c0 >= 0 && c0 + kTrip <= len) {
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
              acc = combine<OP, W>(acc, value<T, W>(C::at(v[i], k)));
            }
          } else {
            const unsigned j = (unsigned)(c0 + kGroup * q), n = len;
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
              if (j + k < n) {
                acc = combine<OP, W>(acc, value<T, W>(C::at(v[i], k)));
              }
            }
          }
        }
      }
    }
  } else {
    for (int t = 0; t < trips; ++t) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int j = kTrip * t + kGroup * q + k - a;
        if (j >= 0 && j < len) {
          const long long c = s + j;
          acc = combine<OP, W>(acc, value<T, W>(src.cell(c < last ? c
                                                                  : last)));
        }
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    acc = combine<OP, W>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (q == 0 && out != nullptr) *out = stored<T, W>(acc);
}

// OP over values of TA, or of TB where `second` holds (one switch at run
// time for the int32/float32 class; TA == TB for the other dtypes)
template <int OP, typename TA, typename TB>
__device__ __forceinline__ void reduce_as(bool second, const void* row,
                                          const void* grp, bool vec, int a,
                                          long long s, int len,
                                          long long last,
                                          unsigned long long id, int q,
                                          void* out) {
  using WA = WordOf<TA>;
  const Src<TA> sa{static_cast<const WA*>(row),
                   static_cast<const typename CellsOf<TA>::Group*>(grp)};
  if constexpr (std::is_same<TA, TB>::value) {
    reduce_window<OP, TA>(sa, vec, a, s, len, last, id, q,
                          static_cast<WA*>(out));
  } else {
    using WB = WordOf<TB>;
    const Src<TB> sb{static_cast<const WB*>(row),
                     static_cast<const typename CellsOf<TB>::Group*>(grp)};
    second ? reduce_window<OP, TB>(sb, vec, a, s, len, last, id, q,
                                   static_cast<WB*>(out))
           : reduce_window<OP, TA>(sa, vec, a, s, len, last, id, q,
                                   static_cast<WA*>(out));
  }
}

template <typename TA, typename TB>
__device__ __forceinline__ void reduce_eval(int op, bool second,
                                            unsigned long long id,
                                            const void* row, const void* grp,
                                            bool vec, int a, long long s,
                                            int len, int count,
                                            long long last, int q,
                                            void* out) {
  switch (op) {
    case OP_COUNT:
      if (q == 0 && out != nullptr) {
        if (second) {
          *static_cast<WordOf<TB>*>(out) = count_as<TB>(count);
        } else {
          *static_cast<WordOf<TA>*>(out) = count_as<TA>(count);
        }
      }
      break;
    case OP_SUM:
      reduce_as<OP_SUM, TA, TB>(second, row, grp, vec, a, s, len, last, id,
                                q, out);
      break;
    case OP_MIN:
      reduce_as<OP_MIN, TA, TB>(second, row, grp, vec, a, s, len, last, id,
                                q, out);
      break;
    case OP_MAX:
      reduce_as<OP_MAX, TA, TB>(second, row, grp, vec, a, s, len, last, id,
                                q, out);
      break;
    default:  // OP_PROD (the C entry refuses any other op)
      reduce_as<OP_PROD, TA, TB>(second, row, grp, vec, a, s, len, last, id,
                                 q, out);
      break;
  }
}

// TA and TB are of one width: the int32/float32 class (an evaluation of
// dtype SECOND reads TB), or one dtype twice
template <typename TA, typename TB, int SECOND>
__global__ void __launch_bounds__(kThreads)
windowed_reduce_kernel(const __grid_constant__ Evals ev, long long ncols,
                       const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ lens, int B, int pad,
                       bool vec) {
  static_assert(sizeof(TA) == sizeof(TB), "one width a launch");
  using Word = WordOf<TA>;
  __shared__ int s_row[kWindows], s_start[kWindows], s_len[kWindows],
      s_count[kWindows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long w0 = (long long)blockIdx.x * kWindows;
  const int nw = (int)(B - w0 < kWindows ? B - w0 : kWindows);
  const long long last = ncols - 1;

  if (tid < nw) {
    const long long w = w0 + tid;
    const int count = lens[w];
    s_row[tid] = rows != nullptr ? rows[w] : 0;
    s_start[tid] = max(starts[w], 0);
    s_len[tid] = ncols > 0 ? max(0, min(count, pad)) : 0;
    s_count[tid] = count;
  }
  __syncthreads();

  const int q = lane % kLanes;
  for (int k0 = warp * kWinPerWarp; k0 < nw; k0 += kWarps * kWinPerWarp) {
    const int k = k0 + lane / kLanes;   // a lane past nw reduces nothing
    const bool live = k < nw;
    const long long s = live ? s_start[k] : 0;
    const int len = live ? s_len[k] : 0, count = live ? s_count[k] : 0;
    const long long row_base = live ? (long long)s_row[k] * ncols : 0;
    const long long f0 = row_base + s;     // the window's first cell
    const int a = (int)(f0 & 3);
    const long long g0 = f0 - a;           // its first group
    // no clamped cell, and the window's groups inside the row
    const bool gvec = vec && s + len <= ncols && g0 >= row_base &&
                      g0 + (((long long)a + len + 3) & ~3LL) <=
                          row_base + ncols;
    for (int e = 0; e < ev.n; ++e) {
      const int u = ev.src[e] < 0 ? 0 : ev.src[e];
      const Word* buf = static_cast<const Word*>(ev.buf[u]);
      Word* out = live ? static_cast<Word*>(ev.out[e]) + w0 + k : nullptr;
      reduce_eval<TA, TB>(ev.op[e], ev.dtype[e] == SECOND,
                          ev.ident[e], buf + row_base,
                          buf + (gvec ? g0 : 0), gvec, a, s, len, count,
                          last, q, out);
    }
  }
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool known(int dtype) { return dtype >= DT_INT32 && dtype <= DT_FLOAT64; }

bool int32_class(int dtype) {
  return dtype == DT_INT32 || dtype == DT_FLOAT32;
}

template <typename TA, typename TB, int SECOND>
cudaError_t launch(const Evals& ev, long long ncols, const void* rows,
                   const void* starts, const void* lens, int B, int pad,
                   bool vec, cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + kWindows - 1) / kWindows);
  windowed_reduce_kernel<TA, TB, SECOND><<<grid, kThreads, 0, stream>>>(
      ev, ncols, static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(lens),
      B, pad, vec);
  return cudaGetLastError();
}

}  // namespace

// Launches one windowed reduction of `n` evaluations (1 <= n <= 8) on
// `stream`: evaluation e reduces buffer bufs[e] (of dtypes[e], a Dtype
// code; all buffers of one (R, ncols) shape, row-major) with ops[e] over
// the B windows (rows, starts, lens; rows may be null: row 0) and writes B
// values of its dtype to outs[e]; idents[e] is the identity's bits in the
// work type.  The dtypes of one launch are int32 and float32, or one other
// dtype.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int wf_windowed_reduce(const void* const* bufs, void* const* outs,
                                  const int* ops, const int* dtypes,
                                  const unsigned long long* idents, int n,
                                  long long ncols, const void* rows,
                                  const void* starts, const void* lens, int B,
                                  int pad, void* stream) {
  if (n <= 0 || n > kMaxEvals || B <= 0 || ncols < 0 || pad < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Evals ev{};
  ev.n = n;
  bool vec = true;
  for (int e = 0; e < n; ++e) {
    if (ops[e] < OP_SUM || ops[e] > OP_PROD || !known(dtypes[e]) ||
        (int32_class(dtypes[e]) ? !int32_class(dtypes[0])
                                : dtypes[e] != dtypes[0])) {
      return (int)cudaErrorInvalidValue;
    }
    ev.out[e] = outs[e];
    ev.op[e] = ops[e];
    ev.dtype[e] = dtypes[e];
    ev.ident[e] = idents[e];
    ev.src[e] = -1;
    if (ops[e] == OP_COUNT) continue;   // reads no value
    for (int u = 0; u < ev.nbuf; ++u) {
      if (ev.buf[u] == bufs[e]) ev.src[e] = u;
    }
    if (ev.src[e] < 0) {
      ev.src[e] = ev.nbuf;
      ev.buf[ev.nbuf++] = bufs[e];
      vec = vec && aligned16(bufs[e]);
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WF_LAUNCH(TA, TB, SECOND) \
  launch<TA, TB, SECOND>(ev, ncols, rows, starts, lens, B, pad, vec, st)
  cudaError_t rc;
  switch (dtypes[0]) {
    case DT_INT32:
    case DT_FLOAT32: rc = WF_LAUNCH(int32_t, float, DT_FLOAT32); break;
    case DT_UINT32: rc = WF_LAUNCH(uint32_t, uint32_t, -1); break;
    case DT_INT64: rc = WF_LAUNCH(long long, long long, -1); break;
    case DT_UINT64:
      rc = WF_LAUNCH(unsigned long long, unsigned long long, -1);
      break;
    case DT_FLOAT16: rc = WF_LAUNCH(__half, __half, -1); break;
    default: rc = WF_LAUNCH(double, double, -1); break;
  }
#undef WF_LAUNCH
  return (int)rc;
}

// Launches one block that does nothing, on `stream`: the floor that any
// launch of this card and stream pays (chip_smoke.py times it).  Returns
// cudaGetLastError().
extern "C" int wf_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
