// Kernels of the device-resident ring archive, for sm_90a.
//
// One kernel body, append_sum_kernel, replaces the XLA-jitted device
// bodies of windflow_tpu/ops/resident.py:
//  * ring_append_regular_sum: the whole of _regular_body (:183-199) in
//    one launch, as the JAX step is one jitted step: the append, then the
//    regular window sums (there a ring-wide cumsum + two-point gather,
//    here direct window sums).  With an empty rectangle (Rb = 0) it gives
//    the window sums alone;
//  * ring_append: the vmapped dynamic_update_slice + astype of
//    _ring_append (:234-240), the append of every irregular launch and of
//    every per-field ring: the same kernel with no window (C = 0),
//    instantiated without its window part (kSums = false).  An
//    instantiation that kept it, and so its registers, measured 7-8%
//    slower at both of ring_append's main-path shapes on the H100
//    (PERF.md).
// The irregular evaluation (_ring_eval) runs through the windowed_reduce
// kernel over (row, start, len) descriptors (ops/resident.py).
//
// The append.  For every row r < KP and column j < Rb:
//     ring[r, offs[r] + j] = (Acc) blk[r, j]
// over the whole padded rectangle, zero rows and columns included, so the
// ring holds what the JAX ring holds cell for cell.  The update is in
// place (JAX produced a new array).  The host guards offs + Rb <= cap
// (_check_ring_overflow); the kernel also drops any write outside
// [0, cap), so it never writes past a row.
// Design: a warp moves 512 cells of one row, 16 a thread (the grid is
// flattened over (row, 512-cell chunk); offs[r] is loaded once a thread).
// The warp reads its chunk with 16-byte loads, consecutive lanes on
// consecutive 16 bytes, into shared memory.  A row's destination
// r*cap + offs[r] has any alignment, so the row is cut at the ring's
// 4-cell boundaries: the first h = (-(r*cap + offs[r])) mod 4 cells (the
// head) and the last (Rb - h) mod 4 (the tail) are stored one by one,
// every 4-cell group between them with one aligned 16-byte store, group
// g taking row cells h+4g .. h+4g+3.  Lane l of the warp stores groups
// 32q + l (q = 0..3) of its chunk, read back from shared memory and
// widened in registers, so each store instruction writes 512 contiguous
// bytes.  The chunk's last groups reach h cells into the next chunk,
// which the warp also loads (16 cells, an L2 hit: that chunk's warp
// loads them too).  A rectangle whose Rb is not a multiple of 16, or a
// ring or blk not 16-byte aligned, takes a per-cell path inside the
// kernel (lane l moves cells l, l+32, ... of the chunk).
// Bound on an H100 SXM (3.35 TB/s), by bytes: read KP*Rb*sizeof(Wire) and
// KP*4 offsets, write KP*Rb*sizeof(Acc).
//
// The regular window sums.  For r < KP and i < C:
//     s = clip(rstart0[r] + i*slide, 0, cap), e = clip(s + rlen[r], 0, cap)
//     out[r, i] = sum(ring'[r, s:e])      (rlen >= 0)
// where ring' is the ring after the append.
// Design: one launch, two kinds of block.  The first blocks append the
// rectangle, a warp per 512-cell chunk (with C = 0 they are the whole
// launch: ring_append).  The others sum the windows, a warp per 2 consecutive
// windows of one row: lane l adds cells s+l, s+l+32, ... of each window,
// loading 8 of them a window before the first add (16 loads in flight a
// lane: one memory round trip for a 256-cell window), then a butterfly of
// __shfl_xor_sync over 16, 8, 4, 2, 1.  A cell inside the rectangle
// [offs[r], offs[r] + Rb) is read from blk (1 byte for an int8 wire) and
// widened, a cell outside it from the ring.  So the appended cells make
// no round trip through device memory, and no warp reads a ring cell that
// this launch writes: the blocks need no ordering and no grid sync.
// Overlapping windows re-read their cells from L1/L2.  (A design that
// staged each block's span of windows in shared memory measured slower on
// the H100: a barrier and two dependent phases a block, and the register
// pressure of keeping every load in flight; PERF.md.)
// Order: every path adds in the order above, so two launches agree bit
// for bit.  int32 sums run in uint32 and wrap modulo 2^32: that is bit
// for bit the cumsum difference XLA computes.  float32 sums round
// differently from a float32 cumsum difference; the tests hold them to a
// stated tolerance.
// Bound, by bytes: blk read once, the rectangle written once, the ring
// cells the windows cover outside the rectangle read once, the 3*KP int32
// descriptors, the (KP, C) sums written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Wire { W_INT8 = 0, W_INT16 = 1, W_INT32 = 2, W_FLOAT32 = 3 };
enum Acc { A_INT32 = 0, A_FLOAT32 = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                 // cells a thread appends
constexpr int kWarpCells = 32 * kChunk;    // cells a warp appends
constexpr int kWinPerWarp = 2;             // windows a warp sums
constexpr int kUnroll = 8;                 // loads in flight a lane a window
// row-local cell indices of the window sums are int: the C entry refuses
// longer rows
constexpr long long kMaxCap = 1LL << 30;

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

template <typename A> struct Vec4;
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

template <typename A>
__device__ __forceinline__ void put(A* row, long long c, long long cap,
                                    A v) {
  if (c >= 0 && c < cap) row[c] = v;
}

// One warp's part of one row's append: row cells [512*wc, 512*wc + 512)
// (see the note at the top).  load() issues the loads, stage() writes the
// 16-byte units to the warp's shared buffer (then the caller syncs),
// store() writes the ring.  `flat` is r*cap + offs[r]; `vec` says
// Rb % 16 == 0 and both tensors are 16-byte aligned.
template <typename W, typename A>
struct WarpAppend {
  // the warp's units of blk, then the next chunk's 16 cells (lanes
  // < sizeof(W)), for the groups that reach into it
  static constexpr int kUnits = 32 * (int)sizeof(W);
  static constexpr int kBufCells = kWarpCells + kChunk;
  A* row;
  const W* blk;
  long long o, cap;
  int Rb, wc, lane, h, nb;
  bool vec;
  uint4 raw[sizeof(W) + 1];
  A cells[kChunk];

  __device__ __forceinline__ WarpAppend(A* row_, const W* blk_, long long o_,
                                        long long flat, long long cap_,
                                        int Rb_, int wc_, int lane_,
                                        bool vec_)
      : row(row_), blk(blk_), o(o_), cap(cap_), Rb(Rb_), wc(wc_),
        lane(lane_), h((int)((4 - (flat & 3)) & 3)), nb(0), vec(vec_) {
    nb = (Rb - h) >> 2;
  }

  // unit n of this lane (n == sizeof(W): the next chunk's, whether the
  // head needs it or not, so no load waits for offs[r]), in 16-byte
  // units from the warp's chunk start; -1 when there is none
  __device__ __forceinline__ int unit(int n) const {
    const int u = n < (int)sizeof(W) ? n * 32 + lane : kUnits + lane;
    if (n == (int)sizeof(W) && lane >= (int)sizeof(W)) return -1;
    const long long row_units = (long long)Rb * sizeof(W) / 16;
    return (long long)wc * kUnits + u < row_units ? u : -1;
  }

  __device__ __forceinline__ void load() {
    if (vec) {
      const uint4* src = reinterpret_cast<const uint4*>(blk) +
                         (long long)wc * kUnits;
#pragma unroll
      for (int n = 0; n <= (int)sizeof(W); ++n) {
        const int u = unit(n);
        if (u >= 0) raw[n] = __ldg(src + u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const long long j = (long long)wc * kWarpCells + lane + 32 * k;
        if (j < Rb) cells[k] = widen<A, W>(__ldg(blk + j));
      }
    }
  }

  __device__ __forceinline__ void stage(W* buf) const {
    if (!vec) return;
#pragma unroll
    for (int n = 0; n <= (int)sizeof(W); ++n) {
      const int u = unit(n);
      if (u >= 0) reinterpret_cast<uint4*>(buf)[u] = raw[n];
    }
  }

  __device__ __forceinline__ void store(const W* buf) const {
    const long long j0 = (long long)wc * kWarpCells;
    if (!vec) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const long long j = j0 + lane + 32 * k;
        if (j < Rb) put(row, o + j, cap, cells[k]);
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long g = (long long)wc * (kWarpCells / 4) + 32 * q + lane;
      if (g < nb) {
        const W* b = buf + 128 * q + 4 * lane + h;
        const A a0 = widen<A, W>(b[0]), a1 = widen<A, W>(b[1]);
        const A a2 = widen<A, W>(b[2]), a3 = widen<A, W>(b[3]);
        const long long c = o + h + 4 * g;
        if (c >= 0 && c + 4 <= cap) {
          *reinterpret_cast<typename Vec4<A>::type*>(row + c) = {a0, a1, a2,
                                                                 a3};
        } else {
          put(row, c, cap, a0);
          put(row, c + 1, cap, a1);
          put(row, c + 2, cap, a2);
          put(row, c + 3, cap, a3);
        }
      }
    }
    if (wc == 0 && lane < h) {   // the head
      put(row, o + lane, cap, widen<A, W>(buf[lane]));
    }
    const long long t0 = h + 4LL * nb;   // the tail: cells t0 .. Rb - 1
    if ((Rb - 1) / kWarpCells == wc && t0 + lane < Rb) {
      put(row, o + t0 + lane, cap, widen<A, W>(buf[t0 + lane - j0]));
    }
  }
};

// Warp gw of the append's (row, 512-cell chunk) grid: its whole part.
template <typename W, typename A>
__device__ __forceinline__ void append_warp(A* ring, const W* blk,
                                            const int32_t* offs, int KP,
                                            long long cap, int Rb, bool vec,
                                            long long gw, int lane, W* buf) {
  const int wpr = (Rb + kWarpCells - 1) / kWarpCells;
  if (gw >= (long long)KP * wpr) return;   // uniform across the warp
  const int r = (int)(gw / wpr);
  const long long o = offs[r];
  WarpAppend<W, A> a(ring + (long long)r * cap, blk + (long long)r * Rb, o,
                     (long long)r * cap + o, cap, Rb, (int)(gw % wpr), lane,
                     vec);
  a.load();
  a.stage(buf);
  __syncwarp();
  a.store(buf);
}

// working type of the window sum: int32 wraps in uint32 (signed overflow
// is undefined behaviour in C++), float32 sums in float32
template <typename A> struct SumWork { using type = A; };
template <> struct SumWork<int32_t> { using type = uint32_t; };

__device__ __forceinline__ long long clip(long long x, long long cap) {
  return x < 0 ? 0 : (x > cap ? cap : x);
}

// kSums = false (no window, C = 0: ring_append) compiles the append blocks
// alone, so the window part's registers do not cap the append's occupancy
template <typename W, typename A, bool kSums>
__global__ void __launch_bounds__(kThreads)
append_sum_kernel(A* __restrict__ ring, const W* __restrict__ blk,
                  const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ rstart0,
                  const int32_t* __restrict__ rlen, A* __restrict__ out,
                  int KP, long long cap, int Rb, int C, int slide,
                  int append_blocks, bool vec) {
  using T = typename SumWork<A>::type;
  __shared__ __align__(16) W buf[kWarps][WarpAppend<W, A>::kBufCells];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!kSums || (int)blockIdx.x < append_blocks) {   // uniform per block
    append_warp<W, A>(ring, blk, offs, KP, cap, Rb, vec,
                      (long long)blockIdx.x * kWarps + warp, lane,
                      buf[warp]);
    return;
  }
  // windows i0 .. i0 + kWinPerWarp - 1 of row r
  const int groups = (C + kWinPerWarp - 1) / kWinPerWarp;
  const long long gw =
      (long long)(blockIdx.x - append_blocks) * kWarps + warp;
  if (gw >= (long long)KP * groups) return;   // uniform across the warp
  const int r = (int)(gw / groups);
  const int i0 = (int)(gw % groups) * kWinPerWarp;
  const A* row = ring + (long long)r * cap;
  const W* blk_row = blk + (long long)r * Rb;
  const int o = Rb > 0 ? offs[r] : 0;
  const long long o_end = (long long)o + Rb;
  const long long s0 = rstart0[r];
  const int len = rlen[r];
  int s[kWinPerWarp], e[kWinPerWarp];
  T acc[kWinPerWarp];
  int longest = 0;
#pragma unroll
  for (int j = 0; j < kWinPerWarp; ++j) {
    s[j] = (int)clip(s0 + (long long)(i0 + j) * slide, cap);
    e[j] = i0 + j < C ? (int)clip((long long)s[j] + len, cap) : s[j];
    longest = e[j] - s[j] > longest ? e[j] - s[j] : longest;
    acc[j] = 0;
  }
  // kUnroll cells a lane per window: every load of a batch is issued
  // before the first add waits on one
  const int trips = (longest + 31) / 32;
  for (int t0 = 0; t0 < trips; t0 += kUnroll) {
    A v[kWinPerWarp][kUnroll];
#pragma unroll
    for (int j = 0; j < kWinPerWarp; ++j) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = s[j] + lane + 32 * (t0 + u);
        if (c < e[j]) {
          v[j][u] = (c >= o && c < o_end)
                        ? widen<A, W>(__ldg(blk_row + (c - o)))
                        : row[c];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kWinPerWarp; ++j) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s[j] + lane + 32 * (t0 + u) < e[j]) acc[j] += (T)v[j][u];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kWinPerWarp; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
  }
#pragma unroll
  for (int j = 0; j < kWinPerWarp; ++j) {
    if (lane == j && i0 + j < C) out[(long long)r * C + i0 + j] = (A)acc[j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename W, typename A>
int launch_append_sum(void* ring, const void* blk, const int32_t* offs,
                      const int32_t* rstart0, const int32_t* rlen, void* out,
                      int KP, long long cap, int Rb, int C, int slide,
                      cudaStream_t st) {
  const bool vec = Rb > 0 && Rb % kChunk == 0 && aligned16(ring)
                   && aligned16(blk);
  const long long append_warps =
      (long long)KP * ((Rb + kWarpCells - 1) / kWarpCells);
  const long long window_warps =
      (long long)KP * ((C + kWinPerWarp - 1) / kWinPerWarp);
  const long long append_blocks = (append_warps + kWarps - 1) / kWarps;
  const long long blocks =
      append_blocks + (window_warps + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto kernel = C > 0 ? append_sum_kernel<W, A, true>
                            : append_sum_kernel<W, A, false>;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<A*>(ring), static_cast<const W*>(blk), offs, rstart0,
      rlen, static_cast<A*>(out), KP, cap, Rb, C, slide, (int)append_blocks,
      vec);
  return (int)cudaGetLastError();
}

// dispatch a launcher over the wire x accumulate pair
template <template <typename, typename> class L, typename... Args>
int dispatch(int wire, int acc, Args... args) {
  if (acc != A_INT32 && acc != A_FLOAT32) return (int)cudaErrorInvalidValue;
  const bool i = acc == A_INT32;
  switch (wire) {
    case W_INT8:
      return i ? L<int8_t, int32_t>::run(args...)
               : L<int8_t, float>::run(args...);
    case W_INT16:
      return i ? L<int16_t, int32_t>::run(args...)
               : L<int16_t, float>::run(args...);
    case W_INT32:
      return i ? L<int32_t, int32_t>::run(args...)
               : L<int32_t, float>::run(args...);
    case W_FLOAT32:
      return i ? L<float, int32_t>::run(args...)
               : L<float, float>::run(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename W, typename A> struct AppendSumL {
  template <typename... Args> static int run(Args... args) {
    return launch_append_sum<W, A>(args...);
  }
};

}  // namespace

// Appends the (KP, Rb) rectangle `blk` (wire dtype) into the (KP, cap) ring
// (acc dtype) at per-row offsets `offs` (int32), on `stream`: the fused
// kernel with no window (C = 0), so only its append blocks run.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int wf_ring_append(void* ring, const void* blk, const void* offs,
                              int KP, long long cap, int Rb, int wire,
                              int acc, void* stream) {
  if (KP <= 0 || Rb <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<AppendSumL>(wire, acc, ring, blk,
                              static_cast<const int32_t*>(offs), nullptr,
                              nullptr, nullptr, KP, cap, Rb, 0, 0,
                              static_cast<cudaStream_t>(stream));
}

// Appends the rectangle as wf_ring_append does, then writes the (KP, C)
// regular window sums of the ring after the append into `out` (acc dtype):
// window i of row r starts at rstart0[r] + i*slide with length rlen[r]
// (both int32).  One launch on `stream`.  Rb = 0 (blk and offs unused, may
// be null) gives the window sums alone.  Returns cudaGetLastError().
extern "C" int wf_ring_append_regular_sum(void* ring, const void* blk,
                                          const void* offs,
                                          const void* rstart0,
                                          const void* rlen, void* out,
                                          int KP, long long cap, int Rb,
                                          int C, int slide, int wire,
                                          int acc, void* stream) {
  if (KP <= 0 || cap <= 0 || cap > kMaxCap || Rb < 0 || C < 0) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch<AppendSumL>(
      Rb > 0 ? wire : (int)W_INT8, acc, ring, blk,
      static_cast<const int32_t*>(offs), static_cast<const int32_t*>(rstart0),
      static_cast<const int32_t*>(rlen), out, KP, cap, Rb, C, slide,
      static_cast<cudaStream_t>(stream));
}
