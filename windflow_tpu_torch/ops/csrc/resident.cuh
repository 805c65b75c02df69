// Kernels of the device-resident ring archive, for sm_90a: the device code
// shared by the translation units of the library (resident.cu, and
// resident_ring.cu once for each ring dtype; ops/ring.py builds them in
// parallel and links them into one library).
//
// One kernel body, append_sum_kernel, replaces the XLA-jitted device
// bodies of windflow_tpu/ops/resident.py:
//  * ring_append_regular_sum: the whole of _regular_body (:183-199) in
//    one launch, as the JAX step is one jitted step: the append, then the
//    regular window sums (there a ring-wide cumsum + two-point gather,
//    here direct window sums).  With an empty rectangle (Rb = 0) it gives
//    the window sums alone;
//  * ring_append: the vmapped dynamic_update_slice + astype of
//    _ring_append (:234-240): the same kernel with no window (C = 0),
//    instantiated without its window part (kSums = false).  An
//    instantiation that kept it, and so its registers, measured 7-8%
//    slower at both of ring_append's main-path shapes on the H100
//    (PERF.md).
// A second kernel body, append_eval_kernel, replaces the other jitted
// body of the single-ring step:
//  * ring_append_eval: the whole of _append_eval (:260-269; built by
//    _make_step :272 and, on every kf shard, _make_mesh_step :285) in one
//    launch: the append, then every op of the dispatch over (row, start,
//    len) window descriptors of the ring after it (_ring_eval :243).
// A third, multi_eval_kernel (at the end; its notes in resident.cu),
// replaces _make_multi_step.
//
// Dtypes.  A ring holds int8, int16, int32, int64, uint8, uint16,
// uint32, uint64, float16, float32 or float64 cells (enum Acc); the
// rectangle comes in the wire dtype the JAX package's narrowing ladder
// picks for it (enum Wire; the ladder ships signed wires only): int8,
// int16, int32 or float32 into a ring of 1-4 byte cells, int8, int16,
// int32, int64 or float64 into a ring of 8-byte cells, 47 (wire, ring)
// pairs in all (wire_ok below).  A wire wider than the ring, or a signed
// wire into an unsigned ring, wraps as XLA's astype does; a float wire
// into an integer ring truncates toward zero, saturating at the ring's
// range, NaN to 0; any wire into a float16 ring rounds to nearest even
// (XLA's conversions).  Integer sums and products run in uint32 (rings
// of 1-4 byte cells) or uint64 (8-byte rings) and wrap: a sum is written
// in the ring dtype (modulo 2^8 for an int8 ring, as the JAX cumsum of an
// int8 ring wraps), a product of an int8 or int16 ring as int32 and of a
// uint8 or uint16 ring as uint32 (jnp.prod promotes them to the default
// int of their kind without x64), every other result in the ring dtype;
// min and max compare in int32 or int64, in uint32 or uint64 for an
// unsigned ring, or in the float type.  A float16 ring is reduced in
// float and each result rounded to float16 once (__float2half_rn), the
// rule of cells.cuh; a window sum adds its cells, where JAX takes a
// difference of two float16 prefix sums (a recorded divergence).  A long
// window's chunk partials are kept in that working type (4 or 8 bytes).
// The ring kernels are compiled for every pair: resident_ring.cu holds
// append_sum_kernel and append_eval_kernel for the wires of one ring
// dtype (eleven objects built in parallel), resident.cu the multi kernel
// and the C entry points.
//
// The irregular evaluation.  For window w < B, with len = min(lens[w],
// pad) (0 if negative) and s = max(starts[w], 0), and each op e:
//     out_e[w] = op-reduce of ring'[rows[w], min(s + j, cap - 1)], j < len
// (the identity for an empty window; count writes lens[w]; float min and
// max propagate NaN).  A cell inside the rectangle [offs[r], offs[r] +
// Rb) is read from blk and widened, any other from the ring, as in the
// regular sums: no block reads a cell this launch writes, so the launch
// needs no grid sync.
// Order.  With a = (rows[w]*cap + s) mod 4, cell j lies in the window's
// group (a + j) / 4 of 4 cells (groups aligned in the ring: 16 bytes of a
// 4-byte ring, 4 of an int8 ring, 32 of an 8-byte ring), whatever the
// dtype.
//  * A window of len <= split cells is reduced by a team of 8 lanes (a
//    warp takes 4 windows): lane g mod 8 takes group g and combines its
//    cells in ascending j from the identity; then a butterfly of
//    __shfl_xor_sync over 4, 2, 1, each lane its own value first.  That
//    is windowed_reduce's order (ops/windowed_reduce.py lane_order_twin).
//  * A longer window is cut into chunks of `chunk` cells, chunk c holding
//    groups [c*chunk/4, (c+1)*chunk/4); each chunk is reduced in the
//    team's order and the chunk partials are folded in chunk order from
//    the identity (ops/ring.py append_eval_order_twin reproduces both).
// Only float sums and products depend on the order: integer results and
// float min and max are the same in any.
// Design.  One launch, three kinds of block.  The first take the long
// windows' chunks, 32 a block (a team a chunk), so a few windows of
// ~330k cells (YSB's 10 s TB windows) spread over the whole card instead
// of one block's 8 lanes a window (windowed_reduce's design, which made
// such a launch one block on one SM).  The host lists the long windows
// and their first chunks (it holds the descriptors); a team finds its
// window by a binary search of that list.  Each team writes its chunk's
// partial to scratch; the block then adds, for each window it touched,
// its chunks to the window's counter (after a __threadfence), and the
// block that completes a window resets its counter and folds the
// window's partials, a warp a (window, op): the partials are staged in
// shared memory from L2 and lane 0 folds them in chunk order.  The
// counters are zero between launches, so the launch leaves no state.
// Then short blocks take 64 windows each (a team a window, skipping the
// long ones), and the last blocks are the append's.
// A lane loads a group of the ring with one vector load (two 16-byte
// loads for 8-byte cells) where the whole group lies in the window, in
// the row and outside the rectangle, a group inside the rectangle as 4
// cells of blk (one load where they are aligned), and any other cell by
// cell (the window's first and last groups, clamped columns, groups cut
// by the rectangle's ends), combining in the same order either way.  The
// launch bounds ask for 4 resident blocks an SM (at most 64 registers a
// thread; without them the int32 instantiations took 121-125).  Split and
// chunk are arguments (ops/ring.py LONG_SPLIT = 512, LONG_CHUNK = 512).
// Measured on the H100 (scripts/torch_append_eval_sweep.py, PERF.md):
// split 512 against 2048 took 2.7x less at 1,024 windows of 1k-8k cells
// (64 windows a short block left most SMs idle); chunks of 1024 cells
// were 9% faster at YSB's 10 s windows and 128 cells 36% faster at its
// deterministic ones, 512 the best of one size for both; 4 blocks an SM
// and the rectangle's whole groups read in one go took 34% less at the
// 1k-8k windows, within 5% at the other shapes.
// Bound, by bytes: blk read once, the rectangle written once, the ring
// cells the windows cover outside the rectangle read once, the 3*B int32
// descriptors and KP offsets, and the B outputs an op written once.
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
// every 4-cell group between them with one aligned store (4, 8, 16 bytes,
// or two 16-byte stores for 8-byte cells), group g taking row cells
// h+4g .. h+4g+3.  Lane l of the warp stores groups 32q + l (q = 0..3) of
// its chunk, read back from shared memory and widened in registers, so
// each store instruction writes 128 consecutive cells.  The chunk's last
// groups reach h cells into the next chunk, which the warp also loads
// (16 cells, an L2 hit: that chunk's warp loads them too).  A rectangle
// whose Rb is not a multiple of 16, or a ring or blk not 16-byte aligned,
// takes a per-cell path inside the kernel (lane l moves cells l, l+32,
// ... of the chunk).
// Bound on an H100 SXM (3.35 TB/s), by bytes: read KP*Rb*sizeof(Wire) and
// KP*4 offsets, write KP*Rb*sizeof(Acc).
//
// The regular window sums.  For r < KP and i < C:
//     s = clip(rstart0[r] + i*slide, 0, cap), e = clip(s + rlen[r], 0, cap)
//     out[r, i] = sum(ring'[r, s:e])      (rlen >= 0)
// where ring' is the ring after the append.
// Design: one launch, two kinds of block.  The first blocks append the
// rectangle, a warp per 512-cell chunk (with C = 0 they are the whole
// launch: ring_append).  The others sum the windows, a warp per 2
// consecutive windows of one row: lane l adds cells s+l, s+l+32, ... of
// each window, loading 8 of them a window before the first add (16 loads
// in flight a lane: one memory round trip for a 256-cell window), then a
// butterfly of __shfl_xor_sync over 16, 8, 4, 2, 1.  A cell inside the
// rectangle [offs[r], offs[r] + Rb) is read from blk (1 byte for an int8
// wire) and widened, a cell outside it from the ring.  So the appended
// cells make no round trip through device memory, and no warp reads a
// ring cell that this launch writes: the blocks need no ordering and no
// grid sync.  Overlapping windows re-read their cells from L1/L2.  (A
// design that staged each block's span of windows in shared memory
// measured slower on the H100: a barrier and two dependent phases a
// block, and the register pressure of keeping every load in flight;
// PERF.md.)
// Order: every path adds in the order above, so two launches agree bit
// for bit.  Integer sums wrap (see Dtypes): that is bit for bit the
// cumsum difference XLA computes.  Float sums round differently from a
// cumsum difference; the tests hold them to a stated tolerance.
// Bound, by bytes: blk read once, the rectangle written once, the ring
// cells the windows cover outside the rectangle read once, the 3*KP int32
// descriptors, the (KP, C) sums written once.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace wf {

enum Wire {
  W_INT8 = 0, W_INT16 = 1, W_INT32 = 2, W_FLOAT32 = 3, W_INT64 = 4,
  W_FLOAT64 = 5
};
enum Acc {
  A_INT32 = 0, A_FLOAT32 = 1, A_INT8 = 2, A_INT16 = 3, A_INT64 = 4,
  A_FLOAT64 = 5, A_UINT8 = 6, A_UINT16 = 7, A_UINT32 = 8, A_UINT64 = 9,
  A_FLOAT16 = 10
};
enum Op { OP_SUM = 0, OP_COUNT = 1, OP_MIN = 2, OP_MAX = 3, OP_PROD = 4 };

using i64 = long long;
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                 // cells a thread appends
constexpr int kWarpCells = 32 * kChunk;    // cells a warp appends
constexpr int kWinPerWarp = 2;             // windows a warp sums
constexpr int kUnroll = 8;                 // loads in flight a lane a window
// row-local cell indices of the window sums are int: the C entry refuses
// longer rows
constexpr long long kMaxCap = 1LL << 30;

constexpr int kMaxEvals = 8;               // evaluations a launch
constexpr int kGroup = 4;                  // cells of a group
constexpr int kLanes = 8;                  // lanes of a team
constexpr int kTeams = kThreads / kLanes;  // teams (chunks) of a long block
constexpr int kEvalWindows = 64;           // windows of a short block
constexpr int kGroupUnroll = 4;            // groups in flight a lane
constexpr int kFoldBytes = 2048;           // partials a warp stages a round
constexpr int kEvalMinBlocks = 4;          // launch bounds: blocks an SM
constexpr int kBlkGroups = 1;              // whole groups of blk in one go
constexpr int kMaxFields = 8;              // rings of a multi launch

// shared staging of a block: the append's units of a W wire, or a long
// block's folds
template <typename W>
constexpr int kStageBytes =
    kWarps * (kWarpCells + kChunk) * (int)sizeof(W) > kWarps * kFoldBytes
        ? kWarps * (kWarpCells + kChunk) * (int)sizeof(W)
        : kWarps * kFoldBytes;

// One field of ring_append_multi_eval: its (KP, cap) ring and (KP, Rb)
// rectangle, their dtypes, and whether the window loads (vec) and the
// append (avec) take their vector paths.
struct FieldRing {
  void* ring;
  const void* blk;
  int wire, acc;
  bool vec, avec;
};

struct AppendEval {
  void* ring;
  const void* blk;
  const int32_t* offs;
  const int32_t* rows;
  const int32_t* starts;
  const int32_t* lens;
  const int32_t* long_win;    // the n_long long windows
  const int32_t* long_first;  // each one's first chunk; [n_long] = chunks
  int32_t* counters;          // chunks done a long window: 0 between launches
  void* out[kMaxEvals];       // B results, in the op's output dtype
  void* part[kMaxEvals];      // the chunks' partials, in its working dtype
  int out_bytes[kMaxEvals];   // sizes of those two dtypes
  int part_bytes[kMaxEvals];
  int op[kMaxEvals];
  u64 ident[kMaxEvals];       // the identity's bits in the working dtype
  long long cap;
  int n_evals, KP, Rb, B, pad, n_long, chunks, split;
  int chunk;                  // groups a chunk, a multiple of kLanes
  int long_blocks, short_blocks;
  bool vec;                   // the ring 16-byte aligned (window loads)
  bool avec;                  // the append's vector path
  // ring_append_multi_eval only: a ring a field, evaluation e reading
  // field src[e]; the (B, pad) tiles of fields tile_src[t] and the mask
  FieldRing field[kMaxFields];
  int n_fields;
  int src[kMaxEvals];
  void* tile[kMaxFields];
  int tile_src[kMaxFields];
  int n_tiles;
  bool* mask;
  int tile_runs;              // blocks a window's tiles take
  int tile_blocks;
  int append_blocks;          // append blocks a field
};

// the ring type of an Acc code
template <int ACC> struct AccOf;
template <> struct AccOf<A_INT32> { using type = int32_t; };
template <> struct AccOf<A_FLOAT32> { using type = float; };
template <> struct AccOf<A_INT8> { using type = int8_t; };
template <> struct AccOf<A_INT16> { using type = int16_t; };
template <> struct AccOf<A_INT64> { using type = i64; };
template <> struct AccOf<A_FLOAT64> { using type = double; };
template <> struct AccOf<A_UINT8> { using type = uint8_t; };
template <> struct AccOf<A_UINT16> { using type = uint16_t; };
template <> struct AccOf<A_UINT32> { using type = uint32_t; };
template <> struct AccOf<A_UINT64> { using type = u64; };
template <> struct AccOf<A_FLOAT16> { using type = __half; };

template <typename A>
constexpr bool kIsHalf = std::is_same<A, __half>::value;

// Calls fn(W{}) with the wire type of code `wire` among those a ring of A
// cells takes (an unknown code takes the last: the entry points refuse
// them first, wire_ok).
#pragma nv_exec_check_disable
template <typename A, typename F>
__host__ __device__ __forceinline__ auto for_wire(int wire, F&& fn) {
  if constexpr (sizeof(A) == 8) {
    switch (wire) {
      case W_INT8: return fn(int8_t{});
      case W_INT16: return fn(int16_t{});
      case W_INT32: return fn(int32_t{});
      case W_INT64: return fn(i64{});
      default: return fn(double{});
    }
  } else {
    switch (wire) {
      case W_INT8: return fn(int8_t{});
      case W_INT16: return fn(int16_t{});
      case W_INT32: return fn(int32_t{});
      default: return fn(float{});
    }
  }
}

// Calls fn(A{}) with the ring type of code `acc` (an unknown code takes
// float64: the entry points refuse them first).
#pragma nv_exec_check_disable
template <typename F>
__host__ __device__ __forceinline__ auto with_acc(int acc, F&& fn) {
  switch (acc) {
    case A_INT32: return fn(int32_t{});
    case A_FLOAT32: return fn(float{});
    case A_INT8: return fn(int8_t{});
    case A_INT16: return fn(int16_t{});
    case A_INT64: return fn(i64{});
    case A_UINT8: return fn(uint8_t{});
    case A_UINT16: return fn(uint16_t{});
    case A_UINT32: return fn(uint32_t{});
    case A_UINT64: return fn(u64{});
    case A_FLOAT16: return fn(__half{});
    default: return fn(double{});
  }
}

// Calls fn(W{}, A{}) with the wire and ring types of the codes: the
// run-time switch into the templated helpers (a block calls it with one
// field's codes, so the switch is uniform across it).
template <typename F>
__device__ __forceinline__ void with_types(int wire, int acc, F&& fn) {
  with_acc(acc, [&](auto a) {
    using A = decltype(a);
    for_wire<A>(wire, [&](auto w) { fn(w, a); });
  });
}

// whether a ring of code acc takes a rectangle of code wire
inline bool is_wide(int acc) {
  return acc == A_INT64 || acc == A_FLOAT64 || acc == A_UINT64;
}

inline bool wire_ok(int wire, int acc) {
  if (acc < A_INT32 || acc > A_FLOAT16) return false;
  const bool wide = is_wide(acc);
  return wide ? (wire == W_INT8 || wire == W_INT16 || wire == W_INT32 ||
                 wire == W_INT64 || wire == W_FLOAT64)
              : (wire >= W_INT8 && wire <= W_FLOAT32);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// bytes of an output and of a partial of op over a ring of code acc
// (Out and Work below)
inline int out_bytes_of(int op, int acc) {
  const int cell = (acc == A_INT8 || acc == A_UINT8) ? 1
                 : (acc == A_INT16 || acc == A_UINT16 || acc == A_FLOAT16)
                     ? 2
                 : is_wide(acc) ? 8 : 4;
  return op == OP_PROD && cell < 4 && acc != A_FLOAT16 ? 4 : cell;
}
inline int part_bytes_of(int acc) { return is_wide(acc) ? 8 : 4; }

// per ring dtype launchers, instantiated in resident_ring.cu, an object a
// ring dtype
template <int ACC>
int append_sum_for(int wire, void* ring, const void* blk,
                   const int32_t* offs, const int32_t* rstart0,
                   const int32_t* rlen, void* out, int KP, long long cap,
                   int Rb, int C, int slide, cudaStream_t st);
template <int ACC>
int append_eval_for(int wire, AppendEval p, cudaStream_t st);
// multi_eval_kernel<true> (any ring dtype) on `blocks` blocks with `stage`
// bytes of shared memory (resident_multi.cu)
int launch_multi_any(const AppendEval& p, unsigned blocks, int stage,
                     cudaStream_t st);
// One evaluation (op p.op[e]) of groups [gb, ge) of window (r, s, len) of
// field f's ring by a team (FieldRings<true>), its rectangle of W cells
// into a ring of A cells: eval_span, a function of its own for each of the
// 47 pairs, defined in resident_field.cu (an object a ring dtype, built
// with relocatable device code: resident_multi.cu calls them).
template <typename W, typename A>
__device__ void field_eval(const AppendEval& p, int e, const FieldRing& f,
                           int r, long long s, int len, int gb, int ge, int q,
                           void* dst, bool part);

namespace {

// ------------------------------------------------------------- the cells

// the wire value v widened (or wrapped) to the ring's type A
template <typename A, typename W>
__device__ __forceinline__ A widen(W v) {
  if constexpr (kIsHalf<A>) {
    // any wire into a float16 ring: to nearest even (an int32 past 65504
    // is inf, as XLA's convert gives it)
    if constexpr (std::is_floating_point<W>::value) {
      return __float2half_rn((float)v);
    } else {
      return __int2half_rn((int)v);
    }
  } else if constexpr (std::is_floating_point<W>::value &&
                       std::is_unsigned<A>::value) {
    // a float wire into an unsigned ring: toward zero, saturating at 0
    // and at the ring's max, NaN to 0
    constexpr A kMax = (A)~A(0);
    constexpr double kTop = (double)kMax + 1.0;
    if (!(v > W(0))) return 0;    // NaN, negatives and -0
    if ((double)v >= kTop) return kMax;
    if constexpr (sizeof(A) == 8) {
      return (A)__double2ull_rz((double)v);
    } else if constexpr (sizeof(W) == 8) {
      return (A)__double2uint_rz((double)v);
    } else {
      return (A)__float2uint_rz((float)v);
    }
  } else if constexpr (std::is_floating_point<W>::value &&
                       std::is_integral<A>::value) {
    // a float wire into an integer ring: toward zero, saturating, NaN to 0
    // (a C++ cast is undefined out of range)
    if (v != v) return 0;
    if constexpr (sizeof(A) == 8) {
      return (A)__double2ll_rz((double)v);
    } else {
      const int x = sizeof(W) == 8 ? __double2int_rz((double)v)
                                   : __float2int_rz((float)v);
      if constexpr (sizeof(A) == 4) {
        return (A)x;
      } else {
        constexpr int hi = (1 << (8 * (int)sizeof(A) - 1)) - 1;
        return (A)(x < -hi - 1 ? -hi - 1 : (x > hi ? hi : x));
      }
    }
  } else {
    return (A)v;
  }
}

// 4 consecutive cells of T at p (aligned to 4 * sizeof(T)) in one load,
// two 16-byte loads for 8-byte cells
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&x)[4]) {
  constexpr int kBytes = 4 * (int)sizeof(T);
  if constexpr (kBytes == 4) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
    memcpy(x, &u, kBytes);
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(x, &u, kBytes);
  } else if constexpr (kBytes == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(x, &u, kBytes);
  } else {
    uint4 u[2];
    u[0] = __ldg(reinterpret_cast<const uint4*>(p));
    u[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    memcpy(x, u, kBytes);
  }
}

// the same, a store
template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&x)[4]) {
  constexpr int kBytes = 4 * (int)sizeof(T);
  if constexpr (kBytes == 4) {
    uint32_t u;
    memcpy(&u, x, kBytes);
    *reinterpret_cast<unsigned int*>(p) = u;
  } else if constexpr (kBytes == 8) {
    uint2 u;
    memcpy(&u, x, kBytes);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (kBytes == 16) {
    uint4 u;
    memcpy(&u, x, kBytes);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    uint4 u[2];
    memcpy(u, x, kBytes);
    reinterpret_cast<uint4*>(p)[0] = u[0];
    reinterpret_cast<uint4*>(p)[1] = u[1];
  }
}

template <typename A>
__device__ __forceinline__ void put(A* row, long long c, long long cap,
                                    A v) {
  if (c >= 0 && c < cap) row[c] = v;
}

// ------------------------------------------------------------ the append

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
        const A a[4] = {widen<A, W>(b[0]), widen<A, W>(b[1]),
                        widen<A, W>(b[2]), widen<A, W>(b[3])};
        const long long c = o + h + 4 * g;
        if (c >= 0 && c + 4 <= cap) {
          store4<A>(row + c, a);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) put(row, c + k, cap, a[k]);
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

// ---------------------------------------------------- the regular sums

// working type of a sum or product: integers wrap in uint32 (rings of 1-4
// byte cells) or uint64 (signed overflow is undefined behaviour in C++);
// min and max compare in int32 or int64, unsigned rings in uint32 or
// uint64; float16 works in float, other floats stay in their type
template <int OP, typename A>
struct Work {
  static constexpr bool kWrap = OP == OP_SUM || OP == OP_PROD;
  static constexpr bool kUnsigned = kWrap || std::is_unsigned<A>::value;
  using type = std::conditional_t<
      kIsHalf<A>, float,
      std::conditional_t<
          !std::is_integral<A>::value, A,
          std::conditional_t<sizeof(A) == 8,
                             std::conditional_t<kUnsigned, u64, i64>,
                             std::conditional_t<kUnsigned, uint32_t,
                                                int32_t>>>>;
};

// output type: a product of int8 or int16 cells is int32 and of uint8 or
// uint16 cells uint32 (jnp.prod promotes them), every other result the
// ring's type
template <int OP, typename A>
struct Out {
  using type = std::conditional_t<
      OP == OP_PROD && std::is_integral<A>::value && sizeof(A) < 4,
      std::conditional_t<std::is_unsigned<A>::value, uint32_t, int32_t>, A>;
};

// a working value as the output type O (float16 rounded once, to nearest
// even; an integer keeps its low bits)
template <typename O, typename T>
__device__ __forceinline__ O to_out(T x) {
  if constexpr (kIsHalf<O>) {
    return __float2half_rn(x);
  } else {
    return (O)x;
  }
}

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
  using T = typename Work<OP_SUM, A>::type;
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
    if (lane == j && i0 + j < C) {
      out[(long long)r * C + i0 + j] = to_out<A>(acc[j]);
    }
  }
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

// ----------------------------------------------- the window evaluations

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  if constexpr (std::is_floating_point<T>::value) {
    return x != x;
  } else {
    return false;
  }
}

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
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

// the value whose bits are the low sizeof(T) bytes of w
template <typename T>
__device__ __forceinline__ T from_word(u64 w) {
  T v;
  memcpy(&v, &w, sizeof(v));
  return v;
}

// One window of ring row r: cells j = 0 .. len - 1 at columns min(s + j,
// cap - 1); a column inside the rectangle [o, o_end) is read from blk and
// widened, any other from the ring.  `a` is the flat index of column s
// mod 4: cell j lies in the window's group (a + j) / 4.
template <typename W, typename A>
struct Window {
  const A* row;
  const W* brow;
  long long o, o_end, s, last;
  int a, len;

  __device__ __forceinline__ int groups() const {
    return (int)(((long long)a + len + kGroup - 1) / kGroup);
  }
  __device__ __forceinline__ A cell(long long c) const {
    c = c < last ? c : last;
    return c >= o && c < o_end ? widen<A, W>(__ldg(brow + (c - o)))
                               : __ldg(row + c);
  }
};

// window (r, s, len) of the ring `ring` whose rectangle is `blk`
template <typename W, typename A>
__device__ __forceinline__ Window<W, A> window_of(const void* ring,
                                                   const void* blk,
                                                   const AppendEval& p, int r,
                                                   long long s, int len) {
  const long long base = (long long)r * p.cap;
  Window<W, A> c;
  c.row = static_cast<const A*>(ring) + base;
  c.brow = static_cast<const W*>(blk) + (long long)r * p.Rb;
  c.o = p.Rb > 0 ? p.offs[r] : 0;
  c.o_end = c.o + p.Rb;
  c.s = s;
  c.last = p.cap - 1;
  c.a = (int)((base + s) & 3);
  c.len = len;
  return c;
}

// Group g of a window: its 4 cells into v; returns the mask of the cells
// that lie in the window (bit k: cell 4g + k - a).  A whole group inside
// the window and the row takes one load from the ring where it lies
// outside the rectangle, or 4 cells of blk where it lies inside it (one
// load where they are aligned); any other group loads the window's cells
// alone.
template <typename W, typename A>
__device__ __forceinline__ unsigned load_group(const Window<W, A>& c,
                                               bool vec, int g,
                                               A (&v)[kGroup]) {
  const long long j0 = (long long)kGroup * g - c.a;
  const long long c0 = c.s + j0;
  if (j0 >= 0 && j0 + kGroup <= c.len && c0 + kGroup - 1 <= c.last) {
    if (c0 + kGroup <= c.o || c0 >= c.o_end) {
      if (vec) {
        load4<A>(c.row + c0, v);
        return 0xfu;
      }
    } else if (kBlkGroups && c0 >= c.o && c0 + kGroup <= c.o_end) {
      const W* b = c.brow + (c0 - c.o);
      W x[kGroup];
      if ((reinterpret_cast<uintptr_t>(b) & (sizeof(W) * kGroup - 1)) == 0) {
        load4<W>(b, x);
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) x[k] = __ldg(b + k);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) v[k] = widen<A, W>(x[k]);
      return 0xfu;
    }
  }
  unsigned live = 0u;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const long long j = j0 + k;
    v[k] = A(0);
    if (j >= 0 && j < c.len) {
      v[k] = c.cell(c.s + j);
      live |= 1u << k;
    }
  }
  return live;
}

// Lane q's part of groups [gb, ge) of a window (gb a multiple of kLanes):
// groups gb + q, gb + q + kLanes, ... in ascending order, each group's
// cells in ascending order, combined into acc.
template <int OP, typename T, typename W, typename A>
__device__ __forceinline__ T fold_span(const Window<W, A>& c, bool vec,
                                       int gb, int ge, int q, T acc) {
  for (int g1 = gb + q; g1 < ge; g1 += kLanes * kGroupUnroll) {
    A v[kGroupUnroll][kGroup];
    unsigned live[kGroupUnroll];
#pragma unroll
    for (int i = 0; i < kGroupUnroll; ++i) {
      const int g = g1 + kLanes * i;
      live[i] = g < ge ? load_group<W, A>(c, vec, g, v[i]) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kGroupUnroll; ++i) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (live[i] & (1u << k)) acc = combine<OP, T>(acc, (T)v[i][k]);
      }
    }
  }
  return acc;
}

// One evaluation of a span by its team of kLanes lanes: each lane's fold,
// then a butterfly over 4, 2, 1 (each lane combines its own value first)
// and lane 0 writes *dst (null: nothing): a chunk partial in the working
// type (`part`), or the window's result in the output type.  Every lane of
// the warp calls it.
template <int OP, typename W, typename A>
__device__ __forceinline__ void team_eval(const Window<W, A>& c, bool vec,
                                          int gb, int ge, int q, u64 ident,
                                          void* dst, bool part) {
  using T = typename Work<OP, A>::type;
  T acc = fold_span<OP, T, W, A>(c, vec, gb, ge, q, from_word<T>(ident));
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    acc = combine<OP, T>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (q == 0 && dst != nullptr) {
    if (part) {
      *static_cast<T*>(dst) = acc;
    } else {
      using O = typename Out<OP, A>::type;
      *static_cast<O*>(dst) = to_out<O>(acc);
    }
  }
}

template <typename W, typename A>
__device__ __forceinline__ void eval_span(int op, const Window<W, A>& c,
                                          bool vec, int gb, int ge, int q,
                                          u64 ident, void* dst, bool part) {
  switch (op) {
    case OP_SUM:
      team_eval<OP_SUM, W, A>(c, vec, gb, ge, q, ident, dst, part);
      break;
    case OP_MIN:
      team_eval<OP_MIN, W, A>(c, vec, gb, ge, q, ident, dst, part);
      break;
    case OP_MAX:
      team_eval<OP_MAX, W, A>(c, vec, gb, ge, q, ident, dst, part);
      break;
    default:
      team_eval<OP_PROD, W, A>(c, vec, gb, ge, q, ident, dst, part);
      break;
  }
}

// where evaluation e writes window w's result, and chunk k's partial
__device__ __forceinline__ void* out_at(const AppendEval& p, int e,
                                        long long w) {
  return static_cast<char*>(p.out[e]) + w * p.out_bytes[e];
}
__device__ __forceinline__ void* part_at(const AppendEval& p, int e,
                                         long long k) {
  return static_cast<char*>(p.part[e]) + k * p.part_bytes[e];
}

// A short block: items [64 b, 64 b + 64), a team an item, 4 a warp at a
// time.  An item is a window whose team evaluates every stat or, where
// S::kStatItems, one (stat, window) pair, stat-major (item g * B4 + w is
// stat g of window w, B4 = B rounded up to 4, so the 4 teams of a warp
// share their stat, and so the switch on its types); items of windows
// past B reduce nothing.  A window longer than `split` is left to the
// long blocks; count writes lens[w] for every window.  S says where an
// evaluation reads (OneRing, FieldRings below).  It and long_chunks are
// forced inline: compiled as relocatable device code (the library is),
// the compiler kept them functions of their own that the kernel called,
// and the per-field kernel spilled and took 52% more at a MultiReducer
// launch on the H100.
template <class S>
__device__ __forceinline__ void short_windows(const AppendEval& p, int b) {
  __shared__ int s_row[kEvalWindows], s_start[kEvalWindows],
      s_len[kEvalWindows], s_count[kEvalWindows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % kLanes;
  const int B4 = (p.B + 3) & ~3;
  const long long items = S::kStatItems ? (long long)p.n_evals * B4 : B4;
  const long long i0 = (long long)b * kEvalWindows;
  // a multiple of 4: a warp's teams are all in or all out
  const int ni = (int)(items - i0 < kEvalWindows ? items - i0 : kEvalWindows);
  if (tid < ni) {
    const int w = (int)((i0 + tid) % B4);
    const bool live = w < p.B;
    const int count = live ? p.lens[w] : 0;
    s_row[tid] = live ? p.rows[w] : 0;
    s_start[tid] = live ? max(p.starts[w], 0) : 0;
    s_len[tid] = max(0, min(count, p.pad));
    s_count[tid] = count;
  }
  __syncthreads();
  constexpr int kPerWarp = 32 / kLanes;
  for (int k0 = warp * kPerWarp; k0 < ni; k0 += kWarps * kPerWarp) {
    const int k = k0 + lane / kLanes;
    const long long i = i0 + k;
    const int w = (int)(i % B4);
    const bool live = w < p.B;
    const int len = s_len[k];
    const bool mine = live && len <= p.split;
    const typename S::Win c = S::window(p, s_row[k], s_start[k],
                                        mine ? len : 0);
    const int e0 = S::kStatItems ? (int)(i / B4) : 0;
    const int e1 = S::kStatItems ? e0 + 1 : p.n_evals;
    for (int e = e0; e < e1; ++e) {
      if (p.op[e] == OP_COUNT) {
        if (live && q == 0) S::count(p, e, out_at(p, e, w), s_count[k]);
        continue;
      }
      S::eval(p, e, c, 0, c.groups(), q, mine ? out_at(p, e, w) : nullptr,
              false);
    }
  }
}

// Lane 0 of a warp folds the n chunk partials of one long window in chunk
// order from the identity; the warp stages them in `buf` (kFoldBytes at a
// time, read from L2: other blocks wrote them) and lane 0 writes *dst in
// the output type.
template <int OP, typename A>
__device__ __forceinline__ void fold_chunks_op(const void* part_, int n,
                                               u64 ident, int lane,
                                               void* buf_, void* dst) {
  using T = typename Work<OP, A>::type;
  using O = typename Out<OP, A>::type;
  constexpr int kCells = kFoldBytes / (int)sizeof(T);
  const T* part = static_cast<const T*>(part_);
  T* buf = static_cast<T*>(buf_);
  T acc = from_word<T>(ident);
  for (int p0 = 0; p0 < n; p0 += kCells) {
    const int m = min(kCells, n - p0);
#pragma unroll
    for (int u = 0; u < kCells / 32; ++u) {
      const int j = 32 * u + lane;
      if (j < m) buf[j] = __ldcg(part + p0 + j);
    }
    __syncwarp();
    if (lane == 0) {
      int j = 0;
      for (; j + 8 <= m; j += 8) {
        T x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = buf[j + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = combine<OP, T>(acc, x[u]);
      }
      for (; j < m; ++j) acc = combine<OP, T>(acc, buf[j]);
    }
    __syncwarp();
  }
  if (lane == 0) *static_cast<O*>(dst) = to_out<O>(acc);
}

template <typename A>
__device__ __forceinline__ void fold_chunks(int op, const void* part, int n,
                                            u64 ident, int lane, void* buf,
                                            void* dst) {
  switch (op) {
    case OP_SUM:
      fold_chunks_op<OP_SUM, A>(part, n, ident, lane, buf, dst);
      break;
    case OP_MIN:
      fold_chunks_op<OP_MIN, A>(part, n, ident, lane, buf, dst);
      break;
    case OP_MAX:
      fold_chunks_op<OP_MAX, A>(part, n, ident, lane, buf, dst);
      break;
    default:
      fold_chunks_op<OP_PROD, A>(part, n, ident, lane, buf, dst);
      break;
  }
}

// Where an evaluation reads.  OneRing: ring_append_eval's one ring, its
// types fixed at compile time (a one-field ring_append_multi_eval, the
// same function in the same order, took 20% more at the max prefix's
// 8,192 windows of 256 cells and within 2.5% at the other shapes of
// scripts/torch_append_eval_sweep.py --one-field on the H100, PERF.md).
// FieldRings (resident.cu): evaluation e of ring_append_multi_eval reads
// the ring of field src[e], its types switched at run time.  S::window
// gives a window that S::eval reduces a span of (eval_span) and whose
// groups() it has; S::fold folds a long window's chunk partials
// (fold_chunks); S::count writes a window's count in the output type.
template <typename W, typename A>
struct OneRing {
  using Win = Window<W, A>;
  static constexpr bool kStatItems = false;
  __device__ static Win window(const AppendEval& p, int r, long long s,
                               int len) {
    return window_of<W, A>(p.ring, p.blk, p, r, s, len);
  }
  __device__ static void count(const AppendEval&, int, void* dst, int n) {
    *static_cast<A*>(dst) = (A)n;
  }
  __device__ static void eval(const AppendEval& p, int e, const Win& c,
                              int gb, int ge, int q, void* dst, bool part) {
    eval_span<W, A>(p.op[e], c, p.vec, gb, ge, q, p.ident[e], dst, part);
  }
  __device__ static void fold(const AppendEval& p, int e, const void* part,
                              int n, int lane, void* buf, void* dst) {
    fold_chunks<A>(p.op[e], part, n, p.ident[e], lane, buf, dst);
  }
};

// A long block: chunks [32 b, 32 b + 32) of the long windows' chunks, a
// team a chunk.  Each team writes its chunk's partials; then, for each long
// window the block touched, one thread adds the block's chunks of it to
// the window's counter, and the block that brings it to the window's
// chunk count resets it and folds the window.
template <class S>
__device__ __forceinline__ void long_chunks(const AppendEval& p, int b,
                            unsigned char* stage) {
  __shared__ int s_win[kTeams];    // each team's long window, -1: none
  __shared__ int s_fold[kTeams];   // the long windows this block folds
  __shared__ int s_nfold;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = tid / kLanes, q = tid % kLanes;
  const int k = b * kTeams + team;   // the team's chunk
  int i = -1;
  if (k < p.chunks) {              // its window: long_first[i] <= k
    int lo = 0, hi = p.n_long - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (p.long_first[mid] <= k) lo = mid; else hi = mid - 1;
    }
    i = lo;
  }
  if (tid == 0) s_nfold = 0;
  if (q == 0) s_win[team] = i;
  const int w = i >= 0 ? p.long_win[i] : 0;
  const typename S::Win c = S::window(
      p, i >= 0 ? p.rows[w] : 0, i >= 0 ? max(p.starts[w], 0) : 0,
      i >= 0 ? max(0, min(p.lens[w], p.pad)) : 0);
  const int gb = i >= 0 ? (k - p.long_first[i]) * p.chunk : 0;
  const int ge = i >= 0 ? min(gb + p.chunk, c.groups()) : 0;
  for (int e = 0; e < p.n_evals; ++e) {
    if (p.op[e] == OP_COUNT) continue;
    S::eval(p, e, c, gb, ge, q, i >= 0 ? part_at(p, e, k) : nullptr, true);
  }
  __threadfence();   // the partials reach L2 before the counts do
  __syncthreads();
  if (tid < kTeams) {
    const int it = s_win[tid];
    if (it >= 0 && (tid == 0 || s_win[tid - 1] != it)) {
      int n = 1;
      while (tid + n < kTeams && s_win[tid + n] == it) ++n;
      const int total = p.long_first[it + 1] - p.long_first[it];
      if (atomicAdd(p.counters + it, n) + n == total) {
        p.counters[it] = 0;   // no other block touches it in this launch
        s_fold[atomicAdd(&s_nfold, 1)] = it;
      }
    }
  }
  __syncthreads();
  const int nfold = s_nfold;
  if (nfold == 0) return;
  __threadfence();
  unsigned char* buf = stage + warp * kFoldBytes;
  for (int pr = warp; pr < nfold * p.n_evals; pr += kWarps) {
    const int it = s_fold[pr / p.n_evals], e = pr % p.n_evals;
    if (p.op[e] == OP_COUNT) continue;
    const int first = p.long_first[it];
    S::fold(p, e, part_at(p, e, first), p.long_first[it + 1] - first, lane,
            buf, out_at(p, e, p.long_win[it]));
  }
}

// blocks [0, long_blocks): the long windows' chunks; then the short
// windows, 64 a block; then the append, a warp a 512-cell chunk of a row.
// An 8-byte ring asks for 2 resident blocks an SM (at most 128 registers a
// thread): at 4 its loads of twice the bytes spilled.
template <typename W, typename A>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(A) == 8 ? 2 : kEvalMinBlocks)
append_eval_kernel(const __grid_constant__ AppendEval p) {
  __shared__ __align__(16) unsigned char stage[kStageBytes<W>];
  const int b = blockIdx.x;
  if (b < p.long_blocks) {
    long_chunks<OneRing<W, A>>(p, b, stage);
  } else if (b < p.long_blocks + p.short_blocks) {
    short_windows<OneRing<W, A>>(p, b - p.long_blocks);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    append_warp<W, A>(
        static_cast<A*>(p.ring), static_cast<const W*>(p.blk), p.offs, p.KP,
        p.cap, p.Rb, p.avec,
        (long long)(b - p.long_blocks - p.short_blocks) * kWarps + warp,
        lane,
        reinterpret_cast<W*>(stage) + warp * WarpAppend<W, A>::kBufCells);
  }
}

template <typename W, typename A>
int launch_append_eval(AppendEval p, cudaStream_t st) {
  p.vec = aligned16(p.ring);
  p.avec = p.Rb > 0 && p.Rb % kChunk == 0 && aligned16(p.ring)
           && aligned16(p.blk);
  const long long append_warps =
      (long long)p.KP * ((p.Rb + kWarpCells - 1) / kWarpCells);
  const long long append_blocks = (append_warps + kWarps - 1) / kWarps;
  p.long_blocks = (p.chunks + kTeams - 1) / kTeams;
  p.short_blocks =
      p.n_evals > 0 ? (p.B + kEvalWindows - 1) / kEvalWindows : 0;
  const long long blocks =
      (long long)p.long_blocks + p.short_blocks + append_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  append_eval_kernel<W, A><<<(unsigned)blocks, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- ring_append_multi_eval

// A window of every field's ring: rows and columns are shared, so is a.
struct Span {
  int r, len, a;
  long long s;
  __device__ __forceinline__ int groups() const {
    return (int)(((long long)a + len + kGroup - 1) / kGroup);
  }
};

// Calls fn(W{}, A{}) with the wire and ring types of the codes: any of
// the 47 pairs (kAll), or one of the 8 of int32 and float32 rings.
template <bool kAll, typename F>
__device__ __forceinline__ void with_pair(int wire, int acc, F&& fn) {
  if constexpr (kAll) {
    with_types(wire, acc, fn);
  } else if (acc == A_INT32) {
    for_wire<int32_t>(wire, [&](auto w) { fn(w, int32_t{}); });
  } else {
    for_wire<float>(wire, [&](auto w) { fn(w, float{}); });
  }
}

// Calls fn(A{}) with the ring type of code acc, any (kAll) or int32 and
// float32.
template <bool kAll, typename F>
__device__ __forceinline__ void with_ring(int acc, F&& fn) {
  if constexpr (kAll) {
    with_acc(acc, fn);
  } else if (acc == A_INT32) {
    fn(int32_t{});
  } else {
    fn(float{});
  }
}

template <bool kAll>
struct FieldRings {
  using Win = Span;
  static constexpr bool kStatItems = true;   // a team a (stat, window)
  __device__ static Win window(const AppendEval& p, int r, long long s,
                               int len) {
    Span c;
    c.r = r;
    c.s = s;
    c.len = len;
    c.a = (int)(((long long)r * p.cap + s) & 3);
    return c;
  }
  __device__ static void count(const AppendEval& p, int e, void* dst,
                               int n) {
    with_ring<kAll>(p.field[p.src[e]].acc, [&](auto a) {
      using A = decltype(a);
      *static_cast<A*>(dst) = (A)n;
    });
  }
  __device__ static void eval(const AppendEval& p, int e, const Win& c,
                              int gb, int ge, int q, void* dst, bool part) {
    const FieldRing& f = p.field[p.src[e]];
    with_pair<kAll>(f.wire, f.acc, [&](auto w, auto a) {
      using W = decltype(w);
      using A = decltype(a);
      if constexpr (kAll) {
        field_eval<W, A>(p, e, f, c.r, c.s, c.len, gb, ge, q, dst, part);
      } else {
        eval_span<W, A>(p.op[e],
                        window_of<W, A>(f.ring, f.blk, p, c.r, c.s, c.len),
                        f.vec, gb, ge, q, p.ident[e], dst, part);
      }
    });
  }
  __device__ static void fold(const AppendEval& p, int e, const void* part,
                              int n, int lane, void* buf, void* dst) {
    with_ring<kAll>(p.field[p.src[e]].acc, [&](auto a) {
      fold_chunks<decltype(a)>(p.op[e], part, n, p.ident[e], lane, buf,
                               dst);
    });
  }
};

constexpr int kTileLanes = 4;              // tile lanes a thread writes

// Tile block tb: lanes [1024 run, 1024 run + 1024) of window b's tiles and
// mask, 4 lanes a thread with one vector store a field (lane by lane where
// a row of an odd pad straddles a 4-lane edge), window_gather's layout.
// A live lane's column is clamped to [0, cap); a column inside the row's
// rectangle is read from the field's blk and widened, any other from its
// ring.  A masked lane is 0 and loads nothing.
template <bool kAll>
__device__ __forceinline__ void tile_block(const AppendEval& p, int tb) {
  const int b = tb / p.tile_runs, run = tb % p.tile_runs;
  const int len = p.lens[b];
  const long long start = p.starts[b];
  const int r = p.rows[b];
  const long long o = p.Rb > 0 ? p.offs[r] : 0, o_end = o + p.Rb;
  const long long t0 = (long long)b * p.pad;   // the row's first tile cell
  const int h = (int)(t0 & (kTileLanes - 1));  // its lanes before an edge
  const int groups = (p.pad + h + kTileLanes - 1) / kTileLanes;
  for (int g = run * kThreads + threadIdx.x; g < groups;
       g += p.tile_runs * kThreads) {
    const int j0 = g * kTileLanes - h;
    const bool whole = j0 >= 0 && j0 + kTileLanes <= p.pad;
    long long col[kTileLanes];
    bool live[kTileLanes];
#pragma unroll
    for (int t = 0; t < kTileLanes; ++t) {
      const int j = j0 + t;
      live[t] = j >= 0 && j < p.pad && j < len;
      long long c = start + j;
      c = c < p.cap - 1 ? c : p.cap - 1;
      col[t] = c < 0 ? 0 : c;
    }
    for (int f = 0; f < p.n_tiles; ++f) {
      const FieldRing& fr = p.field[p.tile_src[f]];
      with_pair<kAll>(fr.wire, fr.acc, [&](auto w, auto a) {
        using W = decltype(w);
        using A = decltype(a);
        const A* row = static_cast<const A*>(fr.ring) + (long long)r * p.cap;
        const W* brow = static_cast<const W*>(fr.blk) + (long long)r * p.Rb;
        A v[kTileLanes];
#pragma unroll
        for (int t = 0; t < kTileLanes; ++t) {
          const long long c = col[t];
          v[t] = !live[t] ? A(0)
                 : c >= o && c < o_end ? widen<A, W>(__ldg(brow + (c - o)))
                                       : __ldg(row + c);
        }
        A* dst = static_cast<A*>(p.tile[f]) + t0 + j0;
        if (whole) {
          store4<A>(dst, v);
        } else {
#pragma unroll
          for (int t = 0; t < kTileLanes; ++t) {
            if (j0 + t >= 0 && j0 + t < p.pad) dst[t] = v[t];
          }
        }
      });
    }
    bool* m = p.mask + t0 + j0;
    if (whole) {
      uchar4 x;
      x.x = j0 < len;
      x.y = j0 + 1 < len;
      x.z = j0 + 2 < len;
      x.w = j0 + 3 < len;
      *reinterpret_cast<uchar4*>(m) = x;
    } else {
#pragma unroll
      for (int t = 0; t < kTileLanes; ++t) {
        if (j0 + t >= 0 && j0 + t < p.pad) m[t] = j0 + t < len;
      }
    }
  }
}

// blocks [0, long_blocks): the long windows' chunks of every stat; then
// the short windows, 64 a block; then the tiles, tile_runs blocks a
// window; then each field's append, append_blocks blocks a field.  kAll:
// any ring dtype (resident_multi.cu), else int32 and float32 rings only.
template <bool kAll>
__global__ void __launch_bounds__(kThreads, kEvalMinBlocks)
multi_eval_kernel(const __grid_constant__ AppendEval p) {
  // the launch's widest wire's stage (dynamic: an 8-byte wire's is twice
  // a 4-byte one's, and would take L1 from every launch)
  extern __shared__ __align__(16) unsigned char stage[];
  int b = blockIdx.x;
  if (b < p.long_blocks) {
    long_chunks<FieldRings<kAll>>(p, b, stage);
    return;
  }
  b -= p.long_blocks;
  if (b < p.short_blocks) {
    short_windows<FieldRings<kAll>>(p, b);
    return;
  }
  b -= p.short_blocks;
  if (b < p.tile_blocks) {
    tile_block<kAll>(p, b);
    return;
  }
  b -= p.tile_blocks;
  const FieldRing& f = p.field[b / p.append_blocks];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gw = (long long)(b % p.append_blocks) * kWarps + warp;
  with_pair<kAll>(f.wire, f.acc, [&](auto w, auto a) {
    using W = decltype(w);
    using A = decltype(a);
    append_warp<W, A>(
        static_cast<A*>(f.ring), static_cast<const W*>(f.blk), p.offs, p.KP,
        p.cap, p.Rb, f.avec, gw, lane,
        reinterpret_cast<W*>(stage) + warp * WarpAppend<W, A>::kBufCells);
  });
}

}  // namespace
}  // namespace wf
