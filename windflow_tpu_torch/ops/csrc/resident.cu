// The C entry points of the ring kernels (resident.cuh; the single-ring
// kernels are compiled a ring dtype at a time in resident_ring.cu) and
// the per-field kernel of int32 and float32 rings, for sm_90a.
//
// The per-field step.  multi_eval_kernel replaces the jitted step of
// windflow_tpu/ops/resident.py _make_multi_step (:599-628; on every kf
// shard _make_mesh_multi_step :784):
//  * ring_append_multi_eval: a ring a field (at most kMaxFields, each
//    with its own wire and ring dtype of resident.cuh's 47 pairs, all of
//    one (KP, cap) shape, their rectangles of one (KP, Rb) shape at the
//    shared offsets): every field's append, every (field, op) stat over
//    the (row, start, len) windows of the rings after it as
//    ring_append_eval evaluates them (at most kMaxEvals a launch; the
//    wrapper takes more in further launches with Rb = 0), and for each
//    tile field the (B, pad) tile
//        tile[w, j] = j < lens[w] ? ring'[rows[w], clip(starts[w] + j, 0,
//                                                        cap - 1)] : 0
//    in the field's ring dtype, with the bool mask j < lens[w]
//    (window_gather's function, there a second launch).
// Design.  The blocks of ring_append_eval, in one grid: the stats' long
// chunks (one long-window list for every stat: the windows are shared,
// and so is each window's alignment a, since the rings share cap), the
// short windows, then tile blocks (window_gather's layout: 1,024 lanes a
// block, 4 a thread, one vector store a field), then each field's append
// blocks.  short_windows and long_chunks take the FieldRings source
// policy: evaluation e reads field src[e], its wire and ring types
// switched at run time (with_pair).  Two instantiations: a launch whose
// rings are all int32 or float32 takes multi_eval_kernel<false>, here,
// which holds those 8 pairs' team evaluations (ring_append_eval's) inline;
// any other launch multi_eval_kernel<true> (resident_multi.cu), which
// calls each of the 47 pairs' field_eval in resident_field.cu (inlined in
// one kernel they would build one after another, and a wire switched
// cell by cell spilled).  A block's switch is uniform: an append or tile
// field's blocks are that field's, and the evaluation blocks walk the
// stats in one order.  The tiles obey the rule the evaluations do: a cell
// inside the field's rectangle is read from its blk and widened, so no
// block reads a cell this launch writes.
// Bound, by bytes: every field's blk read once and its rectangle written
// once, for each field a stat or tile reads the ring cells the windows
// cover outside the rectangle once, the offsets and descriptors, the
// stats' outputs, every tile (a cell a lane) and the mask (1 byte a lane)
// written once.

#include "resident.cuh"

namespace wf {

namespace {

int append_sum(int wire, int acc, void* ring, const void* blk,
               const int32_t* offs, const int32_t* rstart0,
               const int32_t* rlen, void* out, int KP, long long cap, int Rb,
               int C, int slide, cudaStream_t st) {
  if (!wire_ok(wire, acc)) return (int)cudaErrorInvalidValue;
  switch (acc) {
#define WF_CASE(ACC)                                                      \
  case ACC:                                                               \
    return append_sum_for<ACC>(wire, ring, blk, offs, rstart0, rlen, out, \
                               KP, cap, Rb, C, slide, st);
    WF_CASE(A_INT32)
    WF_CASE(A_FLOAT32)
    WF_CASE(A_INT8)
    WF_CASE(A_INT16)
    WF_CASE(A_INT64)
    WF_CASE(A_FLOAT64)
    WF_CASE(A_UINT8)
    WF_CASE(A_UINT16)
    WF_CASE(A_UINT32)
    WF_CASE(A_UINT64)
    WF_CASE(A_FLOAT16)
#undef WF_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int append_eval(int wire, int acc, const AppendEval& p, cudaStream_t st) {
  if (!wire_ok(wire, acc)) return (int)cudaErrorInvalidValue;
  switch (acc) {
#define WF_CASE(ACC) \
  case ACC:          \
    return append_eval_for<ACC>(wire, p, st);
    WF_CASE(A_INT32)
    WF_CASE(A_FLOAT32)
    WF_CASE(A_INT8)
    WF_CASE(A_INT16)
    WF_CASE(A_INT64)
    WF_CASE(A_FLOAT64)
    WF_CASE(A_UINT8)
    WF_CASE(A_UINT16)
    WF_CASE(A_UINT32)
    WF_CASE(A_UINT64)
    WF_CASE(A_FLOAT16)
#undef WF_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// the evaluations' ops, identities, outputs and partials into p; false on
// an unknown op.  accs[e] is evaluation e's ring code.
bool set_evals(AppendEval& p, int n_evals, const int* ops, const int* accs,
               const unsigned long long* idents, void* const* outs,
               void* const* parts) {
  for (int e = 0; e < n_evals; ++e) {
    if (ops[e] < OP_SUM || ops[e] > OP_PROD) return false;
    p.op[e] = ops[e];
    p.ident[e] = idents[e];
    p.out[e] = outs[e];
    p.part[e] = parts[e];
    p.out_bytes[e] = out_bytes_of(ops[e], accs[e]);
    p.part_bytes[e] = part_bytes_of(accs[e]);
  }
  p.n_evals = n_evals;
  return true;
}

}  // namespace
}  // namespace wf

using namespace wf;

// Appends the (KP, Rb) rectangle `blk` (wire dtype) into the (KP, cap) ring
// (acc dtype) at per-row offsets `offs` (int32), on `stream`: the fused
// kernel with no window (C = 0), so only its append blocks run.  Returns
// cudaGetLastError() after the launch (0 on success); a (wire, acc) pair
// the kernels do not take gives cudaErrorInvalidValue.
extern "C" int wf_ring_append(void* ring, const void* blk, const void* offs,
                              int KP, long long cap, int Rb, int wire,
                              int acc, void* stream) {
  if (KP <= 0 || Rb <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  return append_sum(wire, acc, ring, blk, static_cast<const int32_t*>(offs),
                    nullptr, nullptr, nullptr, KP, cap, Rb, 0, 0,
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
  return append_sum(
      Rb > 0 ? wire : (int)W_INT8, acc, ring, blk,
      static_cast<const int32_t*>(offs), static_cast<const int32_t*>(rstart0),
      static_cast<const int32_t*>(rlen), out, KP, cap, Rb, C, slide,
      static_cast<cudaStream_t>(stream));
}

// One irregular resident dispatch in one launch on `stream`: appends the
// (KP, Rb) rectangle `blk` into the (KP, cap) ring as wf_ring_append does,
// then evaluates the n_evals ops (ops[e], the identity's bits in the op's
// working dtype idents[e]) over the B windows (rows, starts, lens; int32)
// of the ring after the append, window w's cells at columns
// min(max(starts[w], 0) + j, cap - 1), j < min(lens[w], pad), writing B
// values at outs[e] in the op's output dtype (resident.cuh, Dtypes) and
// using parts[e] for `chunks` partials in its working dtype (4 or 8
// bytes).  The n_long windows longer than `split` cells (long_win,
// ascending) are cut into chunks of `chunk` cells (a multiple of 32) from
// their first aligned group, window i's from long_first[i] on
// (long_first[n_long] = chunks); `counters` holds n_long int32 zeros and
// is left so.  Returns cudaGetLastError().
extern "C" int wf_ring_append_eval(
    void* ring, const void* blk, const void* offs, int KP, long long cap,
    int Rb, int wire, int acc, const int* ops,
    const unsigned long long* idents, void* const* outs, void* const* parts,
    int n_evals, const void* rows, const void* starts, const void* lens,
    int B, int pad, const void* long_win, const void* long_first,
    void* counters, int n_long, int chunks, int split, int chunk,
    void* stream) {
  if (KP < 0 || cap <= 0 || Rb < 0 || B < 0 || pad < 0 || n_evals < 0 ||
      n_evals > kMaxEvals || n_long < 0 || chunks < n_long || split < 0 ||
      chunk <= 0 || chunk % (kGroup * kLanes) != 0 || (B > 0 && KP == 0) ||
      (long long)B + chunks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  AppendEval p{};
  p.ring = ring;
  p.blk = blk;
  p.offs = static_cast<const int32_t*>(offs);
  p.rows = static_cast<const int32_t*>(rows);
  p.starts = static_cast<const int32_t*>(starts);
  p.lens = static_cast<const int32_t*>(lens);
  p.long_win = static_cast<const int32_t*>(long_win);
  p.long_first = static_cast<const int32_t*>(long_first);
  p.counters = static_cast<int32_t*>(counters);
  int accs[kMaxEvals];
  for (int e = 0; e < n_evals; ++e) accs[e] = acc;
  if (!set_evals(p, n_evals, ops, accs, idents, outs, parts)) {
    return (int)cudaErrorInvalidValue;
  }
  p.cap = cap;
  p.KP = KP;
  p.Rb = Rb;
  p.B = B;
  p.pad = pad;
  p.n_long = n_long;
  p.chunks = chunks;
  p.split = split;
  p.chunk = chunk / kGroup;
  return append_eval(Rb > 0 ? wire : (int)W_INT8, acc, p,
                     static_cast<cudaStream_t>(stream));
}

// One per-field resident dispatch in one launch on `stream`: appends each
// of the n_fields (KP, Rb) rectangles blks[f] (wire dtype wires[f]) into
// its (KP, cap) ring rings[f] (ring dtype accs[f]) at the shared per-row
// offsets `offs`, as wf_ring_append does; evaluates the n_evals ops
// (ops[e] over the ring of field srcs[e], identity bits idents[e]) over
// the B windows (rows, starts, lens) of the rings after the append as
// wf_ring_append_eval does, writing outs[e] (B values in the op's output
// dtype for that field's ring) with parts[e] for `chunks` partials; and
// writes the (B, pad) tile of each field tile_src[t] into tiles[t] (that
// field's ring dtype, 16-byte aligned): lane j of window w is
// ring'[rows[w], clip(starts[w] + j, 0, cap - 1)] where j < lens[w], else
// 0, and the bool (B, pad) `mask` (4-byte aligned) is j < lens[w].  Rb = 0
// (blks and offs unused, may be null) evaluates alone.  The long-window
// arguments are wf_ring_append_eval's.  Returns cudaGetLastError() after
// the launch (0, and nothing launched, when there is no work).
extern "C" int wf_ring_append_multi_eval(
    void* const* rings, const void* const* blks, const int* wires,
    const int* accs, int n_fields, const void* offs, int KP, long long cap,
    int Rb, const int* ops, const int* srcs,
    const unsigned long long* idents, void* const* outs, void* const* parts,
    int n_evals, const int* tile_src, void* const* tiles, int n_tiles,
    void* mask, const void* rows, const void* starts, const void* lens,
    int B, int pad, const void* long_win, const void* long_first,
    void* counters, int n_long, int chunks, int split, int chunk,
    void* stream) {
  if (n_fields <= 0 || n_fields > kMaxFields || KP < 0 || cap <= 0 ||
      Rb < 0 || B < 0 || pad < 0 || n_evals < 0 || n_evals > kMaxEvals ||
      n_tiles < 0 || n_tiles > kMaxFields || n_long < 0 ||
      chunks < n_long || split < 0 || chunk <= 0 ||
      chunk % (kGroup * kLanes) != 0 || (B > 0 && KP == 0) ||
      (long long)B + chunks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  AppendEval p{};
  p.offs = static_cast<const int32_t*>(offs);
  p.rows = static_cast<const int32_t*>(rows);
  p.starts = static_cast<const int32_t*>(starts);
  p.lens = static_cast<const int32_t*>(lens);
  p.long_win = static_cast<const int32_t*>(long_win);
  p.long_first = static_cast<const int32_t*>(long_first);
  p.counters = static_cast<int32_t*>(counters);
  p.n_fields = n_fields;
  for (int f = 0; f < n_fields; ++f) {
    if (!wire_ok(wires[f], accs[f])) return (int)cudaErrorInvalidValue;
    FieldRing& fr = p.field[f];
    fr.ring = rings[f];
    fr.blk = Rb > 0 ? blks[f] : nullptr;
    fr.wire = wires[f];
    fr.acc = accs[f];
    fr.vec = aligned16(rings[f]);
    fr.avec = Rb > 0 && Rb % kChunk == 0 && aligned16(rings[f]) &&
              aligned16(blks[f]);
  }
  int eaccs[kMaxEvals];
  for (int e = 0; e < n_evals; ++e) {
    if (srcs[e] < 0 || srcs[e] >= n_fields) {
      return (int)cudaErrorInvalidValue;
    }
    p.src[e] = srcs[e];
    eaccs[e] = accs[srcs[e]];
  }
  if (!set_evals(p, n_evals, ops, eaccs, idents, outs, parts)) {
    return (int)cudaErrorInvalidValue;
  }
  // empty tiles (B = 0 or pad = 0) are not written
  if (B == 0 || pad == 0) n_tiles = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (tile_src[t] < 0 || tile_src[t] >= n_fields) {
      return (int)cudaErrorInvalidValue;
    }
    if (!aligned16(tiles[t])) return (int)cudaErrorMisalignedAddress;
    p.tile_src[t] = tile_src[t];
    p.tile[t] = tiles[t];
  }
  if (n_tiles > 0 && (mask == nullptr ||
                      reinterpret_cast<uintptr_t>(mask) % 4 != 0)) {
    return (int)cudaErrorMisalignedAddress;
  }
  p.n_tiles = n_tiles;
  p.mask = static_cast<bool*>(mask);
  p.cap = cap;
  p.KP = KP;
  p.Rb = Rb;
  p.B = B;
  p.pad = pad;
  p.n_long = n_long;
  p.chunks = chunks;
  p.split = split;
  p.chunk = chunk / kGroup;
  // pad % 4 == 0 keeps every tile row aligned; else a row may need one
  // more group (window_gather's count)
  const long long tgroups = pad % kTileLanes == 0
      ? pad / kTileLanes : (pad + 2 * kTileLanes - 2) / kTileLanes;
  p.tile_runs = (int)((tgroups + kThreads - 1) / kThreads);
  const long long tile_blocks = n_tiles > 0 ? (long long)B * p.tile_runs : 0;
  const long long append_blocks =
      ((long long)KP * ((Rb + kWarpCells - 1) / kWarpCells) + kWarps - 1) /
      kWarps;
  p.long_blocks = n_evals > 0 ? (chunks + kTeams - 1) / kTeams : 0;
  const long long items =
      (long long)n_evals * ((B + 3) & ~3);
  if ((items + kEvalWindows - 1) / kEvalWindows > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  p.short_blocks = (int)((items + kEvalWindows - 1) / kEvalWindows);
  const long long blocks = (long long)p.long_blocks + p.short_blocks +
                           tile_blocks + append_blocks * n_fields;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tile_blocks = (int)tile_blocks;
  p.append_blocks = append_blocks > 0 ? (int)append_blocks : 1;
  int stage = kStageBytes<int8_t>;
  for (int f = 0; f < n_fields && Rb > 0; ++f) {
    const int w = with_acc(accs[f], [&](auto a) {
      return for_wire<decltype(a)>(wires[f], [&](auto x) {
        return kStageBytes<decltype(x)>;
      });
    });
    stage = w > stage ? w : stage;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  for (int f = 0; f < n_fields; ++f) {
    if (accs[f] != A_INT32 && accs[f] != A_FLOAT32) {
      return launch_multi_any(p, (unsigned)blocks, stage, st);
    }
  }
  multi_eval_kernel<false><<<(unsigned)blocks, kThreads, stage, st>>>(p);
  return (int)cudaGetLastError();
}
