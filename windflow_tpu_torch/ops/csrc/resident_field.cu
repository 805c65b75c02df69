// field_eval (resident.cuh) for the wires of ONE ring dtype, the Acc code
// WF_RING_ACC: the team evaluation of ring_append_multi_eval's FieldRings
// for each (wire, ring) pair, a device function of its own that
// resident_multi.cu's multi_eval_kernel<true> calls (relocatable device
// code).  ops/ring.py compiles this file once for each ring dtype with at
// most 64 registers a thread, the kernel's own budget (its launch bounds
// ask for 4 resident blocks an SM).

#include "resident.cuh"

#ifndef WF_RING_ACC
#error "compile with -DWF_RING_ACC=<an Acc code of resident.cuh>"
#endif

namespace wf {

using RingCell = AccOf<WF_RING_ACC>::type;

template <typename W, typename A>
__device__ void field_eval(const AppendEval& p, int e, const FieldRing& f,
                           int r, long long s, int len, int gb, int ge, int q,
                           void* dst, bool part) {
  eval_span<W, A>(p.op[e], window_of<W, A>(f.ring, f.blk, p, r, s, len),
                  f.vec, gb, ge, q, p.ident[e], dst, part);
}

#define WF_FIELD_EVAL(W)                                                  \
  template __device__ void field_eval<W, RingCell>(                       \
      const AppendEval&, int, const FieldRing&, int, long long, int, int, \
      int, int, void*, bool);
WF_FIELD_EVAL(int8_t)
WF_FIELD_EVAL(int16_t)
WF_FIELD_EVAL(int32_t)
// the wires of wire_ok: an 8-byte ring (A_INT64 = 4, A_FLOAT64 = 5,
// A_UINT64 = 9) takes int64 and float64, a narrower one float32
#if WF_RING_ACC == 4 || WF_RING_ACC == 5 || WF_RING_ACC == 9
WF_FIELD_EVAL(i64)
WF_FIELD_EVAL(double)
#else
WF_FIELD_EVAL(float)
#endif
#undef WF_FIELD_EVAL

}  // namespace wf
