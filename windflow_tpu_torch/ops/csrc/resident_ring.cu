// The single-ring kernels of resident.cuh (append_sum_kernel: ring_append
// and ring_append_regular_sum; append_eval_kernel: ring_append_eval) for
// the wires of ONE ring dtype, the Acc code WF_RING_ACC.  ops/ring.py
// compiles this file once for each of the eleven codes, all in parallel,
// and links the objects with resident.cu into one library: one
// translation unit for all 47 (wire, ring) pairs would build them one
// after another.

#include "resident.cuh"

#ifndef WF_RING_ACC
#error "compile with -DWF_RING_ACC=<an Acc code of resident.cuh>"
#endif

namespace wf {

template <int ACC>
int append_sum_for(int wire, void* ring, const void* blk,
                   const int32_t* offs, const int32_t* rstart0,
                   const int32_t* rlen, void* out, int KP, long long cap,
                   int Rb, int C, int slide, cudaStream_t st) {
  using A = typename AccOf<ACC>::type;
  return for_wire<A>(wire, [&](auto w) {
    return launch_append_sum<decltype(w), A>(ring, blk, offs, rstart0, rlen,
                                             out, KP, cap, Rb, C, slide, st);
  });
}

template <int ACC>
int append_eval_for(int wire, AppendEval p, cudaStream_t st) {
  using A = typename AccOf<ACC>::type;
  return for_wire<A>(wire, [&](auto w) {
    return launch_append_eval<decltype(w), A>(p, st);
  });
}

template int append_sum_for<WF_RING_ACC>(int, void*, const void*,
                                         const int32_t*, const int32_t*,
                                         const int32_t*, void*, int,
                                         long long, int, int, int,
                                         cudaStream_t);
template int append_eval_for<WF_RING_ACC>(int, AppendEval, cudaStream_t);

}  // namespace wf
