// multi_eval_kernel<true> (resident.cuh): ring_append_multi_eval over
// fields of any ring dtype, its evaluations calls of resident_field.cu's
// field_eval (relocatable device code).  A launch whose rings are all
// int32 or float32 takes multi_eval_kernel<false> in resident.cu, which
// holds the 8 pairs' evaluations inline: a kernel that called them took
// 23% more at a MultiReducer launch and 40% more at 1,024 long windows
// over 3 fields on the H100 (PERF.md).

#include "resident.cuh"

namespace wf {

int launch_multi_any(const AppendEval& p, unsigned blocks, int stage,
                     cudaStream_t st) {
  multi_eval_kernel<true><<<blocks, kThreads, stage, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace wf
