// The masked window gather, for sm_90a.
//
// Replaces the gather that feeds a user window function in the XLA-jitted
// device bodies of the JAX package:
//  * windflow_tpu/ops/device.py:156-161 (DeviceWindowExecutor._compiled.run,
//    jit :165), over the restaging path's flat buffer;
//  * windflow_tpu/ops/resident.py:618-625 (_make_multi_step.step, jit :630),
//    over a (KP, cap) resident ring.
//
// For every window b < B and lane j < pad of a (R, ncols) buffer:
//     c          = min(starts[b] + j, ncols - 1)        (XLA's index clamp)
//     out[b, j]  = j < lens[b] ? buf[rows[b], c] : 0
//     mask[b, j] = j < lens[b]
// rows == nullptr reads row 0 (the restaging buffer is one row).  A masked
// lane is written as 0 without any load, and the column of a live lane is
// clamped to [0, ncols), so no lane reads outside the buffer (an empty
// buffer, ncols == 0, is read not at all: its tile is zeros).  The values
// are copied as 32-bit words: one kernel serves int32 and float32 alike.
// mask == nullptr skips the mask (one launch per field writes it once).
//
// One thread per output cell, 256 lanes of one window per block (blockIdx.x
// over lanes, blockIdx.y strides over windows): the tile and mask writes
// are coalesced, and so are the reads of a live lane run.
// Bound on an H100 SXM (3.35 TB/s), by bytes: the tile (B*pad*4) and the
// mask (B*pad) written once, the buffer cells the windows cover read once,
// and the descriptors (12 B per window).  Overlapping windows re-read their
// shared cells from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const uint32_t* __restrict__ buf, long long ncols,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens, int B, int pad,
                     uint32_t* __restrict__ out, bool* __restrict__ mask) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= pad) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const bool live = lane < lens[b];
    uint32_t v = 0;
    if (live && ncols > 0) {
      long long c = (long long)starts[b] + lane;
      c = c < ncols - 1 ? c : ncols - 1;
      c = c < 0 ? 0 : c;
      const long long r = rows != nullptr ? (long long)rows[b] : 0;
      v = __ldg(buf + r * ncols + c);
    }
    const long long o = (long long)b * pad + lane;
    out[o] = v;
    if (mask != nullptr) mask[o] = live;
  }
}

}  // namespace

// Gathers the (B, pad) tile of 32-bit words `out` (and the bool `mask`,
// when not null) from the (R, ncols) buffer `buf`, window b reading row
// rows[b] (row 0 when `rows` is null) from column starts[b] for lens[b]
// lanes, on `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int wf_window_gather(const void* buf, long long ncols,
                                const void* rows, const void* starts,
                                const void* lens, int B, int pad, void* out,
                                void* mask, void* stream) {
  if (B <= 0 || pad <= 0 || ncols < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((pad + kThreads - 1) / kThreads,
                  B < kMaxGridY ? B : kMaxGridY);
  window_gather_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), ncols,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lens), B, pad, static_cast<uint32_t*>(out),
      static_cast<bool*>(mask));
  return (int)cudaGetLastError();
}
