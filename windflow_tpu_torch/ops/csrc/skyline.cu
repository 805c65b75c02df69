// The 2-D skyline of every window of a batch, for sm_90a.
//
// Replaces windflow_tpu/apps/spatial.py:143-153 (device_skyline's fn, a
// masked (B, pad, pad) float32 dominance test that XLA runs inside the
// jitted bodies of ops/resident.py:_make_multi_step or ops/device.py's run).
// For every window b, lane i survives when
//     mask[b, i]  and  no j with mask[b, j] has
//     x[b, j] <= x[b, i], y[b, j] <= y[b, i] and (x[b, j] < x[b, i] or
//                                                   y[b, j] < y[b, i]);
// size[b] counts the survivors (int32) and checksum[b] sums their x + y
// in float32.  The comparisons are the fn's own, so NaN coordinates behave
// as there (a NaN point neither dominates nor is dominated).
//
// Design.  One block per window: the checksum's summation order is then
// fixed, so runs are deterministic.  The block first finds hi = 1 + the
// last real lane, so only n = hi lanes take part, not pad.  Each warp
// takes the points i = warp, warp + 8, ... in turn; its 32 lanes test 32
// candidate dominators j at once (the window's x, y and mask, 9 B a lane,
// stay in L1 across the points), and __any_sync stops the point at the
// first chunk holding a dominator (the same answer as the fn's any()).
// Each warp sums its survivors in point order and a fixed-order loop adds
// the 8 warps.  (The first design, one thread per point streaming tiles
// of j through shared memory, measured 2.85 ms at the spatial shape: a
// chunk holding a skyline point scanned all n j serially in one lane
// while the other warps idled.)
// Bound on an H100 SXM: bytes, the (B, pad) x, y and mask read once (9 B a
// lane) and 8 B a window written, over 3.35 TB/s; operations, the pair
// tests this data needs (each real point's tests up to its first
// dominator in lane order, all n for a survivor) at 4 float32 compares
// each, over 67 TFLOP/s.  A uniform window's skyline is O(log n) points,
// so most points find a dominator within the first few chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
skyline_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const bool* __restrict__ mask, int pad,
               int32_t* __restrict__ size, float* __restrict__ checksum) {
  __shared__ int s_int[kWarps];
  __shared__ float s_flt[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * pad;
  const float* xw = x + base;
  const float* yw = y + base;
  const bool* mw = mask + base;

  // hi = 1 + the last real lane of the window
  int hi = 0;
  for (int l = tid; l < pad; l += kThreads) {
    if (mw[l]) hi = l + 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) s_int[warp] = hi;
  __syncthreads();
  hi = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) hi = max(hi, s_int[k]);
  __syncthreads();  // s_int is reused below

  int cnt = 0;
  float acc = 0.0f;
  for (int i = warp; i < hi; i += kWarps) {
    if (!mw[i]) continue;  // uniform: every lane reads the same i
    const float xi = xw[i];
    const float yi = yw[i];
    bool dominated = false;
    for (int j0 = 0; j0 < hi && !dominated; j0 += 32) {
      const int j = j0 + lane;
      bool d = false;
      if (j < hi && mw[j]) {
        const float xj = xw[j];
        const float yj = yw[j];
        d = xj <= xi && yj <= yi && (xj < xi || yj < yi);
      }
      dominated = __any_sync(0xffffffffu, d);
    }
    if (!dominated) {
      ++cnt;
      acc += xi + yi;
    }
  }

  // fixed-order block reduction: every lane of a warp holds its warp's
  // (count, checksum); warps add in order
  if (lane == 0) {
    s_int[warp] = cnt;
    s_flt[warp] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      c += s_int[k];
      a += s_flt[k];
    }
    size[blockIdx.x] = c;
    checksum[blockIdx.x] = a;
  }
}

}  // namespace

// Skyline size (int32) and x+y checksum (float32) of each of the B windows
// of the (B, pad) float32 tiles `x`, `y` under the bool `mask`, on
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int wf_skyline_windows(const void* x, const void* y,
                                  const void* mask, int B, int pad,
                                  void* size, void* checksum, void* stream) {
  if (B <= 0 || pad <= 0) return (int)cudaErrorInvalidValue;
  skyline_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const bool*>(mask), pad, static_cast<int32_t*>(size),
      static_cast<float*>(checksum));
  return (int)cudaGetLastError();
}
