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
// as there (a NaN point neither dominates nor is dominated) and so do
// infinities.
//
// Design: filter, then verify, one block of 512 threads per window.
//  1. Stage.  The window's x, y and mask are read once (16-byte loads when
//     pad % 4 == 0) into dynamic shared memory, a masked lane as
//     (+inf, +inf): that point dominates nothing, so no later loop tests
//     the mask.  The block finds hi = 1 + the last real lane.  On the way
//     each thread keeps, in registers, its real lane of least x + y (a NaN
//     sum never wins).
//  2. Candidates.  Each group of 8 threads reduces those to one candidate
//     by shuffles: 64 a window.  The candidates that no other candidate
//     dominates become the filter (~6 on uniform data).
//  3. Filter.  Every thread tests 4 lanes at a time against the whole
//     filter by broadcast reads, without branching.  A dominated lane is
//     dead; the others go to a worklist (__ballot_sync + __popc + one
//     shared atomic per warp).
//  4. Verify.  Dominance is transitive, so whatever dominates a lane that
//     passed the filter passed it too (else a filter point would dominate
//     both).  Each warp therefore scans only the worklist, 32 entries at a
//     time, stopping at the first dominator (__any_sync).
//  5. Reduce.  The survivors are flags per lane; size and checksum come
//     from one fixed-order pass over the lanes, so neither the worklist's
//     order nor timing changes a bit of the result.
// Shared memory holds 13 B a lane (x, y, worklist index, flag): up to
// ~17,500 lanes fit the card's 227 KB.  Above that the same kernel reads
// the lanes from device memory and keeps worklist and flags in a scratch
// buffer the wrapper allocates: slower, the same answer.
// (The first design, one thread per point streaming tiles of j through
// shared memory, measured 2.85 ms at the spatial shape: a chunk holding a
// skyline point scanned all n j serially in one lane while the other warps
// idled.  The second, a warp per point testing 32 j at a time from global
// memory and stopping at the first dominator, measured 0.239 ms: each warp
// walked ~500 points as one dependent chain of loads, 16 warps an SM, and
// the survivors scanned all n lanes.)
// Bound on an H100 SXM: bytes, the (B, pad) x, y and mask read once (9 B a
// lane) and 8 B a window written, over 3.35 TB/s; operations, the pair
// tests this data needs in lane order (each real point's tests up to its
// first dominator, all n for a survivor) at 4 float32 compares each, over
// 67 TFLOP/s.  At the spatial shape bytes bound it; the filter leaves a few
// dozen lanes a window to verify, so the staging pass (the bytes bound's
// traffic) and ~6 filter tests a lane are the kernel's work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                  // threads giving one candidate
constexpr int kCand = kThreads / kGroup;   // candidates a window draws
constexpr int kUnroll = 4;                 // lanes a thread filters at once
constexpr int kLaneBytes = 13;   // x, y (float), worklist (int32), flag
constexpr int kStaticReserve = 4096;  // static shared memory, rounded up
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ bool dominates(float xj, float yj, float xi,
                                          float yi) {
  return xj <= xi && yj <= yi && (xj < xi || yj < yi);
}

// kStaged: the window's lanes live in dynamic shared memory; otherwise they
// are read from x, y and mask, and `work` and `alive` are device scratch of
// pad entries per window.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
skyline_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const bool* __restrict__ mask, int pad, bool vec,
               int32_t* __restrict__ g_work, uint8_t* __restrict__ g_alive,
               int32_t* __restrict__ size, float* __restrict__ checksum) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float c_x[kCand], c_y[kCand];
  __shared__ float f_x[kCand], f_y[kCand];
  __shared__ int s_int[kWarps];
  __shared__ float s_flt[kWarps];
  __shared__ int n_filter, n_work;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * pad;
  const float* xw = x + base;
  const float* yw = y + base;
  const bool* mw = mask + base;

  float* sx = nullptr;
  float* sy = nullptr;
  int32_t* work;
  uint8_t* alive;
  if constexpr (kStaged) {
    sx = reinterpret_cast<float*>(smem);
    sy = sx + pad;
    work = reinterpret_cast<int32_t*>(sy + pad);
    alive = reinterpret_cast<uint8_t*>(work + pad);
  } else {
    work = g_work + base;
    alive = g_alive + base;
  }
  // lane j's point; a masked lane is (+inf, +inf), which dominates nothing
  auto at = [&](int j) -> float2 {
    if constexpr (kStaged) {
      return make_float2(sx[j], sy[j]);
    } else {
      return mw[j] ? make_float2(xw[j], yw[j])
                   : make_float2(INFINITY, INFINITY);
    }
  };

  // 1. stage the window (flags = mask), find hi, and keep this thread's
  // real lane of least x + y (lanes come in increasing order, so the
  // lowest lane wins a tie)
  int hi = 0;
  float best = INFINITY, bx = NAN, by = NAN;
  int arg = INT_MAX;
  auto consider = [&](int l, bool m, float px, float py) {
    if (m) {
      hi = l + 1;
      const float s = px + py;
      if (s < best) {
        best = s;
        arg = l;
        bx = px;
        by = py;
      }
    }
  };
  if (vec) {
#pragma unroll 2
    for (int q = tid; q < (pad >> 2); q += kThreads) {
      const uchar4 m = reinterpret_cast<const uchar4*>(mw)[q];
      float4 a = reinterpret_cast<const float4*>(xw)[q];
      float4 c = reinterpret_cast<const float4*>(yw)[q];
      const int l = 4 * q;
      consider(l, m.x, a.x, c.x);
      consider(l + 1, m.y, a.y, c.y);
      consider(l + 2, m.z, a.z, c.z);
      consider(l + 3, m.w, a.w, c.w);
      if constexpr (kStaged) {
        a.x = m.x ? a.x : INFINITY;  c.x = m.x ? c.x : INFINITY;
        a.y = m.y ? a.y : INFINITY;  c.y = m.y ? c.y : INFINITY;
        a.z = m.z ? a.z : INFINITY;  c.z = m.z ? c.z : INFINITY;
        a.w = m.w ? a.w : INFINITY;  c.w = m.w ? c.w : INFINITY;
        reinterpret_cast<float4*>(sx)[q] = a;
        reinterpret_cast<float4*>(sy)[q] = c;
      }
      reinterpret_cast<uchar4*>(alive)[q] = make_uchar4(
          m.x != 0, m.y != 0, m.z != 0, m.w != 0);
    }
  } else {
    for (int l = tid; l < pad; l += kThreads) {
      const bool m = mw[l];
      const float px = xw[l];
      const float py = yw[l];
      consider(l, m, px, py);
      if constexpr (kStaged) {
        sx[l] = m ? px : INFINITY;
        sy[l] = m ? py : INFINITY;
      }
      alive[l] = m;
    }
  }

  // 2. candidates: the least-sum lane of each group of kGroup threads; a
  // group without one leaves a NaN placeholder, which dominates nothing
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oa = __shfl_xor_sync(kFull, arg, off);
    const float ox = __shfl_xor_sync(kFull, bx, off);
    const float oy = __shfl_xor_sync(kFull, by, off);
    if (ob < best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
      bx = ox;
      by = oy;
    }
  }
  if ((tid & (kGroup - 1)) == 0) {
    c_x[tid / kGroup] = bx;
    c_y[tid / kGroup] = by;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if (lane == 0) s_int[warp] = hi;
  if (tid == 0) {
    n_filter = 0;
    n_work = 0;
  }
  __syncthreads();
  hi = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) hi = max(hi, s_int[k]);

  // the filter: the candidates no other candidate dominates; the kGroup
  // threads of a group test their candidate against kCand / kGroup each
  {
    const int c = tid / kGroup;
    const float cx = c_x[c];
    const float cy = c_y[c];
    bool dom = false;
#pragma unroll
    for (int k = tid & (kGroup - 1); k < kCand; k += kGroup) {
      dom |= dominates(c_x[k], c_y[k], cx, cy);
    }
    const unsigned ballot = __ballot_sync(kFull, dom);
    const unsigned group = (ballot >> (lane & ~(kGroup - 1)))
        & ((1u << kGroup) - 1u);
    if ((tid & (kGroup - 1)) == 0 && group == 0 && cx == cx) {
      const int f = atomicAdd(&n_filter, 1);
      f_x[f] = cx;
      f_y[f] = cy;
    }
  }
  __syncthreads();
  const int nf = n_filter;

  // 3. filter every real lane, kUnroll lanes a thread at a time (lanes
  // kThreads apart); compact the ones that pass into the worklist
  for (int i0 = 0; i0 < hi; i0 += kUnroll * kThreads) {
    int idx[kUnroll];
    bool live[kUnroll], dom[kUnroll];
    float px[kUnroll], py[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      idx[u] = i0 + u * kThreads + tid;
      live[u] = idx[u] < hi && alive[idx[u]];
      const float2 p = live[u] ? at(idx[u]) : make_float2(NAN, NAN);
      px[u] = p.x;
      py[u] = p.y;
      dom[u] = false;
    }
    for (int f = 0; f < nf; ++f) {
      const float fx = f_x[f];
      const float fy = f_y[f];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dom[u] |= dominates(fx, fy, px[u], py[u]);
      }
    }
    unsigned ballot[kUnroll];
    int total = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (live[u] && dom[u]) alive[idx[u]] = 0;
      ballot[u] = __ballot_sync(kFull, live[u] && !dom[u]);
      total += __popc(ballot[u]);
    }
    if (total != 0) {
      int at_w = 0;
      if (lane == 0) at_w = atomicAdd(&n_work, total);
      at_w = __shfl_sync(kFull, at_w, 0);
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (live[u] && !dom[u]) {
          work[at_w + __popc(ballot[u] & below)] = idx[u];
        }
        at_w += __popc(ballot[u]);
      }
    }
  }
  __syncthreads();
  const int nw = n_work;

  // 4. verify each worklist lane against the worklist
  for (int e = warp; e < nw; e += kWarps) {
    const int i = work[e];
    const float2 p = at(i);
    bool dom = false;
    for (int k0 = 0; k0 < nw && !dom; k0 += 32) {
      const int k = k0 + lane;
      bool d = false;
      if (k < nw) {
        const float2 q = at(work[k]);
        d = dominates(q.x, q.y, p.x, p.y);
      }
      dom = __any_sync(kFull, d);
    }
    if (dom && lane == 0) alive[i] = 0;
  }
  __syncthreads();

  // 5. fixed-order reduction: lanes in thread order, a shuffle tree per
  // warp, warps in order
  int cnt = 0;
  float acc = 0.0f;
  for (int i = tid; i < hi; i += kThreads) {
    if (alive[i]) {
      const float2 p = at(i);
      ++cnt;
      acc += p.x + p.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(kFull, cnt, off);
    acc += __shfl_down_sync(kFull, acc, off);
  }
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

// dynamic shared memory the staged kernel may take on the current device
int staged_budget(int* device) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  *device = dev;
  return optin - kStaticReserve;
}

}  // namespace

// 1 when a window of `pad` lanes fits the staged kernel's shared memory on
// the current device, 0 when the kernel needs the scratch buffers (pad
// int32 and pad bytes per window), -1 on a CUDA error.
extern "C" int wf_skyline_staged(int pad) {
  int dev = 0;
  const int budget = staged_budget(&dev);
  if (budget < 0) return -1;
  return (long long)pad * kLaneBytes <= budget ? 1 : 0;
}

// Skyline size (int32) and x+y checksum (float32) of each of the B windows
// of the (B, pad) float32 tiles `x`, `y` under the bool `mask`, on
// `stream`.  `work` (B * pad int32) and `alive` (B * pad bytes) are the
// scratch of a window too large for shared memory (wf_skyline_staged(pad)
// == 0); otherwise they may be null.  Returns cudaGetLastError() after the
// launch.
extern "C" int wf_skyline_windows(const void* x, const void* y,
                                  const void* mask, int B, int pad,
                                  void* work, void* alive, void* size,
                                  void* checksum, void* stream) {
  if (B <= 0 || pad <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const int budget = staged_budget(&dev);
  if (budget < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const bool vec = pad % 4 == 0
      && (reinterpret_cast<uintptr_t>(x) % 16) == 0
      && (reinterpret_cast<uintptr_t>(y) % 16) == 0
      && (reinterpret_cast<uintptr_t>(mask) % 4) == 0
      && (reinterpret_cast<uintptr_t>(alive) % 4) == 0;
  const long long staged_bytes = (long long)pad * kLaneBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged_bytes <= budget) {
    // once per device: let the staged kernel take the whole budget (the
    // attribute caps a launch's request; it does not reserve anything).
    // Two threads racing here set the same value.
    static int configured[kMaxDevices];
    if (!configured[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          skyline_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          budget);
      if (e != cudaSuccess) return (int)e;
      configured[dev] = 1;
    }
    skyline_kernel<true><<<B, kThreads, (size_t)staged_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const bool*>(mask), pad, vec, nullptr, nullptr,
        static_cast<int32_t*>(size), static_cast<float*>(checksum));
  } else {
    if (work == nullptr || alive == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    skyline_kernel<false><<<B, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const bool*>(mask), pad, vec,
        static_cast<int32_t*>(work), static_cast<uint8_t*>(alive),
        static_cast<int32_t*>(size), static_cast<float*>(checksum));
  }
  return (int)cudaGetLastError();
}
