// The masked window gather, for sm_90a.
//
// Replaces the gather that feeds a user window function in the XLA-jitted
// device bodies of the JAX package:
//  * windflow_tpu/ops/device.py:156-161 (DeviceWindowExecutor._compiled.run,
//    jit :165), over the restaging path's flat buffers;
//  * windflow_tpu/ops/resident.py:618-625 (_make_multi_step.step, jit :630),
//    over (KP, cap) resident rings, one per field.
//
// For every field f, window b < B and lane j < pad of (R, ncols) buffers:
//     c             = min(starts[b] + j, ncols - 1)     (XLA's index clamp)
//     out_f[b, j]   = j < lens[b] ? buf_f[rows[b], c] : 0
//     mask[b, j]    = j < lens[b]
// rows == nullptr reads row 0 (a restaging buffer is one row).  A masked
// lane is written as 0 without any load, and the column of a live lane is
// clamped to [0, ncols), so no lane reads outside a buffer (an empty
// buffer, ncols == 0, is read not at all: its tile is zeros).  The values
// are copied as words of their width, 4 or 8 bytes, so the fields of one
// width share a launch whatever their dtypes (int32, uint32 and float32;
// int64, uint64 and float64).  mask == nullptr skips the mask (the
// launches after a batch's first).
//
// Design: one launch for up to kMaxFields fields (their pointers travel by
// value in the kernel's parameters), so a batch's fields and its mask are
// written in one pass.  blockIdx.x is the window: its descriptors (row,
// start, length) are loaded once into registers.  blockIdx.y cuts the
// window's lanes into runs of 1,024; each thread writes 4 consecutive
// lanes of every field with one 16-byte store (two for 8-byte words) and 4
// mask lanes with one 4-byte store.  The 4 lanes of a thread start at a
// flat tile cell that is a multiple of 4, so when pad % 4 != 0 a row's
// first and last group straddle its neighbours' lanes: those groups store
// lane by lane, only their own lanes.  The reads of a live run are coalesced scalar loads
// (starts[b] is arbitrary, so a run is not aligned).
// Bound on an H100 SXM (3.35 TB/s), by bytes: the tiles (B*pad*4 or
// B*pad*8 per field) and the mask (B*pad) written once, the buffer cells the windows
// cover read once per field, and the descriptors (12 B per window).
// Overlapping windows re-read their shared cells from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                  // lanes a thread writes
constexpr int kMaxFields = 8;
constexpr int kMaxGridY = 65535;

template <typename Word>
struct Fields {
  const Word* buf[kMaxFields];
  Word* out[kMaxFields];
};

// the 4 lanes of a group with one 16-byte store, or two for 8-byte words
__device__ __forceinline__ void store4(uint32_t* dst, const uint32_t* v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(unsigned long long* dst,
                                       const unsigned long long* v) {
  reinterpret_cast<ulonglong2*>(dst)[0] = make_ulonglong2(v[0], v[1]);
  reinterpret_cast<ulonglong2*>(dst)[1] = make_ulonglong2(v[2], v[3]);
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(Fields<Word> fields, int nf, long long ncols,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens, int pad,
                     bool* __restrict__ mask) {
  const int b = blockIdx.x;
  const int len = lens[b];
  const long long start = starts[b];
  const long long roff = rows != nullptr ? (long long)rows[b] * ncols : 0;
  const long long o = (long long)b * pad;     // the row's first flat cell
  const int h = (int)(o & (kLanes - 1));      // its lanes before a 16 B edge
  const int groups = (pad + h + kLanes - 1) / kLanes;
  for (int g = blockIdx.y * kThreads + threadIdx.x; g < groups;
       g += gridDim.y * kThreads) {
    const int j0 = g * kLanes - h;            // lane of the group's first cell
    const bool whole = j0 >= 0 && j0 + kLanes <= pad;
    long long col[kLanes];
    bool live[kLanes];
#pragma unroll
    for (int t = 0; t < kLanes; ++t) {
      const int j = j0 + t;
      live[t] = j >= 0 && j < pad && j < len && ncols > 0;
      long long c = start + j;
      c = c < ncols - 1 ? c : ncols - 1;
      col[t] = roff + (c < 0 ? 0 : c);
    }
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f >= nf) continue;  // f stays a constant: the pointers stay params
      const Word* __restrict__ src = fields.buf[f];
      Word v[kLanes];
#pragma unroll
      for (int t = 0; t < kLanes; ++t) {
        v[t] = live[t] ? __ldg(src + col[t]) : 0u;
      }
      Word* dst = fields.out[f] + o + j0;
      if (whole) {
        store4(dst, v);
      } else {
#pragma unroll
        for (int t = 0; t < kLanes; ++t) {
          if (j0 + t >= 0 && j0 + t < pad) dst[t] = v[t];
        }
      }
    }
    if (mask != nullptr) {
      bool* m = mask + o + j0;
      if (whole) {
        // lanes past len are masked whether or not the buffer is empty
        uchar4 w;
        w.x = j0 < len;
        w.y = j0 + 1 < len;
        w.z = j0 + 2 < len;
        w.w = j0 + 3 < len;
        *reinterpret_cast<uchar4*>(m) = w;
      } else {
#pragma unroll
        for (int t = 0; t < kLanes; ++t) {
          if (j0 + t >= 0 && j0 + t < pad) m[t] = j0 + t < len;
        }
      }
    }
  }
}

template <typename Word>
cudaError_t launch(const void* const* bufs, void* const* outs, int nf,
                   long long ncols, const void* rows, const void* starts,
                   const void* lens, int B, int pad, void* mask,
                   cudaStream_t stream) {
  Fields<Word> fields = {};
  for (int f = 0; f < nf; ++f) {
    fields.buf[f] = static_cast<const Word*>(bufs[f]);
    fields.out[f] = static_cast<Word*>(outs[f]);
  }
  // pad % 4 == 0 keeps every row aligned (h == 0); else a row may need one
  // more group
  const long long groups = pad % kLanes == 0
      ? pad / kLanes : (pad + 2 * kLanes - 2) / kLanes;
  const long long runs = (groups + kThreads - 1) / kThreads;
  const dim3 grid(B, runs < kMaxGridY ? (unsigned)runs : kMaxGridY);
  window_gather_kernel<Word><<<grid, kThreads, 0, stream>>>(
      fields, nf, ncols, static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(lens),
      pad, static_cast<bool*>(mask));
  return cudaGetLastError();
}

}  // namespace

// Gathers the (B, pad) tiles outs[f] of words of `width` bytes (4 or 8;
// and the bool `mask`, when not null) of the nf <= 8 (R, ncols) buffers
// bufs[f], window b reading row rows[b] (row 0 when `rows` is null) from
// column starts[b] for lens[b] lanes, in one launch on `stream`.  Every
// out tile must be 16-byte aligned and the mask 4-byte aligned (fresh
// allocations are).  Returns cudaGetLastError() after the launch.
extern "C" int wf_window_gather(const void* const* bufs,
                                void* const* outs, int nf, int width,
                                long long ncols, const void* rows,
                                const void* starts, const void* lens, int B,
                                int pad, void* mask, void* stream) {
  if (B <= 0 || pad <= 0 || ncols < 0 || nf <= 0 || nf > kMaxFields ||
      (width != 4 && width != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(mask) % 4 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  for (int f = 0; f < nf; ++f) {
    if (reinterpret_cast<uintptr_t>(outs[f]) % 16 != 0) {
      return (int)cudaErrorMisalignedAddress;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(width == 8
                   ? launch<unsigned long long>(bufs, outs, nf, ncols, rows,
                                                starts, lens, B, pad, mask,
                                                st)
                   : launch<uint32_t>(bufs, outs, nf, ncols, rows, starts,
                                      lens, B, pad, mask, st));
}
