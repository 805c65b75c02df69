// The value dtypes of the restaging and mesh kernels (windowed_reduce.cu,
// mesh_reduce.cu): how a cell of each is stored, loaded four at a time and
// reduced, for sm_90a.
//
// A 4-cell group is one vector load at every width: 16 bytes for 4-byte
// cells (int32, uint32, float32), 8 for float16, 32 for 8-byte cells
// (int64, uint64, float64: two 16-byte loads).  Groups lie at cells 4g of
// a buffer, so a buffer that is 16-byte aligned keeps every load aligned.
//
// A value is reduced in its work type Work<OP, T>: integer sums and
// products in the unsigned type of their width (they wrap modulo 2^32 or
// 2^64 without the undefined behaviour of signed overflow), min and max in
// T itself (a signed or an unsigned compare, as T says), float16 in float
// (its result rounded to float16 once, __float2half_rn).

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wf {

enum Op { OP_SUM = 0, OP_COUNT = 1, OP_MIN = 2, OP_MAX = 3, OP_PROD = 4,
          OP_MEAN = 5 };
// the wrappers' dtype codes (ops/windowed_reduce.py DTYPE_CODES)
enum Dtype { DT_INT32 = 0, DT_FLOAT32 = 1, DT_UINT32 = 2, DT_INT64 = 3,
             DT_UINT64 = 4, DT_FLOAT16 = 5, DT_FLOAT64 = 6 };

// 8-byte cells: a group of 4 is two 16-byte loads
struct Group8 {
  ulonglong2 lo, hi;
};

// storage of T: the word a cell is held in, a 4-cell group, its load and
// its cells
template <int BYTES> struct Cells;

template <> struct Cells<4> {
  using Word = uint32_t;
  using Group = uint4;
  static __device__ __forceinline__ Group load(const Group* g) {
    return __ldg(g);
  }
  static __device__ __forceinline__ Word at(const Group& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ Group make(const Word* x) {
    return make_uint4(x[0], x[1], x[2], x[3]);
  }
};

template <> struct Cells<8> {
  using Word = unsigned long long;
  using Group = Group8;
  static __device__ __forceinline__ Group load(const Group* g) {
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(g);
    return Group8{__ldg(p), __ldg(p + 1)};
  }
  static __device__ __forceinline__ Word at(const Group& v, int i) {
    return i == 0 ? v.lo.x : i == 1 ? v.lo.y : i == 2 ? v.hi.x : v.hi.y;
  }
  static __device__ __forceinline__ Group make(const Word* x) {
    return Group8{make_ulonglong2(x[0], x[1]), make_ulonglong2(x[2], x[3])};
  }
};

template <> struct Cells<2> {
  using Word = unsigned short;
  using Group = uint2;
  static __device__ __forceinline__ Group load(const Group* g) {
    return __ldg(g);
  }
  static __device__ __forceinline__ Word at(const Group& v, int i) {
    return (Word)((i < 2 ? v.x : v.y) >> (16 * (i & 1)));
  }
  static __device__ __forceinline__ Group make(const Word* x) {
    return make_uint2(x[0] | ((uint32_t)x[1] << 16),
                      x[2] | ((uint32_t)x[3] << 16));
  }
};

template <typename T> using CellsOf = Cells<(int)sizeof(T)>;
template <typename T> using WordOf = typename CellsOf<T>::Word;

// the work type of OP over values of T
template <int OP, typename T> struct Work { using type = T; };
template <> struct Work<OP_SUM, int32_t> { using type = uint32_t; };
template <> struct Work<OP_MEAN, int32_t> { using type = uint32_t; };
template <> struct Work<OP_PROD, int32_t> { using type = uint32_t; };
template <> struct Work<OP_SUM, long long> {
  using type = unsigned long long;
};
template <> struct Work<OP_MEAN, long long> {
  using type = unsigned long long;
};
template <> struct Work<OP_PROD, long long> {
  using type = unsigned long long;
};
template <int OP> struct Work<OP, __half> { using type = float; };

template <typename W>
__device__ __forceinline__ bool is_nan(W x) {
  if constexpr (std::is_floating_point<W>::value) {
    return x != x;
  } else {
    return false;
  }
}

template <int OP, typename W>
__device__ __forceinline__ W combine(W a, W b) {
  if constexpr (OP == OP_SUM || OP == OP_MEAN) {
    return a + b;
  } else if constexpr (OP == OP_PROD) {
    return a * b;
  } else if constexpr (OP == OP_MIN) {
    return (is_nan(a) || a < b) ? a : b;   // NaN propagates, as jnp.min
  } else {
    return (is_nan(a) || a > b) ? a : b;
  }
}

// the same bits as another type of the same width
template <typename To, typename From>
__device__ __forceinline__ To bit_cast(From v) {
  static_assert(sizeof(To) == sizeof(From), "same width only");
  To out;
  memcpy(&out, &v, sizeof(out));
  return out;
}

// a stored cell of T as its work type W
template <typename T, typename W>
__device__ __forceinline__ W value(WordOf<T> bits) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__ushort_as_half(bits));
  } else {
    return bit_cast<W>(bits);
  }
}

// a work value as the stored word of T (float16: rounded once)
template <typename T, typename W>
__device__ __forceinline__ WordOf<T> stored(W acc) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half_as_ushort(__float2half_rn(acc));
  } else {
    return bit_cast<WordOf<T>>(acc);
  }
}

// the identity as W, from the 64-bit pattern the wrapper passes (the low
// bytes for a 4-byte W)
template <typename W>
__device__ __forceinline__ W ident_of(unsigned long long bits) {
  if constexpr (sizeof(W) == 4) {
    return bit_cast<W>((uint32_t)bits);
  } else {
    return bit_cast<W>(bits);
  }
}

// a count as the stored word of T
template <typename T>
__device__ __forceinline__ WordOf<T> count_as(int count) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half_as_ushort(__float2half_rn((float)count));
  } else {
    return bit_cast<WordOf<T>>((T)count);
  }
}

}  // namespace wf
