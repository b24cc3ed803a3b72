// Rows of f32 or bf16 read and written in units of A bytes, summed in f32:
// the row access shared by csrc/scatter_rows.cu and
// csrc/segment_reduce_bwd.cu.
//
// A row of W elements is W * elem / A units of A = 16, 8, 4 or 2 bytes,
// the widest that divides the row's bytes and every base address the
// kernel reads or writes rows at (row_access). A unit is one load or
// store instruction; its elements are widened to f32 for a sum and
// narrowed once, round to nearest even, when the row is written. A row of
// `units` units takes `lanes` threads, the power of two at or above
// `units` up to a warp; a row wider than 32 units is cut into slices of 32
// units (row_lanes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace rows {

template <int A> struct Unit;  // one access of A bytes
template <> struct Unit<16> { using V = uint4; };
template <> struct Unit<8> { using V = uint2; };
template <> struct Unit<4> { using V = uint32_t; };
template <> struct Unit<2> { using V = uint16_t; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T narrow(float a);
template <> __device__ __forceinline__ float narrow<float>(float a) { return a; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}

// the elements of a unit as f32 (E = A / sizeof(T) of them)
template <typename T, int A>
__device__ __forceinline__ void unpack(const typename Unit<A>::V& v, float* f) {
  constexpr int E = A / (int)sizeof(T);
  T e[E];
  memcpy(e, &v, A);
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = widen(e[i]);
}

// E f32 narrowed into a unit
template <typename T, int A>
__device__ __forceinline__ typename Unit<A>::V pack(const float* f) {
  constexpr int E = A / (int)sizeof(T);
  T e[E];
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = narrow<T>(f[i]);
  typename Unit<A>::V v;
  memcpy(&v, e, A);
  return v;
}

// The bytes of one access for rows of `row_bytes` at the given base
// addresses: the widest of 16, 8, 4, 2 that divides all of them, never
// narrower than an element (0 where even that fails).
inline int row_access(int64_t row_bytes, int elem, const void* const* bases, int n_bases) {
  for (int a = 16; a >= elem; a >>= 1) {
    bool ok = row_bytes % a == 0;
    for (int i = 0; i < n_bases && ok; ++i)
      ok = bases[i] == nullptr || reinterpret_cast<uintptr_t>(bases[i]) % a == 0;
    if (ok) return a;
  }
  return 0;
}

// log2 of the lanes a row of `units` units takes: the power of two at or
// above it, at most 32
inline int row_lanes(int64_t units) {
  int s = 0;
  while (s < 5 && (int64_t(1) << s) < units) ++s;
  return s;
}

}  // namespace rows
