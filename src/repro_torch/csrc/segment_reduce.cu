// Segmented reduction over sorted segments for Hopper (sm_90a).
//
//   out[s, :] = combine over rows e in [offsets[s], offsets[s+1]) with
//               mask[e] of values[e, :]            (identity if none)
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/kernel.py
// (segment_sum_ell_kernel, body _segsum_kernel), Palgol's message
// combiner: every `sum/minimum/maximum/count/and/or [... | e <- In/Out/Nbr[v]]`
// is a reduction of per-edge values by the edge's destination. The TPU
// kernel only sums, over a blocked-ELL layout; this one reads the graph's
// CSR offsets (edges are already sorted by segment) and does all six
// Palgol combiners:
//   sum, prod  f32/bf16 accumulate in f32 and store the input type; int32
//              accumulates in uint32, so overflow wraps in two's complement
//              as in XLA (signed overflow would be undefined in C++);
//   min, max   f32/bf16 (via f32; a NaN propagates), int32, and bool
//              (min = all, max = any);
//   or, and    bool only (the caller routes other types through int32
//              max/min, as the JAX package does).
// An empty segment, or one whose rows are all masked, gets the identity:
// sum 0, prod 1, min +inf / INT32_MAX / true, max -inf / INT32_MIN / false,
// or false, and true.
//
// Bound on this card: bytes. Every value row is read once (plus one mask
// byte per row and the n+1 offsets) and every output row written once, at
// 3.35 TB/s; one combine per element is far below the arithmetic peak.
//
// Design: one warp per segment. For one-element rows the 32 lanes stride
// the segment's rows (coalesced loads) and fold their partials with a
// butterfly of shuffles; for wider rows each lane owns a column and walks
// the rows. The order of combination is fixed, with no atomics, so a float
// sum is the same from run to run. Skew is not handled: a hub with tens of
// thousands of rows keeps one warp busy while short segments finish.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OP_SUM = 0, OP_PROD, OP_MIN, OP_MAX, OP_OR, OP_AND };
enum { DT_F32 = 0, DT_BF16, DT_I32, DT_BOOL };

// Storage type T <-> accumulator type A.
template <typename T> struct Io;
template <> struct Io<float> {
  using A = float;
  static __device__ __forceinline__ A load(float x) { return x; }
  static __device__ __forceinline__ float store(A a) { return a; }
};
template <> struct Io<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(A a) {
    return __float2bfloat16_rn(a);
  }
};
template <> struct Io<int32_t> {
  using A = int32_t;
  static __device__ __forceinline__ A load(int32_t x) { return x; }
  static __device__ __forceinline__ int32_t store(A a) { return a; }
};
template <> struct Io<uint8_t> {  // bool: one byte holding 0 or 1
  using A = uint32_t;
  static __device__ __forceinline__ A load(uint8_t x) { return x; }
  static __device__ __forceinline__ uint8_t store(A a) { return (uint8_t)a; }
};

template <int OP> struct Comb;
template <> struct Comb<OP_SUM> {
  static __device__ __forceinline__ float f(float a, float b) { return a + b; }
  static __device__ __forceinline__ int32_t f(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
  static __device__ __forceinline__ float id(float) { return 0.f; }
  static __device__ __forceinline__ int32_t id(int32_t) { return 0; }
};
template <> struct Comb<OP_PROD> {
  static __device__ __forceinline__ float f(float a, float b) { return a * b; }
  static __device__ __forceinline__ int32_t f(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
  static __device__ __forceinline__ float id(float) { return 1.f; }
  static __device__ __forceinline__ int32_t id(int32_t) { return 1; }
};
template <> struct Comb<OP_MIN> {
  // min.NaN: a NaN wins, as in XLA's min and torch's amin (fminf would
  // drop it); one instruction, so the row loop stays free of branches
  static __device__ __forceinline__ float f(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  static __device__ __forceinline__ int32_t f(int32_t a, int32_t b) {
    return min(a, b);
  }
  static __device__ __forceinline__ uint32_t f(uint32_t a, uint32_t b) {
    return a & b;
  }
  static __device__ __forceinline__ float id(float) { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ int32_t id(int32_t) { return INT32_MAX; }
  static __device__ __forceinline__ uint32_t id(uint32_t) { return 1u; }
};
template <> struct Comb<OP_MAX> {
  static __device__ __forceinline__ float f(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  static __device__ __forceinline__ int32_t f(int32_t a, int32_t b) {
    return max(a, b);
  }
  static __device__ __forceinline__ uint32_t f(uint32_t a, uint32_t b) {
    return a | b;
  }
  static __device__ __forceinline__ float id(float) { return __int_as_float(0xff800000); }
  static __device__ __forceinline__ int32_t id(int32_t) { return INT32_MIN; }
  static __device__ __forceinline__ uint32_t id(uint32_t) { return 0u; }
};
template <> struct Comb<OP_OR> {
  static __device__ __forceinline__ uint32_t f(uint32_t a, uint32_t b) {
    return a | b;
  }
  static __device__ __forceinline__ uint32_t id(uint32_t) { return 0u; }
};
template <> struct Comb<OP_AND> {
  static __device__ __forceinline__ uint32_t f(uint32_t a, uint32_t b) {
    return a & b;
  }
  static __device__ __forceinline__ uint32_t id(uint32_t) { return 1u; }
};

// One warp per segment, rows of one element: lanes stride the rows.
template <typename T, int OP>
__global__ void segment_reduce_rows(const T* __restrict__ values,
                                    const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ offsets,
                                    T* __restrict__ out, int n_seg) {
  using A = typename Io<T>::A;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_seg) return;  // uniform across the warp
  const int beg = offsets[warp];
  const int end = offsets[warp + 1];
  A acc = Comb<OP>::id(A());
  for (int e = beg + lane; e < end; e += 32) {
    if (mask == nullptr || mask[e]) acc = Comb<OP>::f(acc, Io<T>::load(values[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = Comb<OP>::f(acc, (A)__shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) out[warp] = Io<T>::store(acc);
}

// One warp per segment, rows of `width` elements: lanes own columns.
template <typename T, int OP>
__global__ void segment_reduce_cols(const T* __restrict__ values,
                                    const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ offsets,
                                    T* __restrict__ out, int n_seg,
                                    int64_t width) {
  using A = typename Io<T>::A;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_seg) return;
  const int beg = offsets[warp];
  const int end = offsets[warp + 1];
  for (int64_t c = lane; c < width; c += 32) {
    A acc = Comb<OP>::id(A());
    for (int e = beg; e < end; ++e) {
      if (mask == nullptr || mask[e])
        acc = Comb<OP>::f(acc, Io<T>::load(values[(int64_t)e * width + c]));
    }
    out[warp * width + c] = Io<T>::store(acc);
  }
}

template <typename T, int OP>
int launch(const void* values, const uint8_t* mask, const int32_t* offsets,
           void* out, int n_seg, int64_t width, cudaStream_t stream) {
  const int threads = 256;  // 8 segments per block
  const int64_t blocks = ((int64_t)n_seg * 32 + threads - 1) / threads;
  if (width == 1) {
    segment_reduce_rows<T, OP><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(values), mask, offsets, static_cast<T*>(out),
        n_seg);
  } else {
    segment_reduce_cols<T, OP><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(values), mask, offsets, static_cast<T*>(out),
        n_seg, width);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int by_op_numeric(int op, const void* v, const uint8_t* m, const int32_t* o,
                  void* out, int n, int64_t w, cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch<T, OP_SUM>(v, m, o, out, n, w, s);
    case OP_PROD: return launch<T, OP_PROD>(v, m, o, out, n, w, s);
    case OP_MIN: return launch<T, OP_MIN>(v, m, o, out, n, w, s);
    case OP_MAX: return launch<T, OP_MAX>(v, m, o, out, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int by_op_bool(int op, const void* v, const uint8_t* m, const int32_t* o,
               void* out, int n, int64_t w, cudaStream_t s) {
  switch (op) {
    case OP_MIN: return launch<uint8_t, OP_MIN>(v, m, o, out, n, w, s);
    case OP_MAX: return launch<uint8_t, OP_MAX>(v, m, o, out, n, w, s);
    case OP_OR: return launch<uint8_t, OP_OR>(v, m, o, out, n, w, s);
    case OP_AND: return launch<uint8_t, OP_AND>(v, m, o, out, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// values [offsets[n_seg], width] (rows past it are never read), mask
// [rows] of bytes or NULL, offsets [n_seg + 1] int32 ascending, out
// [n_seg, width]. Returns 0 on success, else the cudaError_t of the launch.
extern "C" int segment_reduce_launch(int device, const void* values,
                                     const uint8_t* mask,
                                     const int32_t* offsets, void* out,
                                     int n_seg, long long width, int dtype,
                                     int op, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_seg == 0 || width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return by_op_numeric<float>(op, values, mask, offsets, out, n_seg, width, s);
    case DT_BF16:
      return by_op_numeric<__nv_bfloat16>(op, values, mask, offsets, out, n_seg,
                                          width, s);
    case DT_I32:
      return by_op_numeric<int32_t>(op, values, mask, offsets, out, n_seg, width,
                                    s);
    case DT_BOOL:
      return by_op_bool(op, values, mask, offsets, out, n_seg, width, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
