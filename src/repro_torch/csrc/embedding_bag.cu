// Fixed-width embedding bags for Hopper (sm_90a).
//
//   out[b, :] = sum_h w[b, h] * table[clamp(idx[b, h], 0, V-1), :]
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag_kernel, body _bag_kernel): the recsys lookup hot path.
// AutoInt's `lookup` is one launch with H = 1 over its flat [F*V, D] table;
// `embedding_bag` sum/mean are launches with H > 1. As in the TPU kernel,
// the sum is taken in f32 over the bag's slots in order, the weights are
// in the table's type and the output is in the table's type. Without
// weights (a null pointer) every slot weighs 1. Unlike the TPU kernel, an
// index is clipped to [0, V-1], as the JAX package's ref.py and both model
// callers read the table (jnp.take(mode="clip")).
//
// Bound on this card: bytes. Each slot reads one table row (D elements),
// its index and its weight; each bag writes one row; one multiply-add per
// element read. At AutoInt's serve_bulk (262,144 x 39 rows of 16 f32) that
// is ~1.35 GB, ~0.40 ms at 3.35 TB/s. The rows are random, so what the
// reads cost is the 32-byte sectors they touch: a 64-byte row is two.
//
// Design: one thread per output element, in a grid-stride loop over the
// bags' elements: the D threads of a bag read one contiguous row per slot
// (coalesced) and write one contiguous output row; the bag's index and
// weight are the same address for those threads and come from L1. The
// TPU's scalar prefetch of the indices has no counterpart: each thread
// loads its own. Row offsets are 64-bit (the smoke's flat table has
// 39,000,000 rows, and row * D * 4 bytes overflows int32). Wider loads
// (16 bytes a thread) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float a) { *p = a; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

template <typename T>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     const T* __restrict__ w,
                                     T* __restrict__ out, int64_t n_rows,
                                     int64_t n_bags, int n_hot, int64_t d) {
  const int64_t total = n_bags * d;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t bag = t / d;
    const int64_t c = t - bag * d;
    const int32_t* ib = idx + bag * n_hot;
    float acc = 0.f;
    for (int h = 0; h < n_hot; ++h) {
      int64_t j = ib[h];
      j = j < 0 ? 0 : (j >= n_rows ? n_rows - 1 : j);
      const float x = widen(table[j * d + c]);
      acc = w ? fmaf(widen(w[bag * n_hot + h]), x, acc) : acc + x;
    }
    store(out + t, acc);
  }
}

template <typename T>
int launch(const void* table, const int32_t* idx, const void* w, void* out,
           int64_t n_rows, int64_t n_bags, int n_hot, int64_t d,
           cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n_bags * d + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  embedding_bag_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<const T*>(w),
      static_cast<T*>(out), n_rows, n_bags, n_hot, d);
  return (int)cudaGetLastError();
}

}  // namespace

// table [V, D], idx int32 [B, H], w [B, H] or null, out [B, D], contiguous,
// table/w/out of one type (0 float32, 1 bfloat16), V >= 1. Returns 0 on
// success, else the cudaError_t.
extern "C" int embedding_bag_launch(int device, const void* table,
                                    const int32_t* idx, const void* w,
                                    void* out, long long n_rows,
                                    long long n_bags, int n_hot, long long d,
                                    int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_bags * d == 0) return 0;
  if (n_rows < 1 || n_hot < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(table, idx, w, out, n_rows, n_bags, n_hot, d, s);
    case 1:
      return launch<__nv_bfloat16>(table, idx, w, out, n_rows, n_bags, n_hot,
                                   d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
