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
// Bound on this card: bytes. The inputs are read once each: the distinct
// table rows the ids name (D elements each), the ids and the weights; the
// output is written once; one multiply-add per slot element. At AutoInt's
// serve_bulk (10,223,616 one-slot bags of 16 f32 over 39,000,000 rows,
// Zipf(1.2) ids) about 1.67 M rows are distinct: ~107 MB of rows, 654 MB
// of output and 41 MB of ids, ~0.24 ms at 3.35 TB/s. The output stream is
// most of it; the hot rows are read again and again from L1 and L2, so
// what the kernel can save is instructions and stalls per output byte.
//
// Design, by two routes that the C entry chooses (route below) and
// reports to the wrapper, which counts the one it launched:
//   vec    bags of one slot (AutoInt's lookup) of rows a multiple of 16
//          bytes from a 16-byte aligned table (bag_vec_one): each thread
//          owns one 16-byte chunk of a row, so L = D*elem/16 neighbouring
//          lanes share a bag (f32 D = 16: 4 lanes, 8 bags a warp) and a
//          warp's store covers 512 contiguous output bytes. Each thread
//          does K = 4 bags, a block's width of bags apart, and issues all
//          K id loads, then all K row loads, before any store, so K
//          16-byte loads are in flight; the row is stored as it was read
//          (times its weight, where there is one), so no f32 sum is held
//          in registers. Ids (and weights) are read once: streaming,
//          evict-first loads. Rows are normal non-coherent loads that
//          allocate in L1 and L2, where the hot Zipf rows stay. The output
//          is written with evict-first 16-byte stores: it cannot stay in
//          L2 anyway. Index arithmetic inside the block is 32-bit; only
//          the block's first bag and a row's offset (j * D: 39 M rows of
//          64 bytes pass 2^31) are 64-bit.
//   scalar every other bag, D or alignment (bags of H != 1 slots among
//          them: no model of the port sends those yet): one thread per
//          output element, a block over whole bags (the element's bag and
//          column from one 32-bit division per thread), the f32 sum over
//          the slots in order.
// Rows wider than the 256 threads of a block spread over blockIdx.y.
// A launch never falls back from one route to the other.
//
// At serve_bulk's shape on an H100, occupancy decided more than loads in
// flight: summing one-slot bags in f32 registers (56-72 registers a
// thread) was slower than storing the row as read (46), and K = 2-8 or
// blocks of 128-512 threads moved the time by a few per cent (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOneSlotBags = 4;  // the vec route's bags (rows in flight) a thread

enum Route { kVec = 0, kScalar = 1 };

int route(int dtype, int n_hot, long long d, const void* table) {
  const long long elem = dtype == 0 ? 4 : 2;
  return n_hot == 1 && (d * elem) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(table) % 16 == 0
             ? kVec
             : kScalar;
}

// an element or weight in the table's type, widened to f32
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float load_weight(const float* w, uint32_t i) {
  return __ldcs(w + i);
}
__device__ __forceinline__ float load_weight(const __nv_bfloat16* w, uint32_t i) {
  const unsigned short bits = __ldcs(reinterpret_cast<const unsigned short*>(w) + i);
  return __uint_as_float((uint32_t)bits << 16);
}
__device__ __forceinline__ void store(float* p, float a) { *p = a; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// A 16-byte chunk of a row (4 f32 or 8 bf16 elements), widened to f32 and back.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void widen(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 narrow(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  __device__ __forceinline__ static uint4 narrow(const float* a) {
    return make_uint4(pack(a[0], a[1]), pack(a[2], a[3]), pack(a[4], a[5]),
                      pack(a[6], a[7]));
  }
};

__device__ __forceinline__ int32_t clip(int32_t j, int32_t vmax) {
  return j < 0 ? 0 : (j > vmax ? vmax : j);
}

// vec route, bags of one slot (AutoInt's lookup): out = w * row, or the
// row itself (copied as it is: a sum of one slot). Lanes (bag bb of a
// step, chunk c): lt lanes a bag in this block (lt = min(L, 256)),
// bpb = kThreads / lt bags a step, K steps a block. All K ids (and
// weights), then all K rows, then the stores.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    bag_vec_one(const T* __restrict__ table, const int32_t* __restrict__ idx,
                const T* __restrict__ w, T* __restrict__ out, int32_t vmax,
                long long n_bags, int n_chunks, int lt, int bpb) {
  const int bb = threadIdx.x / lt;
  const int c = blockIdx.y * lt + threadIdx.x % lt;
  const long long bag0 = (long long)blockIdx.x * (bpb * K);  // the block's first
  const long long left = n_bags - bag0;
  const int nb = left < bpb * K ? (int)left : bpb * K;  // bags of this block
  if (bb >= bpb || c >= n_chunks) return;
  const int32_t* ib = idx + bag0;
  const T* wb = w ? w + bag0 : nullptr;
  const uint4* rows = reinterpret_cast<const uint4*>(table) + c;
  uint4* ob = reinterpret_cast<uint4*>(out) + bag0 * n_chunks + c;
  int32_t j[K];  // -1: past the last bag
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int lb = bb + k * bpb;
    j[k] = lb < nb ? clip(__ldcs(ib + lb), vmax) : -1;
    wk[k] = lb < nb && wb ? load_weight(wb, lb) : 1.f;
  }
  uint4 r[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j[k] >= 0) r[k] = __ldg(rows + (size_t)(uint32_t)j[k] * n_chunks);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (j[k] < 0) continue;
    if (wb) {
      float x[Chunk<T>::kElems];
      Chunk<T>::widen(r[k], x);
#pragma unroll
      for (int e = 0; e < Chunk<T>::kElems; ++e) x[e] *= wk[k];
      r[k] = Chunk<T>::narrow(x);
    }
    __stcs(ob + (uint32_t)(bb + k * bpb) * n_chunks, r[k]);
  }
}

// scalar route: one thread per output element, column col of bag lb, dt
// columns a bag in this block (dt = min(D, 256)), bpb = kThreads / dt bags.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bag_scalar(const T* __restrict__ table, const int32_t* __restrict__ idx,
               const T* __restrict__ w, T* __restrict__ out, int32_t vmax,
               long long n_bags, int n_hot, int d, int dt, int bpb) {
  const int lb = threadIdx.x / dt;
  const int col = blockIdx.y * dt + (threadIdx.x - lb * dt);
  const long long bag = (long long)blockIdx.x * bpb + lb;
  if (lb >= bpb || col >= d || bag >= n_bags) return;
  const int32_t* ib = idx + bag * n_hot;
  const T* wb = w ? w + bag * n_hot : nullptr;
  float acc = 0.f;
  for (int h = 0; h < n_hot; ++h) {
    const int32_t j = clip(__ldcs(ib + h), vmax);
    const float x = widen(__ldg(table + (size_t)(uint32_t)j * d + col));
    acc = wb ? fmaf(load_weight(wb, h), x, acc) : acc + x;
  }
  store(out + bag * d + col, acc);
}

template <typename T>
int launch(int which, const void* table, const int32_t* idx, const void* w,
           void* out, long long n_rows, long long n_bags, int n_hot, long long d,
           cudaStream_t stream) {
  const int32_t vmax = (int32_t)(n_rows - 1 < INT32_MAX ? n_rows - 1 : INT32_MAX);
  const T* tt = static_cast<const T*>(table);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  // the width a block takes, bags a block step, and blocks along the row
  const long long width = which == kVec ? d * (long long)sizeof(T) / 16 : d;
  const int lanes = (int)(width < kThreads ? width : kThreads);
  const int bpb = kThreads / lanes;
  const int k = which == kVec ? kOneSlotBags : 1;
  const long long steps = (long long)bpb * k;
  // block-local offsets (bag * H + h, bag * width) stay 32-bit
  if (steps * n_hot >= INT32_MAX || steps * width >= INT32_MAX ||
      (width + lanes - 1) / lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_bags + steps - 1) / steps;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((width + lanes - 1) / lanes));
  if (which == kVec)
    bag_vec_one<T, kOneSlotBags><<<grid, kThreads, 0, stream>>>(
        tt, idx, wt, ot, vmax, n_bags, (int)width, lanes, bpb);
  else
    bag_scalar<T><<<grid, kThreads, 0, stream>>>(tt, idx, wt, ot, vmax, n_bags,
                                                 n_hot, (int)d, lanes, bpb);
  return (int)cudaGetLastError();
}

}  // namespace

// table [V, D], idx int32 [B, H], w [B, H] or null, out [B, D] (16-byte
// aligned), contiguous, table/w/out of one type (0 float32, 1 bfloat16),
// V >= 1. Writes the route it launched (0 vec, 1 scalar; -1 for none) to
// *route_out. Returns 0 on success, else the cudaError_t.
extern "C" int embedding_bag_launch(int device, const void* table,
                                    const int32_t* idx, const void* w,
                                    void* out, long long n_rows,
                                    long long n_bags, int n_hot, long long d,
                                    int dtype, void* stream, int* route_out) {
  *route_out = -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_bags * d == 0) return 0;
  if (n_rows < 1 || n_hot < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorMisalignedAddress;
  const int which = route(dtype, n_hot, d, table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = (cudaError_t)(dtype == 0 ? launch<float>(which, table, idx, w, out, n_rows,
                                                 n_bags, n_hot, d, s)
                                 : launch<__nv_bfloat16>(which, table, idx, w, out,
                                                         n_rows, n_bags, n_hot, d, s));
  if (err == cudaSuccess) *route_out = which;
  return (int)err;
}
