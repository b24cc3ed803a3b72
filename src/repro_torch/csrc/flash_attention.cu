// Forward attention with an online softmax for Hopper (sm_90a).
//
//   o[b, h, i, :] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,g,j,:]) v[b,g,j,:]
//   over the keys j that the mask keeps, g = h / (H / Hkv) (GQA);
//   key j is kept iff j < Sk, and j <= i under `causal`, and i - j < window
//   under a window (positions are the row indices, 0..S-1).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _attn_kernel): the prefill attention of every
// LM layer. What it keeps of that kernel: the f32 running max m, sum l and
// accumulator per query row; p rounded to the input type before the P.V
// product; a KV tile that the mask removes for the whole query tile is not
// loaded (live iff k_start <= q_end under causal, and
// k_end >= q_start - window + 1 under a window); a row with no key kept
// gives 0. What differs: the ragged Sq/Sk edges are masked here, where the
// TPU wrapper padded, and `scale` multiplies the f32 scores (1 is the TPU
// kernel). A masked score is -inf, not a finite -1e30, so a row whose kept
// keys all lie in later tiles carries no weight from the masked ones.
//
// Bound on this card: operations. Each kept (query, key) pair costs 4*D
// flops (two dot products of length D); at the smoke's prefill
// (S = 6144, window 4096, D = 80) that is ~0.69 ms per layer at the
// 989 TFLOP/s bf16 tensor-core rate, against ~0.09 ms for its bytes.
//
// Design (simple first, no tensor cores): one block of 128 threads per
// (batch*head, 64-row query tile); the TPU grid's sequential KV axis is the
// loop over 64-key tiles inside the block, from the first to the last live
// tile. Q, K and V tiles are staged in shared memory as f32 (bf16 is
// widened on load); K and Q rows are padded by one word against bank
// conflicts. Thread (ty, tx) owns query rows 4ty..4ty+3: it computes their
// scores against keys tx, tx+8, ..., tx+56 and output columns tx, tx+8, ...
// The eight threads of a row sit in one warp, so the row max and row sum
// are three shuffles and the P tile needs only a warp barrier. D is read at
// run time (up to 128); the column count per thread is a template
// parameter. All element offsets are 64-bit. The scores run on the f32
// units, far below the tensor cores' rate: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = BK / 8;   // key columns per thread

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// NJ: output columns per thread (8 * NJ >= D).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int n_heads,
                     int n_rep, int64_t sq, int64_t sk, int d, int causal,
                     int has_window, int64_t window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;     // padded row of Q and K
  const int ldv = 8 * NJ;   // V row, zero past D
  float* qs = smem;                // [BQ][ld]
  float* ks = qs + BQ * ld;        // [BK][ld]
  float* vs = ks + BK * ld;        // [BK][ldv]
  float* ps = vs + BK * ldv;       // [BQ][BK + 1]

  const int64_t bh = blockIdx.x;   // b * n_heads + h
  const int64_t b = bh / n_heads;
  const int h = (int)(bh - b * n_heads);
  const int64_t kvh = b * (n_heads / n_rep) + h / n_rep;
  const int64_t q_start = (int64_t)blockIdx.y * BQ;
  const T* qb = q + (bh * sq + q_start) * d;
  const T* kb = k + kvh * sk * d;
  const T* vb = v + kvh * sk * d;

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int r0 = (tid >> 3) * RPT;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    qs[r * ld + c] = q_start + r < sq ? widen(qb[(int64_t)r * d + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the live KV tiles of this query tile, as the TPU kernel's rule
  const int64_t n_kt = (sk + BK - 1) / BK;
  int64_t kt_end = n_kt;
  if (causal) {
    const int64_t last = (q_start + BQ - 1) / BK + 1;
    kt_end = last < n_kt ? last : n_kt;
  }
  int64_t kt_begin = 0;
  if (has_window) {
    const int64_t lo = q_start - window + 1;  // first key any row keeps
    if (lo > 0) kt_begin = lo / BK;
  }

  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k_start = kt * BK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < BK * d; i += THREADS) {
      const int r = i / d, c = i - r * d;
      ks[r * ld + c] = k_start + r < sk ? widen(kb[(k_start + r) * d + c]) : 0.f;
    }
    for (int i = tid; i < BK * ldv; i += THREADS) {
      const int r = i / ldv, c = i - r * ldv;
      vs[i] = (c < d && k_start + r < sk) ? widen(vb[(k_start + r) * d + c])
                                          : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[RPT], kk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = qs[(r0 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kk[j] = ks[(tx + 8 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int64_t qpos = q_start + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int64_t kpos = k_start + tx + 8 * j;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float corr = 1.f, sum = 0.f;
      float* prow = ps + (r0 + i) * (BK + 1);
      if (m_new == -INFINITY) {  // nothing kept in this row yet
#pragma unroll
        for (int j = 0; j < CPT; ++j) prow[tx + 8 * j] = 0.f;
      } else {
        corr = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float p = expf(s[i][j] - m_new);
          sum += p;
          prow[tx + 8 * j] = widen(narrow<T>(p));
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row's P is written and read by its own warp only

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = ps[(r0 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[kk * ldv + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q_start + r0 + i;
    if (row >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 8 * j;
      if (c < d) orow[c] = narrow<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int64_t batch,
           int n_heads, int n_kv_heads, int64_t sq, int64_t sk, int d,
           int causal, int has_window, int64_t window, float scale,
           cudaStream_t stream) {
  const int ld = d + 1;
  const size_t smem =
      sizeof(float) * (size_t)(BQ * ld + BK * ld + BK * 8 * NJ + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * n_heads), (unsigned)((sq + BQ - 1) / BQ));
  flash_fwd_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_heads,
      n_heads / n_kv_heads, sq, sk, d, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
             int64_t sk, int d, int causal, int has_window, int64_t window,
             float scale, cudaStream_t s) {
  const int nj = (d + 7) / 8;
#define FLASH_CASE(N)                                                        \
  return launch<T, N>(q, k, v, o, batch, n_heads, n_kv_heads, sq, sk, d,    \
                      causal, has_window, window, scale, s)
  if (nj <= 1) FLASH_CASE(1);
  if (nj <= 2) FLASH_CASE(2);
  if (nj <= 4) FLASH_CASE(4);
  if (nj <= 8) FLASH_CASE(8);
  if (nj <= 10) FLASH_CASE(10);
  if (nj <= 12) FLASH_CASE(12);
  if (nj <= 16) FLASH_CASE(16);
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, Sq, D], k/v [B, Hkv, Sk, D], o [B, H, Sq, D], all contiguous and
// of one type (0 float32, 1 bfloat16); D <= 128, H a multiple of Hkv,
// Sq <= 65535 * 64. Returns 0 on success, else the cudaError_t.
extern "C" int flash_attention_launch(int device, const void* q, const void* k,
                                      const void* v, void* o, long long batch,
                                      int n_heads, int n_kv_heads,
                                      long long sq, long long sk, int d,
                                      int dtype, int causal, int has_window,
                                      long long window, float scale,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch * n_heads * sq == 0) return 0;
  if (d < 1 || d > 128 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, batch, n_heads, n_kv_heads, sq, sk, d,
                             causal, has_window, window, scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, batch, n_heads, n_kv_heads,
                                     sq, sk, d, causal, has_window, window,
                                     scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
