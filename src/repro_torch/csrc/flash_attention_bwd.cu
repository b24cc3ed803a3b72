// Backward of the flash attention forward (csrc/flash_attention.cu) for
// Hopper (sm_90a).
//
// Given q [B, H, Sq, D], k/v [B, Hkv, Sk, D], the forward's output o and
// its f32 logsumexp lse [B, H, Sq], and the output's cotangent do, it
// computes what the JAX package's custom VJP _flash_bwd
// (src/repro/models/transformer/attention.py:188) computes, in f32:
//
//   delta_i = sum_d do_id o_id
//   P_ij    = exp(scale * q_i.k_j - lse_i) where key j is kept for query i,
//             else 0 (kept iff j < Sk, j <= i under causal, i - j < window
//             under a window: the forward's rule)
//   dV_j    = sum_i P_ij do_i           dP_ij = do_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i) scale
//   dQ_i    = sum_j dS_ij k_j           dK_j  = sum_i dS_ij q_i
//
// with the query heads of a GQA group folded onto their kv head (dK and dV
// summed over the group's H / Hkv heads). Inputs float32 or bfloat16 (each
// widened to f32), f32 accumulation, outputs in the input type. A row with
// no key kept has lse = +inf, so its P and its gradients are 0.
//
// Replaces: the TPU path has no backward kernel; _flash_bwd is plain JAX
// around the Pallas forward (src/repro/kernels/flash_attention/kernel.py:103).
//
// Bound on this card: operations. Five products of 2*D flops per kept
// (query, key) pair, 10*D in all; at h2o-danube's training shape
// (q [4, 32, 4096, 80], causal) about 0.87 ms at the 989 TFLOP/s bf16
// tensor-core rate. Both routes recompute S and dP in each of their two
// passes (14*D flops a pair); the f32 route runs them on the f32 units
// (67 TFLOP/s), the bf16 route on the tensor cores by mma.sync, without
// TMA or wgmma: right and simple, not yet a Hopper design (one pass,
// wgmma on TMA-loaded tiles), which is later work.
//
// Two routes, by dtype and D only (flash_attention_bwd_uses_tc): bf16
// with D % 16 == 0 on the tensor cores (namespace tcb, mma.sync), every
// other case on the f32 units (below). No config of the repo takes the
// f32 units in bf16 (h2o-danube's D = 80 and deepseek-moe's 128 are
// multiples of 16); its bf16 instantiations serve a bf16 head dim that
// is not, as the forward serves every D <= 128 (its tensor-core route
// takes D % 8 == 0, so D = 8, 24, 40, ... are tensor-core forwards with
// f32-unit backwards). Both routes share the passes:
//
// Design: deterministic, no atomics. Three kernels on one stream:
//   1. delta: one warp per query row, a fixed shuffle order.
//   2. dkdv: one block per (batch, kv head, 64-key tile); it walks the live
//      64-row query tiles of every query head of its group, in order, and
//      keeps dK and dV of its 64 keys in registers. Per query tile: S^T and
//      dP^T [key][query] from shared Q, dO, K, V tiles; P and dS to shared
//      memory; dV += P^T dO and dK += dS^T Q.
//   3. dq: one block per (batch, head, 64-row query tile); it walks the
//      live key tiles (the forward's rule) and keeps dQ in registers:
//      S and dP [query][key], dS to shared memory, dQ += dS K.
// Each output element is summed by one thread in a fixed order, so two
// runs agree bit for bit. Block: 256 threads, thread (ty, tx) = (tid / 16,
// tid % 16) owns rows 4ty..4ty+3 and columns tx, tx+16, ...; tiles staged
// in shared memory as f32 rows padded to D + 1 floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows of a query tile and of a key tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int RPT = 4;        // tile rows per thread
constexpr int CPT = BT / 16;  // tile columns per thread in S and dP

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

__device__ __forceinline__ bool kept(int64_t i, int64_t j, int64_t sq,
                                     int64_t sk, int causal, int has_window,
                                     int64_t window) {
  bool ok = i < sq && j < sk;
  if (causal) ok = ok && j <= i;
  if (has_window) ok = ok && i - j < window;
  return ok;
}

// rows [row0, row0 + BT) of a [rows, d] matrix into shared f32 [BT][d + 1],
// zero past `rows`
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t row0,
                                      int64_t rows, int d) {
  const int ld = d + 1;
  for (int i = threadIdx.x; i < BT * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = row0 + r < rows ? widen(src[(row0 + r) * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = blockIdx.x * (int64_t)(THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(widen(dout[row * d + c]), widen(o[row * d + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// dK and dV of one 64-key tile of one kv head, over its group's query heads
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int n_heads, int n_rep,
                int64_t sq, int64_t sk, int d, int causal, int has_window,
                int64_t window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;               // [BT][ld]
  float* vs = ks + BT * ld;       // [BT][ld]
  float* qs = vs + BT * ld;       // [BT][ld]
  float* dos = qs + BT * ld;      // [BT][ld]
  float* ps = dos + BT * ld;      // [key][query], [BT][BT + 1]
  float* dss = ps + BT * (BT + 1);
  float* lse_s = dss + BT * (BT + 1);  // [BT]
  float* delta_s = lse_s + BT;         // [BT]

  const int64_t bkv = blockIdx.x;  // b * Hkv + g
  const int n_kv = n_heads / n_rep;
  const int64_t b = bkv / n_kv;
  const int g = (int)(bkv - b * n_kv);
  const int64_t k0 = (int64_t)blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, r0 = (tid / 16) * RPT;

  stage(ks, k + bkv * sk * d, k0, sk, d);
  stage(vs, v + bkv * sk * d, k0, sk, d);

  // the query tiles that keep any key of this tile
  const int64_t n_qt = (sq + BT - 1) / BT;
  const int64_t qt_begin = causal ? k0 / BT : 0;
  int64_t qt_end = n_qt;
  if (has_window) {
    const int64_t last = k0 + BT - 1 + window - 1;  // last query any key keeps
    const int64_t e = last < 0 ? 0 : last / BT + 1;
    qt_end = e < qt_end ? e : qt_end;
  }

  float acc_k[RPT][NJ], acc_v[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int hr = 0; hr < n_rep; ++hr) {
    const int64_t bh = b * n_heads + (int64_t)g * n_rep + hr;
    const T* qh = q + bh * sq * d;
    const T* doh = dout + bh * sq * d;
    for (int64_t qt = qt_begin; qt < qt_end; ++qt) {
      const int64_t q0 = qt * BT;
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage(qs, qh, q0, sq, d);
      stage(dos, doh, q0, sq, d);
      if (tid < BT) {
        lse_s[tid] = q0 + tid < sq ? lse[bh * sq + q0 + tid] : INFINITY;
        delta_s[tid] = q0 + tid < sq ? delta[bh * sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys r0 + i, queries tx + 16 j
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        float kk[RPT], vv[RPT], qq[CPT], oo[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kk[i] = ks[(r0 + i) * ld + c];
          vv[i] = vs[(r0 + i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qq[j] = qs[(tx + 16 * j) * ld + c];
          oo[j] = dos[(tx + 16 * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int qi = tx + 16 * j;
          const bool ok = kept(q0 + qi, k0 + r0 + i, sq, sk, causal, has_window, window);
          const float p = ok ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
          ps[(r0 + i) * (BT + 1) + qi] = p;
          dss[(r0 + i) * (BT + 1) + qi] = p * (dp[i][j] - delta_s[qi]) * scale;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q for keys r0 + i, columns tx + 16 j
#pragma unroll 2
      for (int qi = 0; qi < BT; ++qi) {
        float p[RPT], ds[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          p[i] = ps[(r0 + i) * (BT + 1) + qi];
          ds[i] = dss[(r0 + i) * (BT + 1) + qi];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          const float o_c = c < d ? dos[qi * ld + c] : 0.f;
          const float q_c = c < d ? qs[qi * ld + c] : 0.f;
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc_v[i][j] = fmaf(p[i], o_c, acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], q_c, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t key = k0 + r0 + i;
    if (key >= sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= d) continue;
      dk[(bkv * sk + key) * d + c] = narrow<T>(acc_k[i][j]);
      dv[(bkv * sk + key) * d + c] = narrow<T>(acc_v[i][j]);
    }
  }
}

// dQ of one 64-row query tile of one head, over its live key tiles
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int n_heads, int n_rep, int64_t sq,
              int64_t sk, int d, int causal, int has_window, int64_t window,
              float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;               // [BT][ld]
  float* dos = qs + BT * ld;      // [BT][ld]
  float* ks = dos + BT * ld;      // [BT][ld]
  float* vs = ks + BT * ld;       // [BT][ld]
  float* dss = vs + BT * ld;      // [query][key], [BT][BT + 1]

  const int64_t bh = blockIdx.x;  // b * H + h
  const int64_t b = bh / n_heads;
  const int h = (int)(bh - b * n_heads);
  const int64_t bkv = b * (n_heads / n_rep) + h / n_rep;
  const int64_t q0 = (int64_t)blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, r0 = (tid / 16) * RPT;

  stage(qs, q + bh * sq * d, q0, sq, d);
  stage(dos, dout + bh * sq * d, q0, sq, d);
  float row_lse[RPT], row_delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q0 + r0 + i;
    row_lse[i] = row < sq ? lse[bh * sq + row] : INFINITY;
    row_delta[i] = row < sq ? delta[bh * sq + row] : 0.f;
  }

  // the live key tiles of this query tile, the forward's rule
  const int64_t n_kt = (sk + BT - 1) / BT;
  int64_t kt_end = n_kt;
  if (causal) {
    const int64_t last = (q0 + BT - 1) / BT + 1;
    kt_end = last < n_kt ? last : n_kt;
  }
  int64_t kt_begin = 0;
  if (has_window) {
    const int64_t lo = q0 - window + 1;  // first key any row keeps
    if (lo > 0) kt_begin = lo / BT;
  }

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * BT;
    __syncthreads();  // the previous tile is consumed (and Q, dO staged)
    stage(ks, k + bkv * sk * d, k0, sk, d);
    stage(vs, v + bkv * sk * d, k0, sk, d);
    __syncthreads();

    // S and dP for queries r0 + i, keys tx + 16 j
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qq[RPT], oo[RPT], kk[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qq[i] = qs[(r0 + i) * ld + c];
        oo[i] = dos[(r0 + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kk[j] = ks[(tx + 16 * j) * ld + c];
        vv[j] = vs[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kj = tx + 16 * j;
        const bool ok = kept(q0 + r0 + i, k0 + kj, sq, sk, causal, has_window, window);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[(r0 + i) * (BT + 1) + kj] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    __syncthreads();

    // dQ += dS K for queries r0 + i, columns tx + 16 j
#pragma unroll 2
    for (int kj = 0; kj < BT; ++kj) {
      float ds[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) ds[i] = dss[(r0 + i) * (BT + 1) + kj];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float k_c = c < d ? ks[kj * ld + c] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(ds[i], k_c, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q0 + r0 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dq[(bh * sq + row) * d + c] = narrow<T>(acc[i][j]);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
           int64_t sk, int d, int causal, int has_window, int64_t window,
           float scale, cudaStream_t stream) {
  const int ld = d + 1;
  const size_t tile = sizeof(float) * (size_t)BT * ld;
  const size_t grid_tile = sizeof(float) * (size_t)BT * (BT + 1);
  const size_t smem_dkdv = 4 * tile + 2 * grid_tile + 2 * sizeof(float) * BT;
  const size_t smem_dq = 4 * tile + grid_tile;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  const int n_rep = n_heads / n_kv_heads;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const int64_t rows = batch * n_heads * sq;
  const int64_t rows_per_block = THREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), THREADS, 0,
                    stream>>>(static_cast<const T*>(o), dot, delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    const dim3 grid_kv((unsigned)(batch * n_kv_heads), (unsigned)((sk + BT - 1) / BT));
    dkdv_kernel<T, NJ><<<grid_kv, THREADS, smem_dkdv, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n_heads,
        n_rep, sq, sk, d, causal, has_window, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((unsigned)(batch * n_heads), (unsigned)((sq + BT - 1) / BT));
  dq_kernel<T, NJ><<<grid_q, THREADS, smem_dq, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), n_heads, n_rep, sq, sk, d,
      causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk,
             void* dv, int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
             int64_t sk, int d, int causal, int has_window, int64_t window,
             float scale, cudaStream_t s) {
  const int nj = (d + 15) / 16;
#define BWD_CASE(N)                                                              \
  return launch<T, N>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n_heads,  \
                      n_kv_heads, sq, sk, d, causal, has_window, window, scale, s)
  if (nj <= 1) BWD_CASE(1);
  if (nj <= 2) BWD_CASE(2);
  if (nj <= 3) BWD_CASE(3);
  if (nj <= 4) BWD_CASE(4);
  if (nj <= 5) BWD_CASE(5);
  if (nj <= 6) BWD_CASE(6);
  if (nj <= 7) BWD_CASE(7);
  if (nj <= 8) BWD_CASE(8);
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// ---- tensor-core route: bf16 with D % 16 == 0 ---------------------------
//
// The same two passes with every product on the tensor cores by
// mma.sync.m16n8k16 (bf16 in, f32 accumulate): a block of 4 warps, each
// warp 16 rows of the block's 64-row tile; K, V, Q and dO tiles staged in
// shared memory as bf16 (rows padded by 8 elements), Q, dO (dkdv) and K
// (dq) also transposed, so that every fragment is one 32-bit shared load.
// S and dP come out of the products in the accumulator layout, which is
// also the A-operand layout of the next product: P and dS are rounded to
// bf16 in registers and multiplied on without a trip through shared
// memory (the JAX function keeps them in f32: a rounding of 2^-9 relative
// per term, well inside the row check). Still two passes, no atomics.
namespace tcb {

constexpr int BT = 64;       // rows of a query tile and of a key tile
constexpr int WARPS = 4;     // 16 tile rows each
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows [row0, row0 + BT) of a bf16 [rows, D] matrix into shared [BT][D + 8]
// and, with `tr`, its transpose into [D][BT + 8]; zero past `rows`
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, __nv_bfloat16* tr,
                                      const __nv_bfloat16* src, int64_t row0,
                                      int64_t rows) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BT * CH; i += THREADS) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c + j) * (BT + 8) + r] = e[j];
    }
  }
}

// acc[j] (j over 8 column tiles of 8) += A (16 rows of `a`, row stride
// lda) · B, where B's column n, row k is b[n * ldb + k]: K = D
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[BT / 8][4],
                                             const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* b, int ldb,
                                             int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* ar = a + g * lda + kk * 16 + 2 * t;
    const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * lda);
    const uint32_t a2 = ld32(ar + 8), a3 = ld32(ar + 8 * lda + 8);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const __nv_bfloat16* br = b + (8 * j + g) * ldb + kk * 16 + 2 * t;
      mma(acc[j], a0, a1, a2, a3, ld32(br), ld32(br + 8));
    }
  }
}

// out[jd] (jd over D/8 column tiles) += X (16 x BT, from the accumulator
// fragments x) · B, where B's column n, row k is bt[n * (BT + 8) + k]
template <int D>
__device__ __forceinline__ void regs_by_rows(float (&out)[D / 8][4],
                                             const float (&x)[BT / 8][4],
                                             const __nv_bfloat16* bt, int g,
                                             int t) {
#pragma unroll
  for (int kq = 0; kq < BT / 16; ++kq) {
    const uint32_t a0 = pack(x[2 * kq][0], x[2 * kq][1]);
    const uint32_t a1 = pack(x[2 * kq][2], x[2 * kq][3]);
    const uint32_t a2 = pack(x[2 * kq + 1][0], x[2 * kq + 1][1]);
    const uint32_t a3 = pack(x[2 * kq + 1][2], x[2 * kq + 1][3]);
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const __nv_bfloat16* br = bt + (8 * jd + g) * (BT + 8) + kq * 16 + 2 * t;
      mma(out[jd], a0, a1, a2, a3, ld32(br), ld32(br + 8));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dkdv_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int n_heads, int n_rep, int64_t sq, int64_t sk, int causal,
            int has_window, int64_t window, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  constexpr int LD = D + 8, LT = BT + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BT * LD;
  __nv_bfloat16* qs = vs + BT * LD;
  __nv_bfloat16* dos = qs + BT * LD;
  __nv_bfloat16* qt = dos + BT * LD;   // [D][LT]
  __nv_bfloat16* dot = qt + D * LT;    // [D][LT]
  float* lse_s = reinterpret_cast<float*>(dot + D * LT);
  float* delta_s = lse_s + BT;

  const int64_t bkv = blockIdx.x;
  const int n_kv = n_heads / n_rep;
  const int64_t b = bkv / n_kv;
  const int gh = (int)(bkv - b * n_kv);
  const int64_t k0 = (int64_t)blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // the warp's first key of the tile

  stage<D>(ks, nullptr, k + bkv * sk * D, k0, sk);
  stage<D>(vs, nullptr, v + bkv * sk * D, k0, sk);

  const int64_t n_qt = (sq + BT - 1) / BT;
  const int64_t qt_begin = causal ? k0 / BT : 0;
  int64_t qt_end = n_qt;
  if (has_window) {
    const int64_t last = k0 + BT - 1 + window - 1;
    const int64_t e = last < 0 ? 0 : last / BT + 1;
    qt_end = e < qt_end ? e : qt_end;
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int hr = 0; hr < n_rep; ++hr) {
    const int64_t bh = b * n_heads + (int64_t)gh * n_rep + hr;
    for (int64_t qtile = qt_begin; qtile < qt_end; ++qtile) {
      const int64_t q0 = qtile * BT;
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage<D>(qs, qt, q + bh * sq * D, q0, sq);
      stage<D>(dos, dot, dout + bh * sq * D, q0, sq);
      if (threadIdx.x < BT) {
        const int64_t row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < sq ? lse[bh * sq + row] : INFINITY;
        delta_s[threadIdx.x] = row < sq ? delta[bh * sq + row] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T of the warp's 16 keys x the tile's 64 queries
      float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      rows_by_rows<D>(s, ks + r0 * LD, LD, qs, LD, g, t);
      rows_by_rows<D>(dp, vs + r0 * LD, LD, dos, LD, g, t);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const int64_t key = k0 + r0 + g + 8 * (e >> 1);
          const bool ok = kept(q0 + qi, key, sq, sk, causal, has_window, window);
          const float p = ok ? expf(s[j][e] * scale - lse_s[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[qi]) * scale;
        }
      // dV += P^T dO, dK += dS^T Q
      regs_by_rows<D>(acc_v, s, dot, g, t);
      regs_by_rows<D>(acc_k, dp, qt, g, t);
    }
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int64_t key = k0 + r0 + g + 8 * e2;
    if (key >= sk) continue;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int c = 8 * jd + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + (bkv * sk + key) * D + c) =
          __floats2bfloat162_rn(acc_k[jd][2 * e2], acc_k[jd][2 * e2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (bkv * sk + key) * D + c) =
          __floats2bfloat162_rn(acc_v[jd][2 * e2], acc_v[jd][2 * e2 + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dq_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int n_heads, int n_rep, int64_t sq,
          int64_t sk, int causal, int has_window, int64_t window, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  constexpr int LD = D + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BT * LD;
  __nv_bfloat16* ks = dos + BT * LD;
  __nv_bfloat16* vs = ks + BT * LD;
  __nv_bfloat16* kt = vs + BT * LD;  // [D][BT + 8]

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / n_heads;
  const int h = (int)(bh - b * n_heads);
  const int64_t bkv = b * (n_heads / n_rep) + h / n_rep;
  const int64_t q0 = (int64_t)blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // the warp's first query of the tile

  stage<D>(qs, nullptr, q + bh * sq * D, q0, sq);
  stage<D>(dos, nullptr, dout + bh * sq * D, q0, sq);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int64_t row = q0 + r0 + g + 8 * e2;
    row_lse[e2] = row < sq ? lse[bh * sq + row] : INFINITY;
    row_delta[e2] = row < sq ? delta[bh * sq + row] : 0.f;
  }

  const int64_t n_kt = (sk + BT - 1) / BT;
  int64_t kt_end = n_kt;
  if (causal) {
    const int64_t last = (q0 + BT - 1) / BT + 1;
    kt_end = last < n_kt ? last : n_kt;
  }
  int64_t kt_begin = 0;
  if (has_window) {
    const int64_t lo = q0 - window + 1;
    if (lo > 0) kt_begin = lo / BT;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int64_t ktile = kt_begin; ktile < kt_end; ++ktile) {
    const int64_t k0 = ktile * BT;
    __syncthreads();  // the previous tile is consumed (and Q, dO staged)
    stage<D>(ks, kt, k + bkv * sk * D, k0, sk);
    stage<D>(vs, nullptr, v + bkv * sk * D, k0, sk);
    __syncthreads();

    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_by_rows<D>(s, qs + r0 * LD, LD, ks, LD, g, t);
    rows_by_rows<D>(dp, dos + r0 * LD, LD, vs, LD, g, t);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = k0 + 8 * j + 2 * t + (e & 1);
        const int e2 = e >> 1;
        const bool ok = kept(q0 + r0 + g + 8 * e2, key, sq, sk, causal, has_window,
                             window);
        const float p = ok ? expf(s[j][e] * scale - row_lse[e2]) : 0.f;
        dp[j][e] = p * (dp[j][e] - row_delta[e2]) * scale;
      }
    regs_by_rows<D>(acc, dp, kt, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int64_t row = q0 + r0 + g + 8 * e2;
    if (row >= sq) continue;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(dq + (bh * sq + row) * D + 8 * jd + 2 * t) =
          __floats2bfloat162_rn(acc[jd][2 * e2], acc[jd][2 * e2 + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int64_t batch,
           int n_heads, int n_kv_heads, int64_t sq, int64_t sk, int causal,
           int has_window, int64_t window, float scale, cudaStream_t stream) {
  constexpr size_t tile = sizeof(__nv_bfloat16) * BT * (D + 8);
  constexpr size_t ttile = sizeof(__nv_bfloat16) * D * (BT + 8);
  constexpr size_t smem_dkdv = 4 * tile + 2 * ttile + 2 * sizeof(float) * BT;
  constexpr size_t smem_dq = 4 * tile + ttile;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  const int n_rep = n_heads / n_kv_heads;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(dout);
  const int64_t rows = batch * n_heads * sq;
  const int64_t rows_per_block = ::THREADS / 32;  // the delta kernel's block
  delta_kernel<__nv_bfloat16>
      <<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), ::THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(o), dob, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    const dim3 grid_kv((unsigned)(batch * n_kv_heads), (unsigned)((sk + BT - 1) / BT));
    dkdv_tc<D><<<grid_kv, THREADS, smem_dkdv, stream>>>(
        qb, kb, vb, dob, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n_heads, n_rep, sq, sk, causal, has_window,
        window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((unsigned)(batch * n_heads), (unsigned)((sq + BT - 1) / BT));
  dq_tc<D><<<grid_q, THREADS, smem_dq, stream>>>(
      qb, kb, vb, dob, lse, delta, static_cast<__nv_bfloat16*>(dq), n_heads, n_rep, sq,
      sk, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace tcb

}  // namespace

// 1 where (dtype, d) takes the tensor-core route: bf16 with D % 16 == 0
// (the wrapper's bwd_route states the same rule).
extern "C" int flash_attention_bwd_uses_tc(int dtype, int d) {
  return dtype == 1 && d >= 16 && d <= 128 && d % 16 == 0;
}

// q, o, dout, dq [B, H, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D], all contiguous
// and of one type (0 float32, 1 bfloat16); lse f32 [B, H, Sq] from the
// forward; delta f32 [B, H, Sq] scratch. D <= 128, H a multiple of Hkv,
// Sq and Sk / 64 within the grid's y limit; on the tensor-core route the
// bf16 tensors 16-byte aligned. Returns 0 on success, else the cudaError_t.
extern "C" int flash_attention_bwd_launch(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
    long long batch, int n_heads, int n_kv_heads, long long sq, long long sk, int d,
    int dtype, int causal, int has_window, long long window, float scale,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      (sq + BT - 1) / BT > 65535 || (sk + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch * n_heads * sq == 0) {
    if (batch * n_kv_heads * sk == 0) return 0;
    // no query: dK = dV = 0
    const size_t bytes = (size_t)(batch * n_kv_heads * sk * d) * (dtype == 0 ? 4 : 2);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(dk, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(dv, 0, bytes, s);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attention_bwd_uses_tc(dtype, d)) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
         reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
         reinterpret_cast<uintptr_t>(dv)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    switch (d) {
#define TC_CASE(D)                                                                  \
  case D:                                                                           \
    return tcb::launch<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n_heads, \
                          n_kv_heads, sq, sk, causal, has_window, window, scale, s)
      TC_CASE(16); TC_CASE(32); TC_CASE(48); TC_CASE(64);
      TC_CASE(80); TC_CASE(96); TC_CASE(112); TC_CASE(128);
#undef TC_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n_heads,
                             n_kv_heads, sq, sk, d, causal, has_window, window, scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                                     n_heads, n_kv_heads, sq, sk, d, causal, has_window,
                                     window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
