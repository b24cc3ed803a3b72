// Backward of the flash attention forward (csrc/flash_attention.cu) for
// Hopper (sm_90a).
//
// Given q [B, H, Sq, D], k/v [B, Hkv, Sk, D], the forward's output o and
// its f32 logsumexp lse [B, H, Sq], and the output's cotangent do, it
// computes what the JAX package's custom VJP _flash_bwd
// (src/repro/models/transformer/attention.py:188) computes, in f32:
//
//   delta_i = sum_d do_id o_id
//   P_ij    = exp(scale * r(q_i.k_j) - lse_i) where key j is kept for query
//             i, else 0 (kept iff j < Sk, j <= i under causal, i - j < window
//             under a window: the forward's rule); r rounds the f32 product
//             to the inputs' type under round_scores (as the forward did;
//             JAX's bf16 einsum rounds so), else r(x) = x
//   dV_j    = sum_i P_ij do_i           dP_ij = do_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i) scale
//   dQ_i    = sum_j dS_ij k_j           dK_j  = sum_i dS_ij q_i
//
// with the query heads of a GQA group folded onto their kv head (dK and dV
// summed over the group's H / Hkv heads). Inputs float32 or bfloat16, f32
// accumulation, outputs in the input type. A row with no key kept has
// lse = +inf, so its P and its gradients are 0.
//
// Replaces no Pallas kernel: the TPU path has no backward kernel, and
// _flash_bwd is plain JAX around the Pallas forward
// (src/repro/kernels/flash_attention/kernel.py:103).
//
// Bound on this card: operations. Five products of 2*D flops per kept
// (query, key) pair, 10*D in all; at h2o-danube's training shape
// (q [4, 32, 4096, 80], causal) about 0.87 ms at the 989 TFLOP/s bf16
// tensor-core rate.
//
// Two routes, by dtype and D only (flash_attention_bwd_uses_tc), the
// forward's rule: bf16 with D % 8 == 0 on the tensor cores (namespace
// tcb), every other case on the f32 units (the anonymous namespace).
//
// * tcb, the tensor-core route: FlashAttention-3's backward, kept
//   deterministic; one pass at 10*D flops a pair.
//   - Grid: one block per (batch, kv head, 128-key tile), 384 threads: two
//     consumer warpgroups of 64 keys each and a producer warpgroup. The
//     block walks the live 64-row query tiles (the forward's skip rule
//     seen from the key side) of every query head of its GQA group, in
//     order, and keeps dK and dV of its keys in registers throughout.
//   - Producer: one thread loads K and V once, then streams Q and dO
//     tiles with their lse and delta rows through a ring of STAGES stages
//     (TMA from 3-D tensor maps, boxes of 16 columns, SWIZZLE_32B, rows
//     past Sq or Sk and columns past D read as zero, as the forward's;
//     the rows by a 1-D bulk copy), full/empty mbarriers. A second
//     producer warp does the ordered dQ adds (below). setmaxnreg: 24
//     registers for the producer warpgroup, 240 for the consumers.
//   - Products by wgmma, per warpgroup and query tile: S^T = K Q^T and
//     dP^T = V dO^T (m64n64k16, both operands K-major as TMA wrote them);
//     P^T and dS^T rounded to bf16 straight from the accumulator
//     fragments, which are wgmma's A-from-registers layout; dV += P^T dO
//     and dK += dS^T Q (m64nDPk16, B MN-major in the tiles TMA wrote: no
//     transposed copy is staged). The scale of dS multiplies dK once at
//     the end and dQ in the last pass.
//   - dQ with no second recompute: both warpgroups write dS^T to shared
//     memory once (bf16, swizzled as TMA swizzles, the MN-major A of the
//     next product); then dQ = dS K over the block's 128 keys (each
//     warpgroup half of D's chunks, m64nNk16, both operands MN-major)
//     goes to shared memory as f32, and the second producer warp adds it
//     into an f32 accumulator [B*H, q tiles, 64, DP] in global memory by
//     one bulk reduce (the first key tile stores instead). The order is
//     fixed: the key tiles of each query tile add in ascending order, each
//     waiting on a counter per (batch, head, query tile) for the ones
//     before it, so no sum depends on the order in which blocks run. Key
//     tiles are blockIdx.y, kv heads blockIdx.x: a block only ever waits
//     on blocks launched before it.
//   - FLASH_BWD_UNORDERED (defined only by chip_smoke.py --flash-bwd, to
//     time what the order costs; never in the built library) drops the
//     waits: every key tile adds onto a zeroed accumulator as it comes,
//     FlashAttention-3's non-deterministic mode, whose sums vary run to run.
//   - Three launches: delta (and lse in log2 units) per row into padded
//     [B*H, 64-row tiles] arrays (+inf / 0 past Sq, so rows past Sq take
//     P = 0 unmasked); the kernel; dQ = scale * accumulator in the input
//     type (0 for a query tile that no key tile meets).
//
// * the f32 units (f32, or bf16 with D % 8 != 0): three kernels on one
//   stream, deterministic, no atomics:
//   1. delta: one warp per query row, a fixed shuffle order.
//   2. dkdv: one block per (batch, kv head, 64-key tile); it walks the live
//      64-row query tiles of every query head of its group, in order, and
//      keeps dK and dV of its 64 keys in registers. Per query tile: S^T and
//      dP^T [key][query] from shared Q, dO, K, V tiles; P and dS to shared
//      memory; dV += P^T dO and dK += dS^T Q.
//   3. dq: one block per (batch, head, 64-row query tile); it walks the
//      live key tiles (the forward's rule) and keeps dQ in registers:
//      S and dP [query][key], dS to shared memory, dQ += dS K.
//   Each output element is summed by one thread in a fixed order (14*D
//   flops a pair: S and dP in both passes). Block: 256 threads, thread
//   (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3 and columns tx,
//   tx+16, ...; tiles staged in shared memory as f32 rows padded to D + 1.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
                int64_t window, float scale, int round_scores) {
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
          const float raw = round_scores ? widen(narrow<T>(s[i][j])) : s[i][j];
          const float p = ok ? expf(raw * scale - lse_s[qi]) : 0.f;
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
              float scale, int round_scores) {
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
        const float raw = round_scores ? widen(narrow<T>(s[i][j])) : s[i][j];
        const float p = ok ? expf(raw * scale - row_lse[i]) : 0.f;
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
           float scale, int round_scores, cudaStream_t stream) {
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
        n_rep, sq, sk, d, causal, has_window, window, scale, round_scores);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((unsigned)(batch * n_heads), (unsigned)((sq + BT - 1) / BT));
  dq_kernel<T, NJ><<<grid_q, THREADS, smem_dq, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), n_heads, n_rep, sq, sk, d,
      causal, has_window, window, scale, round_scores);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk,
             void* dv, int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
             int64_t sk, int d, int causal, int has_window, int64_t window,
             float scale, int round_scores, cudaStream_t s) {
  const int nj = (d + 15) / 16;
#define BWD_CASE(N)                                                              \
  return launch<T, N>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n_heads,  \
                      n_kv_heads, sq, sk, d, causal, has_window, window, scale,  \
                      round_scores, s)
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


}  // namespace

namespace tcb {

using namespace hopper;

constexpr int BQ = 64;          // query rows a step
constexpr int BK = 128;         // keys a block
constexpr int WG_KEYS = 64;     // keys a consumer warpgroup
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int PRODUCER_WARP = CONSUMERS * 4;  // issues the loads
constexpr int DQ_WARP = PRODUCER_WARP + 1;    // issues the ordered dQ adds
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 2;       // Q/dO ring depth
constexpr uint32_t KBOX = BK * CHUNK * 2;     // one 128-row box: 4 KB
constexpr uint32_t QBOX = BQ * CHUNK * 2;     // one 64-row box: 2 KB
constexpr uint32_t DS_BYTES = (BQ / CHUNK) * KBOX;  // dS^T, bf16 [128 keys][64]
constexpr uint32_t ROWS_BYTES = 2 * BQ * 4;   // a stage's lse and delta rows
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

// The live tiles, the forward's rule (a key tile [k0, k0 + BK) is live for
// a query tile [q0, q0 + BQ) iff k0 <= q0 + BQ - 1 under causal and
// k0 + BK - 1 >= q0 - window + 1 under a window), from either side.
// kernels/flash_attention/ops.py's bwd_schedule states the same.
__host__ __device__ __forceinline__ void key_tiles(int qt, int sk, int causal,
                                                   int has_window, int window,
                                                   int& begin, int& end) {
  const long long q0 = (long long)qt * BQ;
  const int n_kt = (sk + BK - 1) / BK;
  end = n_kt;
  if (causal) end = (int)min((long long)n_kt, (q0 + BQ - 1) / BK + 1);
  begin = 0;
  if (has_window) {
    const long long lo = q0 - window + 1;  // first key any row keeps
    if (lo > 0) begin = (int)(lo / BK);
  }
}
__host__ __device__ __forceinline__ void query_tiles(int kt, int sq, int causal,
                                                     int has_window, int window,
                                                     int& begin, int& end) {
  const long long k0 = (long long)kt * BK;
  const int n_qt = (sq + BQ - 1) / BQ;
  begin = causal ? (int)min((long long)n_qt, k0 / BQ) : 0;
  end = n_qt;
  if (has_window) {
    const long long last = k0 + BK - 1 + window - 1;  // last query any key keeps
    end = last < 0 ? 0 : (int)min((long long)n_qt, last / BQ + 1);
  }
  if (end < begin) end = begin;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// Named barrier 1: the two consumer warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// Per padded row r of [B*H, n_qt * BQ]: delta = sum_d do*o and lse in log2
// units for r < Sq; delta 0 and lse +inf past Sq (so P = 0 there). One warp
// a row, a fixed shuffle order.
__global__ void __launch_bounds__(256)
    rows_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, long long rows, int sq, int sq_pad, int d) {
  const long long row = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / sq_pad;
  const int r = (int)(row - bh * sq_pad);
  float acc = 0.f;
  if (r < sq) {
    const long long src = (bh * sq + r) * d;
    for (int c = lane; c < d; c += 32)
      acc = fmaf(__bfloat162float(dout[src + c]), __bfloat162float(o[src + c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = r < sq ? lse[bh * sq + r] * LOG2E : INFINITY;
  }
}

// dq = scale * the accumulator, in bf16; 0 for a query tile that no key
// tile meets (the accumulator holds nothing there). One thread per 8
// columns of a row.
__global__ void __launch_bounds__(256)
    dq_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
              long long rows, int sq, int sk, int d, int dp, int causal,
              int has_window, int window, float scale) {
  const int groups = d / 8;
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= rows * groups) return;
  const long long row = i / groups;  // bh * sq + r
  const int c = (int)(i - row * groups) * 8;
  const long long bh = row / sq;
  const int r = (int)(row - bh * sq);
  const int qt = r / BQ, n_qt = (sq + BQ - 1) / BQ;
  int kt_begin, kt_end;
  key_tiles(qt, sk, causal, has_window, window, kt_begin, kt_end);
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (kt_begin < kt_end) {
    const float4* src = reinterpret_cast<const float4*>(
        acc + ((bh * n_qt + qt) * BQ + r % BQ) * dp + c);
    const float4 a = src[0], b = src[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  uint4 out;
  out.x = pack_bf16(v[0] * scale, v[1] * scale);
  out.y = pack_bf16(v[2] * scale, v[3] * scale);
  out.z = pack_bf16(v[4] * scale, v[5] * scale);
  out.w = pack_bf16(v[6] * scale, v[7] * scale);
  *reinterpret_cast<uint4*>(dq + row * d + c) = out;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_tc(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap domap,
           const float* __restrict__ lse2, const float* __restrict__ delta,
           float* __restrict__ dq_acc, int* __restrict__ counters,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int n_heads, int n_rep, int sq, int sk, int d, int causal,
           int has_window, int window, float scale, float scale_log2,
           int round_scores) {
  constexpr int NC = DP / CHUNK;         // chunks of 16 columns of D
  constexpr int NCQ = (NC + 1) / 2;      // chunks of dQ a warpgroup computes
  constexpr uint32_t KT = NC * KBOX;     // a K or V tile
  constexpr uint32_t QT = NC * QBOX;     // a Q or dO tile
  constexpr uint32_t DQ_BYTES = BQ * DP * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + KT;
  const uint32_t q_s = v_s + KT;                 // + stage * QT
  const uint32_t do_s = q_s + STAGES * QT;       // + stage * QT
  const uint32_t ds_s = do_s + STAGES * QT;      // + (step & 1) * DS_BYTES
  const uint32_t dq_s = ds_s + 2 * DS_BYTES;     // + (step & 1) * DQ_BYTES
  const uint32_t rows_s = dq_s + 2 * DQ_BYTES;   // + stage * ROWS_BYTES
  const uint32_t bars = rows_s + STAGES * ROWS_BYTES;
  uint8_t* const gen = smem_raw + (base - raw);  // generic pointer of `base`
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto dq_full = [&](int b) { return bars + 8u * (1 + 2 * STAGES + b); };
  auto dq_empty = [&](int b) { return bars + 8u * (3 + 2 * STAGES + b); };

  const int bkv = blockIdx.x;  // b * Hkv + kv head
  const int kt = blockIdx.y;
  const int n_kv = n_heads / n_rep;
  const int b = bkv / n_kv;
  const int h0 = b * n_heads + (bkv - b * n_kv) * n_rep;  // the group's first b*H + h
  const int k0 = kt * BK;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int sq_pad = n_qt * BQ;
  int qt_begin, qt_end;
  query_tiles(kt, sq, causal, has_window, window, qt_begin, qt_end);
  const int n_q = qt_end - qt_begin;
  const int steps = n_rep * n_q;  // step i: head h0 + i / n_q, tile qt_begin + i % n_q

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(dq_full(i), CONSUMERS * 4);
      mbar_init(dq_empty(i), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= PRODUCER_WARP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == PRODUCER_WARP && lane == 0) {
      // ---- loads: K and V once, then Q, dO and their rows per step ----
      mbar_expect_tx(kv_full, 2 * KT);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load(k_s + c * KBOX, &kmap, c * CHUNK, k0, bkv, kv_full);
        tma_load(v_s + c * KBOX, &vmap, c * CHUNK, k0, bkv, kv_full);
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES;
        const int hr = i / n_q;
        const int bh = h0 + hr;
        const int q0 = (qt_begin + i - hr * n_q) * BQ;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * QT + ROWS_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load(q_s + s * QT + c * QBOX, &qmap, c * CHUNK, q0, bh, full(s));
          tma_load(do_s + s * QT + c * QBOX, &domap, c * CHUNK, q0, bh, full(s));
        }
        const long long row = (long long)bh * sq_pad + q0;
        bulk_load(rows_s + s * ROWS_BYTES, lse2 + row, BQ * 4, full(s));
        bulk_load(rows_s + s * ROWS_BYTES + BQ * 4, delta + row, BQ * 4, full(s));
      }
    } else if (warp == DQ_WARP && lane == 0) {
      // ---- the ordered dQ adds: key tiles in ascending order per query tile ----
      for (int i = 0; i < steps; ++i) {
        const int buf = i & 1;
        const int hr = i / n_q;
        const int qt = qt_begin + i - hr * n_q;
        const long long tile = (long long)(h0 + hr) * n_qt + qt;
        int kt_first, kt_end;
        key_tiles(qt, sk, causal, has_window, window, kt_first, kt_end);
        const int before = kt - kt_first;  // key tiles that add before this one
        mbar_wait(dq_full(buf), (i >> 1) & 1);
#ifndef FLASH_BWD_UNORDERED
        if (before > 0) {
          long long t0 = 0;
          while (ld_acquire(counters + tile) != before) {
            if (t0 == 0) {
              t0 = clock64();
            } else if (clock64() - t0 > 20000000000LL) {
              __trap();  // an ordering fault: end the launch, do not hang
            }
          }
        }
        const bool add = before > 0;
#else
        const bool add = true;  // in any order, onto a zeroed accumulator
#endif
        fence_async_global();
        bulk_store_f32(dq_acc + tile * (BQ * DP), dq_s + buf * DQ_BYTES, DQ_BYTES, add);
        bulk_wait();
        mbar_arrive(dq_empty(buf));
        fence_async_global();
        __threadfence();
        st_release(counters + tile, before + 1);
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 keys ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4, wl = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int kw = k0 + wg * WG_KEYS;         // the warpgroup's first key
    const int key0 = kw + wl * 16 + g;        // this thread's keys: key0, key0 + 8
    const uint32_t k_wg = k_s + wg * WG_KEYS * 32;
    const uint32_t v_wg = v_s + wg * WG_KEYS * 32;
    const int c0 = wg == 0 ? 0 : NC - NCQ;    // the warpgroup's first dQ chunk
    const float* rows_g = reinterpret_cast<const float*>(gen + (rows_s - base));
    float* dq_g = reinterpret_cast<float*>(gen + (dq_s - base));

    float acc_v[DP / 2], acc_k[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES, buf = i & 1;
      const int hr = i / n_q;
      const int q0 = (qt_begin + i - hr * n_q) * BQ;
      const uint32_t qs = q_s + s * QT, dos = do_s + s * QT;
      mbar_wait(full(s), (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T, [64 keys][64 queries] each
      float sc[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
        WgmmaSS<BQ>::run<0, 0>(sc, kmajor_desc(k_wg + c * KBOX), kmajor_desc(qs + c * QBOX),
                               c > 0);
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < NC; ++c)
        WgmmaSS<BQ>::run<0, 0>(dp, kmajor_desc(v_wg + c * KBOX), kmajor_desc(dos + c * QBOX),
                               c > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P^T = 2^(scale_log2 * r(s) - lse2) where kept; rows past Sq have
      // lse2 = +inf, so only tiles on Sk, the diagonal or the window's edge
      // need the mask
      const float* lse_row = rows_g + s * (ROWS_BYTES / 4);
      const float* delta_row = lse_row + BQ;
      const bool edge = kw + WG_KEYS > sk || (causal && kw + WG_KEYS - 1 > q0) ||
                        (has_window && (long long)q0 + BQ - 1 - kw >= window);
      if (round_scores) {
#pragma unroll
        for (int j = 0; j < BQ / 2; j += 2) round_bf16(sc[j], sc[j + 1]);
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_row + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int key = key0 + 8 * (e >> 1);
            const int qpos = q0 + 8 * j + 2 * t + (e & 1);
            bool ok = key < sk;
            if (causal) ok = ok && key <= qpos;
            if (has_window) ok = ok && (long long)qpos - key < window;
            p = ok ? p : 0.f;
          }
          sc[4 * j + e] = p;
        }
      }
      uint32_t pp[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pp[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // dV += P^T dO (dO MN-major: 16 queries a k-step)
      fence_regs(pp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        WgmmaRS<DP>::run(acc_v, pp[kk], mnmajor_desc(dos + kk * 512, QBOX), 1);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is ready; dV may still run
      fence_regs(dp);

      // dS^T = P^T (dP^T - delta) (the scale comes at the end)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_row + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
      uint32_t ds[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

      // dK += dS^T Q
      fence_regs(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        WgmmaRS<DP>::run(acc_k, ds[kk], mnmajor_desc(qs + kk * 512, QBOX), 1);
      wgmma_commit();

      // dS^T to shared memory: chunk kk holds queries 16kk..16kk+15 as 32-byte
      // rows of the block's 128 keys, swizzled as TMA swizzles
      const uint32_t dsb = ds_s + buf * DS_BYTES;
      const uint32_t krow = (uint32_t)(wg * WG_KEYS + wl * 16 + g) * 32;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t off = kk * KBOX + krow + (r & 1) * 8 * 32 + (r >> 1) * 16 + 4 * t;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dsb + sw32(off)), "r"(ds[kk][r])
                       : "memory");
        }
      fence_async_shared();
      consumers_sync();  // both halves of dS^T written; the other buffer's reads done

      // dQ (64 queries x NCQ chunks from c0) = dS K over the 128 keys
      float dqa[NCQ * 8];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaSS<NCQ * CHUNK>::template run<1, 1>(
            dqa, mnmajor_desc(dsb + kk * 512, KBOX),
            mnmajor_desc(k_s + c0 * KBOX + kk * 512, KBOX), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(dqa);
      fence_regs(pp);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty(s));  // Q, dO and the rows are consumed

      // the partial dQ to shared memory, f32 [64][DP], for the dQ warp
      if (i >= 2) mbar_wait(dq_empty(buf), ((i >> 1) - 1) & 1);
      float* dqb = dq_g + buf * (DQ_BYTES / 4);
      const int qrow = wl * 16 + g;
#pragma unroll
      for (int j = 0; j < NCQ * 2; ++j) {
        const int col = c0 * CHUNK + 8 * j + 2 * t;
        if (wg == 1 && col < NCQ * CHUNK) continue;  // warpgroup 0's chunk (odd NC)
        *reinterpret_cast<float2*>(dqb + qrow * DP + col) = make_float2(dqa[4 * j], dqa[4 * j + 1]);
        *reinterpret_cast<float2*>(dqb + (qrow + 8) * DP + col) =
            make_float2(dqa[4 * j + 2], dqa[4 * j + 3]);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_full(buf));
    }

    // dK (times the scale of dS) and dV of this thread's keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= sk) continue;
      const long long at = ((long long)bkv * sk + key) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;  // D % 8 == 0: col + 1 < D too
        if (col >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) = __floats2bfloat162_rn(
            acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
      }
    }
  }
}

constexpr size_t smem_bytes(int dp) {
  return (size_t)2 * (dp / CHUNK) * KBOX + (size_t)2 * STAGES * (dp / CHUNK) * QBOX +
         2 * DS_BYTES + (size_t)2 * BQ * dp * 4 + STAGES * ROWS_BYTES +
         8 * (1 + 2 * STAGES + 4) + 1024;
}

// scratch: lse2 then delta, f32 [B*H, n_qt * 64] each; dq_acc f32
// [B*H, n_qt, 64, DP]; counters int32 [B*H, n_qt] (zeroed here).
template <int DP>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* scratch, float* dq_acc, int* counters, void* dq,
           void* dk, void* dv, long long batch, int n_heads, int n_kv_heads, long long sq,
           long long sk, int d, int causal, int has_window, long long window,
           float scale, int round_scores, cudaStream_t stream) {
  const long long n_qt = (sq + BQ - 1) / BQ, sq_pad = n_qt * BQ;
  const long long bh = batch * n_heads;
  float* lse2 = scratch;
  float* delta = scratch + bh * sq_pad;
  // positions are 32-bit in the kernels: a window past every key is none
  const long long lim = 1LL << 30;
  const int win = (int)(window > lim ? lim : (window < -lim ? -lim : window));
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(dout);
  rows_kernel<<<(unsigned)((bh * sq_pad + 7) / 8), 256, 0, stream>>>(
      ob, dob, lse, lse2, delta, bh * sq_pad, (int)sq, (int)sq_pad, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(counters, 0, (size_t)(bh * n_qt) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
#ifdef FLASH_BWD_UNORDERED
  err = cudaMemsetAsync(dq_acc, 0, (size_t)(bh * n_qt * BQ * DP) * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
#endif
  const long long n_kt = (sk + BK - 1) / BK;
  if (n_kt > 0) {
    CUtensorMap qm, km, vm, dom;
    int rc = encode(&qm, q, bh, sq, d, BQ);
    if (rc == 0) rc = encode(&dom, dout, bh, sq, d, BQ);
    if (rc == 0) rc = encode(&km, k, batch * n_kv_heads, sk, d, BK);
    if (rc == 0) rc = encode(&vm, v, batch * n_kv_heads, sk, d, BK);
    if (rc != 0) return rc;
    const size_t smem = smem_bytes(DP);
    err = cudaFuncSetAttribute(bwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg moves registers inside the block only: the producer
    // warpgroup must free at least what the consumers take
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, bwd_tc<DP>);
    if (err != cudaSuccess) return (int)err;
    if (128 * (attr.numRegs - PRODUCER_REGS) <
        CONSUMERS * 128 * (CONSUMER_REGS - attr.numRegs))
      return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)(batch * n_kv_heads), (unsigned)n_kt);
    bwd_tc<DP><<<grid, THREADS, smem, stream>>>(
        qm, km, vm, dom, lse2, delta, dq_acc, counters, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n_heads, n_heads / n_kv_heads, (int)sq, (int)sk,
        d, causal, has_window, win, scale, scale * LOG2E, round_scores);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows = bh * sq;
  dq_kernel<<<(unsigned)((rows * (d / 8) + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), rows, (int)sq, (int)sk, d, DP, causal,
      has_window, win, scale);
  return (int)cudaGetLastError();
}

}  // namespace tcb

// 1 where (dtype, d) takes the tensor-core route: bf16 with D % 8 == 0, the
// forward's rule (the wrapper's bwd_route states the same).
extern "C" int flash_attention_bwd_uses_tc(int dtype, int d) {
  return dtype == 1 && d >= 8 && d <= 128 && d % 8 == 0;
}

// The tensor-core route's scratch, in elements: f32 rows (lse in log2
// units and delta, [2, B*H, ceil(Sq/64)*64]), the f32 dQ accumulator
// [B*H, ceil(Sq/64), 64, DP] (DP = D rounded up to 16) and the int32
// counters [B*H, ceil(Sq/64)].
extern "C" void flash_attention_bwd_scratch(long long bh, long long sq, int d,
                                            long long* rows, long long* acc,
                                            long long* counters) {
  const long long n_qt = (sq + tcb::BQ - 1) / tcb::BQ;
  const long long dp = (d + 15) / 16 * 16;
  *rows = 2 * bh * n_qt * tcb::BQ;
  *acc = bh * n_qt * tcb::BQ * dp;
  *counters = bh * n_qt;
}

// q, o, dout, dq [B, H, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D], all contiguous
// and of one type (0 float32, 1 bfloat16); lse f32 [B, H, Sq] from the
// forward. Scratch: on the f32 route `rows` is delta, f32 [B, H, Sq], and
// `acc` and `counters` are unused; on the tensor-core route their sizes
// are flash_attention_bwd_scratch's. D <= 128, H a multiple of Hkv, Sq and
// Sk / 64 within the grid's y limit; on the tensor-core route besides Sq,
// Sk and B*H below 2^31 and the bf16 tensors 16-byte aligned. Returns 0 on
// success, else the cudaError_t.
extern "C" int flash_attention_bwd_launch(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* rows, float* acc, int* counters,
    void* dq, void* dk, void* dv, long long batch, int n_heads, int n_kv_heads,
    long long sq, long long sk, int d, int dtype, int causal, int has_window,
    long long window, float scale, int round_scores, void* stream) {
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
    const long long lim = 1LL << 31;
    if (sq >= lim || sk >= lim || batch * n_heads >= lim)
      return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
         reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
         reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(acc) |
         reinterpret_cast<uintptr_t>(rows)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
#define TC_CASE(DP)                                                                    \
  if (d <= DP)                                                                         \
    return tcb::launch<DP>(q, k, v, o, dout, lse, rows, acc, counters, dq, dk, dv,     \
                           batch, n_heads, n_kv_heads, sq, sk, d, causal, has_window,  \
                           window, scale, round_scores, s)
    TC_CASE(16); TC_CASE(32); TC_CASE(48); TC_CASE(64);
    TC_CASE(80); TC_CASE(96); TC_CASE(112); TC_CASE(128);
#undef TC_CASE
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, dout, lse, rows, dq, dk, dv, batch, n_heads,
                             n_kv_heads, sq, sk, d, causal, has_window, window, scale,
                             round_scores, s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, rows, dq, dk, dv, batch,
                                     n_heads, n_kv_heads, sq, sk, d, causal, has_window,
                                     window, scale, round_scores, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
