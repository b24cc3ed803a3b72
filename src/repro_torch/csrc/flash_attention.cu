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
// With round_scores (the port's model path sets it) each f32 q.k is first
// rounded once to the inputs' type (bf16: round to nearest even) and the
// scale multiplies the rounded score, as the JAX package's
// attention_chunked does in its bf16 einsum (einsum(bf16).astype(f32) *
// scale); the max, the mask, the exponent and the lse all see it. The TPU
// kernel keeps f32 scores (preferred_element_type), the default here.
//
// Bound on this card: operations. Each kept (query, key) pair costs 4*D
// flops (two dot products of length D); at the prefill's first layer
// (q [4, 32, 6144, 80], window 4096) that is ~0.69 ms at the 989 TFLOP/s
// bf16 tensor-core rate, against ~0.09 ms for its bytes.
//
// Two routes, chosen by dtype and D only (flash_attention_uses_tc):
//
// * bf16 with D % 8 == 0: the tensor-core kernel `tc::flash_fwd_tc`, a
//   simplified FlashAttention-3 design.
//   - Block: one per (batch*head, 128-row query tile), 384 threads: two
//     consumer warpgroups of 64 query rows each and one producer
//     warpgroup, of which one warp's first lane issues every load.
//     `setmaxnreg` works per warpgroup: ptxas gives every thread 168
//     registers (65536 / 384), the producer warpgroup drops to 24 and the
//     consumers rise to 240, exactly what it frees (a lone producer warp
//     would free enough for 184; the launch checks the balance, since an
//     increase that cannot be met waits forever). blockIdx.y runs
//     over the query tiles from the last, so the tiles with the most live
//     key tiles (1 to 33 at the prefill) start first.
//   - Loads by TMA from three 3-D tensor maps [B*H or B*Hkv, S, D]: rows
//     past Sq or Sk fall out of the map and read as zero, never as the
//     next head's rows (0 x a NaN there would poison a row). The producer
//     loads Q once and keeps the live K and V tiles of 128 keys in a ring
//     of STAGES stages with full (K and V apart) and empty mbarriers. The
//     maps come from cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint (no -lcuda) and are __grid_constant__.
//   - D = 80 is no multiple of 64, so no 128-byte swizzle: every box is 16
//     columns (32 bytes, SWIZZLE_32B) by 128 rows, and a tile is D/16 such
//     chunks one after another. D % 16 != 0 (D = 8, ...) rounds the
//     template's DP up to 16: the box's columns past D fall out of the
//     map and read as zero, so both products see zeros. TMA needs the row
//     stride (2*D bytes) a multiple of 16: D % 8 == 0.
//   - S = Q K^T: per k-step of 16 one wgmma m64n128k16, both operands
//     K-major in shared memory; each k-step's descriptors point at one
//     chunk (SW32: leading offset unused, stride offset 256 B = 8 rows).
//   - Softmax in registers on the accumulator's fragments (under
//     round_scores each pair of scores first rounded by one
//     cvt.rn.bf16x2.f32 and back): a row's max is
//     two shuffles among the 4 threads that hold it; its sum stays
//     per-thread until the end. Only tiles that straddle the diagonal, the
//     window's edge or Sk are masked; an interior tile (under scale >= 0)
//     takes its max on the raw scores and folds scale*log2(e) into the
//     FMA before ex2.approx: 4.5 instructions a score instead of 5.5 in a
//     branch-free loop, the largest single gain of this design on the
//     card. A row
//     whose max is still -inf takes no weight.
//   - O += P V: P rounded to bf16 straight from the S fragments, which are
//     the A-from-registers layout of wgmma; V is the MN-major B operand in
//     the [key][d] chunks TMA wrote (no transpose staged): leading offset
//     = one chunk (128 x 32 B, the next 16 columns of D), stride offset
//     256 B (8 keys). O is m64nDPk16's f32 accumulator, 64 x DP per
//     warpgroup.
//   - Overlap (FA3's): a warpgroup issues S(i+1) = Q K^T and O += P(i) V
//     together, computes softmax(i+1) while P(i) V runs, and only then
//     waits for it; the last tile is peeled off the loop, since a
//     conditional product inside it made ptxas serialize every wgmma
//     (C7514). The two warpgroups take turns to issue (named barriers 1
//     and 2), so one's softmax overlaps the other's products. The ring
//     has 3 stages, because a warpgroup now holds two tiles at once.
//   - Epilogue: O / l (0 where l = 0), bf16, rows >= Sq and columns >= D
//     not stored; with an lse pointer, each row's f32 logsumexp of the
//     scaled scores, (m + log2 l) ln 2, or +inf where no key is kept.
//   Tile sizes: BQ = BK = 128 (the S accumulator is 64 registers a thread;
//   the ring of 3 stages at D = 128 takes 225 KB of the 227 KB).
//   Layer 0 of the prefill on one H100 SXM at 700 W (chip_smoke.py; see
//   PERF.md): about 1.6 ms, against 44 ms on the SIMT route.

// * f32, or bf16 with D % 8 != 0: the SIMT kernel `simt::flash_fwd_kernel`
//   (wgmma on f32 would be TF32, too coarse for the f32 row bound). One
//   block of 128 threads per (batch*head, 64-row query tile); the KV loop
//   runs over 64-key tiles staged in shared memory as f32; thread (ty, tx)
//   owns query rows 4ty..4ty+3, keys tx, tx+8, ... and output columns tx,
//   tx+8, ...; a row's max and sum are three shuffles; scores and products
//   on the f32 units.
//
// The logsumexp (lse, f32 [B, H, Sq], natural log of the row's sum of
// exp(scale * q.k) over its kept keys, q.k rounded as above) is stored only where the caller
// passes a pointer for it: the training forward, whose backward
// (csrc/flash_attention_bwd.cu) recomputes P = exp(scale * q.k - lse) from
// it, as the JAX package's _flash_bwd does. A row with no key kept gets
// +inf, so every P of it is 0. Storing it changes no bit of O.
//
// All element offsets are 64-bit in the SIMT kernel; the tensor-core
// kernel takes Sq, Sk < 2^31 (TMA coordinates are 32-bit).
//
// The positions route (template POS, where the caller passes q_pos int32
// [B, Sq], k_pos int32 [B, Sk] and kv_mask bool [B, Sk]) is the JAX
// package's whole attention_chunked: key j is kept for query i iff
// kv_mask[j], q_pos[i] >= k_pos[j] under causal and q_pos[i] - k_pos[j] <
// window under a window (positions within +-2^30). Small launches come
// first: tile_bounds (csrc/positions.cuh) writes each 64-key tile's and
// each 64-row query block's position bounds, on the tensor-core route
// fwd_walk turns them into each query tile's ascending list of live key
// tiles with both warpgroups' kinds (in global memory: the list is too long
// for the shared memory that D = 128 leaves), and column_sums writes the
// f32 sum of V over the Sk keys of each (batch, kv head). Both routes then
// visit only the key tiles that the bounds leave live (tile_kind; the
// tensor-core route's producer and consumers read the same list, each
// entry a load issued a tile ahead; the SIMT route skips a dead tile in its
// loop), and the tensor-core route runs an interior tile mask-free, as the
// index route runs one; other live tiles mask each score from the tile's
// key positions (a bulk copy beside the K tile on the tensor cores, from
// the int32 key positions that tile_bounds folds with the mask as MASKED). A masked score takes JAX's finite mask
// value NEG_INF (-1e30), a key past Sk -inf, and the running max starts at
// NEG_INF: a row with a kept key is computed as on the index route (the
// weight-1 terms it gathers before its first kept key are multiplied by
// exp(NEG_INF - m) = 0 there, so the tiles skipped change none of its
// bits), and a row whose max is still NEG_INF after its live tiles keeps no
// key: it takes JAX's answer in closed form, out = vsum / (Sk + pad) (the
// `pad` zero keys of JAX's last KV chunk), rounded as o is, and lse NEG_INF
// exactly. The index route's code and results are unchanged (POS = false).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "positions.cuh"

namespace simt {

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

// NJ: output columns per thread (8 * NJ >= D); POS: the positions route.
template <typename T, int NJ, bool POS>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n_heads,
                     int n_rep, int64_t sq, int64_t sk, int d, int causal,
                     int has_window, int64_t window, float scale,
                     int round_scores, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos,
                     const uint8_t* __restrict__ kv_mask, const int* __restrict__ kbnd,
                     const int* __restrict__ qbnd, const float* __restrict__ vsum,
                     float pad, int* __restrict__ visited) {
  extern __shared__ float smem[];
  const int ld = d + 1;     // padded row of Q and K
  const int ldv = 8 * NJ;   // V row, zero past D
  float* qs = smem;                // [BQ][ld]
  float* ks = qs + BQ * ld;        // [BK][ld]
  float* vs = ks + BK * ld;        // [BK][ldv]
  float* ps = vs + BK * ldv;       // [BQ][BK + 1]
  int* kps = reinterpret_cast<int*>(ps + BQ * (BK + 1));  // [BK], POS only

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
  int qp[RPT];  // the rows' positions (POS)
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = POS ? NEG_INF : -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    const int64_t row = q_start + r0 + i;
    qp[i] = POS && row < sq ? q_pos[b * sq + row] : 0;
  }

  // the live KV tiles of this query tile, as the TPU kernel's rule (on the
  // positions route every tile whose bounds leave it live)
  const int64_t n_kt = (sk + BK - 1) / BK;
  int64_t kt_end = n_kt;
  if (causal && !POS) {
    const int64_t last = (q_start + BQ - 1) / BK + 1;
    kt_end = last < n_kt ? last : n_kt;
  }
  int64_t kt_begin = 0;
  if (has_window && !POS) {
    const int64_t lo = q_start - window + 1;  // first key any row keeps
    if (lo > 0) kt_begin = lo / BK;
  }
  const int64_t nk = bound_tiles(sk), nq = bound_tiles(sq);
  const Bounds qbd = POS ? query_bounds(qbnd, b, nq, blockIdx.y) : Bounds{0, 0, 0};
  int seen = 0;  // the live tiles visited (POS)

  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k_start = kt * BK;
    if (POS && tile_kind(qbd, key_bounds(kbnd, b, nk, kt, kt + 1), causal, has_window,
                         window) == TILE_DEAD)
      continue;  // the same for every thread: no pair of it is kept
    ++seen;
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
    if (POS) {
      for (int i = tid; i < BK; i += THREADS)
        kps[i] = k_start + i < sk ? key_position(k_pos, kv_mask, b, sk, k_start + i)
                                  : MASKED;
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
        float fill = -INFINITY;  // a key past Sk (or masked, index route)
        if (POS) {
          const bool keep = keeps(qp[i], kps[tx + 8 * j], causal, has_window, window);
          if (ok && !keep) fill = NEG_INF;
          ok = ok && keep;
        } else {
          if (causal) ok = ok && kpos <= qpos;
          if (has_window) ok = ok && qpos - kpos < window;
        }
        const float raw = round_scores ? widen(narrow<T>(s[i][j])) : s[i][j];
        s[i][j] = ok ? raw * scale : fill;
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

  if (POS && tid == 0) atomicAdd(visited, seen);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q_start + r0 + i;
    if (row >= sq) continue;
    T* orow = o + (bh * sq + row) * d;
    if (POS && m[i] == NEG_INF) {  // no key kept: JAX's mean of V, its lse
      if (lse != nullptr && tx == 0) lse[bh * sq + row] = NEG_INF;
      const float n = (float)sk + pad;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 8 * j;
        if (c < d) orow[c] = narrow<T>(vsum[kvh * d + c] / n);
      }
      continue;
    }
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (lse != nullptr && tx == 0)
      lse[bh * sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 8 * j;
      if (c < d) orow[c] = narrow<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ, bool POS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t batch,
           int n_heads, int n_kv_heads, int64_t sq, int64_t sk, int d,
           int causal, int has_window, int64_t window, float scale,
           int round_scores, const int* q_pos, const int* k_pos,
           const uint8_t* kv_mask, const int* kb, const int* qb, const float* vsum,
           float pad, int* visited, cudaStream_t stream) {
  const int ld = d + 1;
  const size_t smem =
      sizeof(float) * (size_t)(BQ * ld + BK * ld + BK * 8 * NJ + BQ * (BK + 1)) +
      (POS ? sizeof(int) * BK : 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * n_heads), (unsigned)((sq + BQ - 1) / BQ));
  flash_fwd_kernel<T, NJ, POS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n_heads,
      n_heads / n_kv_heads, sq, sk, d, causal, has_window, window, scale,
      round_scores, q_pos, k_pos, kv_mask, kb, qb, vsum, pad, visited);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
             int64_t sk, int d, int causal, int has_window, int64_t window,
             float scale, int round_scores, const int* q_pos, const int* k_pos,
             const uint8_t* kv_mask, const int* kb, const int* qb, const float* vsum,
             float pad, int* visited, cudaStream_t s) {
  const int nj = (d + 7) / 8;
#define FLASH_CASE(N)                                                          \
  return q_pos != nullptr                                                      \
             ? launch<T, N, true>(q, k, v, o, lse, batch, n_heads, n_kv_heads,  \
                                  sq, sk, d, causal, has_window, window, scale, \
                                  round_scores, q_pos, k_pos, kv_mask, kb, qb,  \
                                  vsum, pad, visited, s)                        \
             : launch<T, N, false>(q, k, v, o, lse, batch, n_heads, n_kv_heads, \
                                   sq, sk, d, causal, has_window, window, scale, \
                                   round_scores, q_pos, k_pos, kv_mask, kb, qb, \
                                   vsum, pad, visited, s)
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

}  // namespace simt

namespace tc {

using namespace hopper;

constexpr int BQ = 128;        // query rows per block
constexpr int BK = 128;        // keys per tile
constexpr int WG_ROWS = 64;    // query rows per consumer warpgroup
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int PRODUCER_WARP = CONSUMERS * 4;  // first warp of the producer
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 3;      // K/V ring depth
constexpr uint32_t BOX_BYTES = BK * CHUNK * 2;  // one 128-row box
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr uint32_t KPOS_BYTES = BK * 4;  // a tile's key positions (POS)
constexpr float NEG2 = NEG_INF * 1.4426950408889634f;  // NEG_INF in log2 units

// A 128-row tile of NC chunks of 16 columns, one box each; the barrier
// also counts `extra` bytes that the caller loads beside it.
template <int NC>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int row, int head, uint32_t bar,
                                          uint32_t extra = 0) {
  mbar_expect_tx(bar, NC * BOX_BYTES + extra);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(dst + c * BOX_BYTES, map, c * CHUNK, row, head, bar);
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (barrier 0 is __syncthreads): warpgroup w waits on 1 + w before it
// issues, then lets the other one go.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMERS * 128) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMERS * 128) : "memory");
}

// Issue S = Q_wg K^T for one key tile (NC k-steps of m64n128k16) as one
// wgmma group; the caller waits.
template <int NC>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t q_wg,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
    WgmmaSS<BK>::run<0, 0>(s, kmajor_desc(q_wg + c * BOX_BYTES),
                           kmajor_desc(k_tile + c * BOX_BYTES), c > 0);
  wgmma_commit();
}

// Issue O (+)= P V for one key tile (BK/16 k-steps of m64nDPk16) as one
// wgmma group: P's k-step kk in p[kk] (the A fragment), V's 16 keys at
// 512 B per k-step. P and O stay untouched until the caller's wait.
template <int DP>
__device__ __forceinline__ void pv_issue(float (&o)[DP / 2],
                                         uint32_t (&p)[BK / 16][4],
                                         uint32_t v_tile, int accumulate) {
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    WgmmaRS<DP>::run(o, p[kk], mnmajor_desc(v_tile + kk * 16 * 32, BOX_BYTES),
                     accumulate || kk > 0);
  wgmma_commit();
}

// Accumulator fragment of m64nNk16 (f32): thread (warp w, lane 4g + t) of
// a warpgroup holds, for each 8-column block j, rows 16w + g (d[4j],
// d[4j+1]) and 16w + g + 8 (d[4j+2], d[4j+3]) at columns 8j + 2t, +1.
// These are also P's A fragment for k-step kk: p[kk][i] = bf16x2 of
// s[8kk + 2i], s[8kk + 2i + 1].

// Online softmax of one score tile in place, in the log2 domain: with
// round_scores rounds each raw q.k to bf16 first (the scale then applies
// to the rounded score), masks it where it straddles Sk, the diagonal or
// the window's edge (interior tiles skip the mask), updates the rows' max m and per-thread partial sum
// l, leaves p = 2^(s - m) in s and the factor for the old accumulator in
// corr. A row whose max is still -inf takes p = 0 and keeps l = 0. On the
// positions route (POS) a tile that the bounds do not prove interior is
// masked, from the tile's key positions kp (shared memory) and the rows'
// positions qp: a masked score is NEG2, a key past Sk -inf.
template <bool POS>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], int k0,
                                             int row0, int qa, int sk, int causal,
                                             int has_window, int window,
                                             float scale_log2, int round_scores,
                                             int t, const int* kp, const int (&qp)[2],
                                             bool interior) {
  if (round_scores) {
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) round_bf16(sc[i], sc[i + 1]);
  }
  const bool edge = POS ? !interior
                        : k0 + BK > sk || (causal && k0 + BK - 1 > qa) ||
                              (has_window && (long long)qa + WG_ROWS - 1 - k0 >= window);
  // an interior tile under a scale >= 0 takes its max on the raw scores and
  // folds the scale into the exponent's FMA; other tiles scale and mask first
  const bool raw = !edge && scale_log2 >= 0.f;
  float mx[2] = {-INFINITY, -INFINITY};
  if (raw) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    mx[0] *= scale_log2;
    mx[1] *= scale_log2;
  } else {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          bool ok = col < sk;
          if (POS) {
            const bool keep =
                keeps(qp[e >> 1], kp[8 * j + 2 * t + (e & 1)], causal, has_window, window);
            x = ok ? (keep ? x : NEG2) : -INFINITY;
          } else {
            if (causal) ok = ok && col <= row;
            if (has_window) ok = ok && (long long)row - col < window;
            x = ok ? x : -INFINITY;
          }
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no key kept yet: p = 0
    corr[r] = ex2(m[r] - m_use[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
  const float mult = raw ? scale_log2 : 1.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], mult, -m_use[(i >> 1) & 1]));
    l[(i >> 1) & 1] += sc[i];
  }
}

// P rounded to bf16 in the A fragment of the P V product: k-step kk takes
// p[kk][i] = (s[8kk + 2i], s[8kk + 2i + 1]).
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <int DP, bool POS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int n_heads, int n_rep, int sq,
                 int sk, int d, int causal, int has_window, int window,
                 float scale_log2, int round_scores, const int* __restrict__ q_pos,
                 const int* __restrict__ keys, const int* __restrict__ walk,
                 const float* __restrict__ vsum, float pad) {
  constexpr int NC = DP / CHUNK;
  constexpr uint32_t TILE = NC * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + TILE;             // + stage * TILE
  const uint32_t v_s = k_s + STAGES * TILE;    // + stage * TILE
  const uint32_t bars = v_s + STAGES * TILE;   // q, k full, v full, empty
  const uint32_t q_bar = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  const uint32_t kpos_s = bars + 128;  // + stage * KPOS_BYTES (POS)

  const int bh = blockIdx.x;  // b * n_heads + h
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int kvh = b * (n_heads / n_rep) + h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tiles first

  // the live KV tiles of this query tile, as the TPU kernel's rule; on the
  // positions route those of the list below
  const int n_kt = (sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal && !POS) kt_end = min(n_kt, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (has_window && !POS) {
    const long long lo = (long long)q0 - window + 1;  // first key any row keeps
    if (lo > 0) kt_begin = (int)(lo / BK);
  }
  // the positions route's walk: the key tiles whose bounds leave them live
  // for either warpgroup's 64 rows, ascending, with each warpgroup's kind,
  // as fwd_walk (csrc/positions.cuh) listed them for this query tile; every
  // role reads the list alike (too long for shared memory in general)
  const int* list = POS ? walk + ((long long)b * gridDim.y + q0 / BQ) * (1 + n_kt) : nullptr;
  if (POS) {
    kt_begin = 0;
    kt_end = list[0];  // the number of live tiles
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= PRODUCER_WARP) {
    // ---- producer warpgroup: one thread issues the TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == PRODUCER_WARP && lane == 0 && (!POS || kt_end > 0)) {
      load_tile<NC>(q_s, &qmap, q0, bh, q_bar);
      for (int i = 0; i < kt_end - kt_begin; ++i) {
        const int kt = POS ? walk_tile(list[1 + i]) : kt_begin + i;
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        load_tile<NC>(k_s + s * TILE, &kmap, kt * BK, kvh, k_full(s),
                      POS ? KPOS_BYTES : 0);
        if (POS)
          bulk_load(kpos_s + s * KPOS_BYTES, keys + ((long long)b * n_kt + kt) * BK,
                    KPOS_BYTES, k_full(s));
        load_tile<NC>(v_s + s * TILE, &vmap, kt * BK, kvh, v_full(s));
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 query rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    const int qa = q0 + wg * WG_ROWS;           // the warpgroup's first row
    const int row0 = qa + (warp % 4) * 16 + g;  // and row0 + 8
    const uint32_t q_wg = q_s + wg * WG_ROWS * CHUNK * 2;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {POS ? NEG2 : -INFINITY, POS ? NEG2 : -INFINITY}, l[2] = {0.f, 0.f};
    int qp[2] = {0, 0};  // the rows' positions (POS)
    const int* kp = reinterpret_cast<const int*>(smem_raw + (kpos_s - smem_u32(smem_raw)));
    if (POS) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < sq) qp[r] = q_pos[(long long)b * sq + row0 + 8 * r];
    }

    // Per tile i: S(i+1) = Q K^T and O += P(i) V are issued back to back,
    // then softmax(i+1) runs while P(i) V is still on the tensor cores.
    // The warpgroups take turns to issue (ping-pong), so one's softmax
    // overlaps the other's products; warpgroup 0 goes first, and the
    // last turn of warpgroup 1 is not passed on, as nobody waits for it.
    const int n_tiles = kt_end - kt_begin;
    if (!POS || n_tiles > 0) mbar_wait(q_bar, 0);
    float sc[BK / 2] = {};
    uint32_t p[BK / 16][4];
    float corr[2];
    // POS: the walk's entry of the latest score product's tile, and the next
    // one's, loaded a tile ahead
    int e = POS && n_tiles > 0 ? list[1] : 0;
    int e_next = POS && n_tiles > 1 ? list[2] : 0;
    if (n_tiles > 0) {
      if (wg == 1) turn_pass(wg);
      mbar_wait(k_full(0), 0);
      turn_wait(wg);
      qk_issue<NC>(sc, q_wg, k_s);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<POS>(sc, m, l, corr, (POS ? walk_tile(e) : kt_begin) * BK, row0, qa, sk,
                        causal, has_window, window, scale_log2, round_scores, t, kp, qp,
                        walk_kind(e, wg) == TILE_INTERIOR);
      pack_p(sc, p);
    }
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int s = i % STAGES, s1 = (i + 1) % STAGES;
      if (POS) {
        e = e_next;
        if (i + 2 < n_tiles) e_next = list[3 + i];
      }
      mbar_wait(k_full(s1), ((i + 1) / STAGES) & 1);
      mbar_wait(v_full(s), (i / STAGES) & 1);
      turn_wait(wg);
      qk_issue<NC>(sc, q_wg, k_s + s1 * TILE);
      pv_issue<DP>(acc, p, v_s + s * TILE, 1);
      turn_pass(wg);
      wgmma_wait<1>();  // S(i+1) is ready, P(i) V may still run
      fence_regs(sc);
      softmax_tile<POS>(sc, m, l, corr, (POS ? walk_tile(e) : kt_begin + i + 1) * BK, row0,
                        qa, sk, causal, has_window, window, scale_log2, round_scores, t,
                        kp + s1 * BK, qp, walk_kind(e, wg) == TILE_INTERIOR);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      pack_p(sc, p);
    }
    if (n_tiles > 0) {  // the last tile: P V alone
      const int s = (n_tiles - 1) % STAGES;
      mbar_wait(v_full(s), ((n_tiles - 1) / STAGES) & 1);
      turn_wait(wg);
      pv_issue<DP>(acc, p, v_s + s * TILE, 1);
      if (wg == 0) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    bool none[2];  // no key kept (POS): JAX's mean of V, its lse exactly
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      none[r] = POS && m[r] == NEG2;
      const int row = row0 + 8 * r;
      if (lse != nullptr && t == 0 && row < sq)  // m is in log2 units
        lse[(long long)bh * sq + row] =
            none[r] ? NEG_INF
            : l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : INFINITY;
      l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    const float n_mean = (float)sk + pad;
    const float* vs = vsum + (long long)kvh * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;  // D % 8 == 0: col + 1 < D too
      if (col >= d) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= sq) continue;
        const __nv_bfloat162 v2 =
            none[r] ? __floats2bfloat162_rn(vs[col] / n_mean, vs[col + 1] / n_mean)
                    : __floats2bfloat162_rn(acc[4 * j + 2 * r] * l[r],
                                            acc[4 * j + 2 * r + 1] * l[r]);
        *reinterpret_cast<__nv_bfloat162*>(o + ((long long)bh * sq + row) * d + col) = v2;
      }
    }
  }
}

// One warpgroup, one tile of each product at (head 0, rows 0..127), for
// the first check of the descriptors and the swizzle on a new card or
// toolkit: s_out[64][BK] = Q[0:64] K^T (f32), o_out[64][DP] = P V with P
// (bf16 [64][BK]) read from global memory into the A fragment.
template <int DP>
__global__ void __launch_bounds__(128)
    flash_probe_tc(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __nv_bfloat16* __restrict__ pin, float* __restrict__ s_out,
                   float* __restrict__ o_out) {
  constexpr int NC = DP / CHUNK;
  constexpr uint32_t TILE = NC * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + TILE, v_s = base + 2 * TILE;
  const uint32_t bar = base + 3 * TILE;
  if (threadIdx.x == 0) {
    mbar_init(bar, 3);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_tile<NC>(q_s, &qmap, 0, 0, bar);
    load_tile<NC>(k_s, &kmap, 0, 0, bar);
    load_tile<NC>(v_s, &vmap, 0, 0, bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;

  float sc[BK / 2];
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
  qk_issue<NC>(sc, q_s, k_s);
  wgmma_wait<0>();
  fence_regs(sc);
  uint32_t p[BK / 16][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(row0 + 8 * (e >> 1)) * BK + 8 * j + 2 * t + (e & 1)] = sc[4 * j + e];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1), col = 16 * kk + 8 * (i >> 1) + 2 * t;
      p[kk][i] = *reinterpret_cast<const uint32_t*>(pin + row * BK + col);
    }
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  pv_issue<DP>(acc, p, v_s, 0);
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(row0 + 8 * (e >> 1)) * DP + 8 * j + 2 * t + (e & 1)] = acc[4 * j + e];
  }
}


// the barriers' 80 bytes, or on the positions route 128 bytes and the
// ring's key positions
constexpr size_t smem_bytes(int dp, int tiles, bool pos = false) {
  return (size_t)tiles * (dp / CHUNK) * BOX_BYTES +
         (pos ? 128 + STAGES * KPOS_BYTES : 8 * (1 + 3 * STAGES)) + 1024;
}

template <int DP, bool POS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long batch,
           int n_heads, int n_kv_heads, long long sq, long long sk, int d,
           int causal, int has_window, long long window, float scale,
           int round_scores, const int* q_pos, const int* bounds, const int* keys,
           int* walk, const float* vsum, float pad, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode(&qm, q, batch * n_heads, sq, d, BK);
  if (rc == 0) rc = encode(&km, k, batch * n_kv_heads, sk, d, BK);
  if (rc == 0) rc = encode(&vm, v, batch * n_kv_heads, sk, d, BK);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes(DP, 1 + 2 * STAGES, POS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DP, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers inside the block only: the producer
  // warpgroup must free at least what the consumers take, or their
  // increase waits forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_tc<DP, POS>);
  if (err != cudaSuccess) return (int)err;
  if (128 * (attr.numRegs - PRODUCER_REGS) <
      CONSUMERS * 128 * (CONSUMER_REGS - attr.numRegs))
    return (int)cudaErrorInvalidConfiguration;
  // positions are 32-bit in the kernel: a window past every key is none
  const long long lim = 1LL << 30;
  const int win = (int)(window > lim ? lim : (window < -lim ? -lim : window));
  if (POS) {
    err = launch_walk(bounds, walk, false, batch, sq, sk, causal, has_window, win, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(batch * n_heads), (unsigned)((sq + BQ - 1) / BQ));
  flash_fwd_tc<DP, POS><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, n_heads, n_heads / n_kv_heads,
      (int)sq, (int)sk, d, causal, has_window, win, scale * 1.4426950408889634f,
      round_scores, q_pos, keys, walk, vsum, pad);
  return (int)cudaGetLastError();
}

template <int DP>
int probe(const void* q, const void* k, const void* v, const void* p, void* s_out,
          void* o_out, long long sq, long long sk, int d, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode(&qm, q, 1, sq, d, BK);
  if (rc == 0) rc = encode(&km, k, 1, sk, d, BK);
  if (rc == 0) rc = encode(&vm, v, 1, sk, d, BK);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes(DP, 3);
  cudaError_t err = cudaFuncSetAttribute(
      flash_probe_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_probe_tc<DP><<<1, 128, smem, stream>>>(
      qm, km, vm, static_cast<const __nv_bfloat16*>(p), static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}

#define TC_DISPATCH(d, ...)                  \
  do {                                        \
    if ((d) <= 16) { constexpr int DP = 16; return __VA_ARGS__; }  \
    if ((d) <= 32) { constexpr int DP = 32; return __VA_ARGS__; }  \
    if ((d) <= 48) { constexpr int DP = 48; return __VA_ARGS__; }  \
    if ((d) <= 64) { constexpr int DP = 64; return __VA_ARGS__; }  \
    if ((d) <= 80) { constexpr int DP = 80; return __VA_ARGS__; }  \
    if ((d) <= 96) { constexpr int DP = 96; return __VA_ARGS__; }  \
    if ((d) <= 112) { constexpr int DP = 112; return __VA_ARGS__; } \
    if ((d) <= 128) { constexpr int DP = 128; return __VA_ARGS__; } \
    return (int)cudaErrorInvalidValue;        \
  } while (0)

}  // namespace tc


// 1 where (dtype, d) takes the tensor-core kernel: bf16 with D % 8 == 0.
// The wrapper's rule (kernels/flash_attention/ops.py route) is the same.
extern "C" int flash_attention_uses_tc(int dtype, int d) {
  return dtype == 1 && d >= 8 && d <= 128 && d % 8 == 0;
}

// vsum[bkv][c] = sum over j < Sk of v[bkv][j][c] in f32 (the positions
// route's mean of a row that keeps no key): block (bkv, 32 columns), thread
// (ty, tx) sums rows ty, ty + 32, ... of column tx in turn, then thread
// (0, tx) adds the 32 partial sums in order: a fixed order.
template <typename T>
__global__ void __launch_bounds__(1024)
    column_sums(const T* __restrict__ v, float* __restrict__ vsum, long long sk, int d) {
  __shared__ float part[32][33];
  const long long bkv = blockIdx.x;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.y * 32 + tx;
  float acc = 0.f;
  if (c < d)
    for (long long j = ty; j < sk; j += 32) acc += simt::widen(v[(bkv * sk + j) * d + c]);
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < d) {
    float sum = 0.f;
    for (int i = 0; i < 32; ++i) sum += part[i][tx];
    vsum[bkv * d + c] = sum;
  }
}

// Fills n floats with +inf (the lse of rows that keep no key).
__global__ void fill_inf(float* x, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    x[i] = INFINITY;
}

// q [B, H, Sq, D], k/v [B, Hkv, Sk, D], o [B, H, Sq, D], all contiguous and
// of one type (0 float32, 1 bfloat16), lse f32 [B, H, Sq] or null (not
// stored); D <= 128, H a multiple of Hkv,
// Sq <= 65535 * 64; on the tensor-core route besides Sq, Sk and B*H below
// 2^31 and q, k, v 16-byte aligned. The positions route: q_pos int32
// [B, Sq], k_pos int32 [B, Sk], kv_mask bool [B, Sk] (all three, or null
// for the index route), `pad` the zero keys of JAX's last KV chunk, and
// the scratch of flash_attention_pos_scratch: `ints` int32 (the tile
// bounds, the folded key positions) and `floats` f32 (the column sums of
// V). Returns 0 on success, else the cudaError_t.
extern "C" int flash_attention_launch(int device, const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      long long batch,
                                      int n_heads, int n_kv_heads,
                                      long long sq, long long sk, int d,
                                      int dtype, int causal, int has_window,
                                      long long window, float scale,
                                      int round_scores, const int* q_pos,
                                      const int* k_pos, const uint8_t* kv_mask,
                                      int* ints, float* floats, float pad,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch * n_heads * sq == 0) return 0;
  if (d < 1 || d > 128 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      (sq + simt::BQ - 1) / simt::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const bool pos = q_pos != nullptr;
  if (pos && (k_pos == nullptr || kv_mask == nullptr || pad < 0.f || ints == nullptr ||
              floats == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = flash_attention_uses_tc(dtype, d);
  const int* kb = nullptr;
  const int* qb = nullptr;
  const int* keys = nullptr;
  int* walk = nullptr;
  int* visited = nullptr;
  if (pos) {  // the tile bounds (the walk comes in tc::launch), then V's column sums
    err = launch_tile_bounds(q_pos, k_pos, kv_mask, ints, tc, false, batch, sq, sk, s);
    if (err != cudaSuccess) return (int)err;
    kb = ints;
    qb = kb + batch * bound_tiles(sk) * 3;
    keys = ints + bounds_head(batch, sq, sk);
    walk = ints + bounds_ints(batch, sq, sk, tc);
    if (!tc) {  // the SIMT route's visit counts
      visited = walk;
      err = cudaMemsetAsync(visited, 0, VISITED_INTS * sizeof(int), s);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)(batch * n_kv_heads), (unsigned)((d + 31) / 32));
    if (dtype == 0)
      column_sums<float><<<grid, 1024, 0, s>>>(static_cast<const float*>(v), floats, sk, d);
    else
      column_sums<__nv_bfloat16><<<grid, 1024, 0, s>>>(
          static_cast<const __nv_bfloat16*>(v), floats, sk, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (tc) {
    const long long lim = 1LL << 31;
    if (sq >= lim || sk >= lim || batch * n_heads >= lim)
      return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    if (sk == 0) {  // no key: every row is 0, every lse +inf
      if (lse != nullptr) {
        fill_inf<<<256, 256, 0, s>>>(lse, batch * n_heads * sq);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
      }
      return (int)cudaMemsetAsync(o, 0, (size_t)(batch * n_heads * sq * d) * 2, s);
    }
    TC_DISPATCH(d, pos ? tc::launch<DP, true>(q, k, v, o, lse, batch, n_heads,
                                              n_kv_heads, sq, sk, d, causal, has_window,
                                              window, scale, round_scores, q_pos, ints,
                                              keys, walk, floats, pad, s)
                       : tc::launch<DP, false>(q, k, v, o, lse, batch, n_heads,
                                               n_kv_heads, sq, sk, d, causal, has_window,
                                               window, scale, round_scores, q_pos, ints,
                                               keys, walk, floats, pad, s));
  }
  switch (dtype) {
    case 0:
      return simt::dispatch<float>(q, k, v, o, lse, batch, n_heads, n_kv_heads, sq,
                                   sk, d, causal, has_window, window, scale,
                                   round_scores, q_pos, k_pos, kv_mask, kb, qb, floats,
                                   pad, visited, s);
    case 1:
      return simt::dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, n_heads,
                                           n_kv_heads, sq, sk, d, causal,
                                           has_window, window, scale, round_scores,
                                           q_pos, k_pos, kv_mask, kb, qb, floats, pad,
                                           visited, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The positions route's scratch, in elements: int32 `ints` (the tile
// bounds and, on the tensor-core route, the key positions and the walk;
// positions.cuh's bounds_ints and fwd_walk_ints; on the SIMT route the
// visit counts, VISITED_INTS) and f32 `floats` (V's column sums, [B, Hkv,
// D]); `walk_at`, where in `ints` the walk (or the visit counts) begins.
extern "C" void flash_attention_pos_scratch(long long batch, int n_kv_heads, long long sq,
                                            long long sk, int d, int dtype,
                                            long long* ints, long long* floats,
                                            long long* walk_at) {
  const bool tc = flash_attention_uses_tc(dtype, d);
  *walk_at = bounds_ints(batch, sq, sk, tc);
  *ints = *walk_at + (tc ? fwd_walk_ints(batch, sq, sk) : VISITED_INTS);
  *floats = batch * n_kv_heads * d;
}

// The tensor-core route's two products on one tile, for checking its
// descriptors and swizzle: q [Sq, D], k/v [Sk, D] (bf16, one head, rows
// past Sq/Sk read as zero), p bf16 [64, 128]; writes s_out f32 [64, 128]
// = q[:64] k[:128]^T and o_out f32 [64, DP] = p v[:128] (DP = D rounded
// up to 16). D % 8 == 0.
extern "C" int flash_attention_probe(int device, const void* q, const void* k,
                                     const void* v, const void* p, void* s_out,
                                     void* o_out, long long sq, long long sk,
                                     int d, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!flash_attention_uses_tc(1, d) || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TC_DISPATCH(d, tc::probe<DP>(q, k, v, p, s_out, o_out, sq, sk, d, s));
}
