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
//
// The positions route (template POS; q_pos int32 [B, Sq], k_pos int32
// [B, Sk], kv_mask bool [B, Sk], the forward's): a pair is kept by the
// forward's positions rule (csrc/flash_attention.cu). The tile bounds of
// csrc/positions.cuh (tile_bounds, a first launch) decide the walk: a
// block visits only the query tiles that they leave live for its key tile
// (the key tiles for its query tile), an interior tile runs mask-free on
// the tensor cores, and the ordered dQ adds of a query tile run over its
// live key tiles in ascending order: a block waits for the live key tiles
// before its own, their number the rank that bwd_walk (a launch after
// tile_bounds, tensor cores only) writes beside each live query tile of
// each key tile, the list every role of bwd_tc reads; the rows' positions
// come with their lse and delta rows, from a padded copy that tile_bounds
// writes. Inside the walk a masked pair, and every pair of a row that
// keeps no key, takes P = 0.
// JAX gives such a row (its forward lse NEG_INF) P = exp(NEG_INF - NEG_INF)
// = 1 on every key j < Sk; its whole contribution is added in closed form,
// per (batch, kv head), the sums over the no-key rows i of the group's
// heads:
//   sigma = sum_i dO_i, N = sum_i q_i dO_i^T, rho = sum_i delta_i q_i,
//   A = sum_{j<Sk} k_j v_j^T, kappa = sum_{j<Sk} k_j;
//   dV_j += sigma, dK_j += scale (N v_j - rho), dQ_i = scale (A dO_i -
//   delta_i kappa)
// each added in f32 before the output's one rounding (dK and dV in the
// dkdv epilogue, dQ in dq_nokey_kernel after dq_kernel on the tensor
// cores, in the SIMT dq kernel's epilogue). The sums are written by
// gram_kernel, on the tensor cores gram_mma (bf16 products are exact, the
// mma adds in f32), a fixed order over SUM_CHUNKS chunks of rows, then
// sum_chunks adds the chunks in order; they count the no-key rows on the
// device: where a group has none, every later step reads the count and
// adds nothing. The index route's code and results are unchanged
// (POS = false).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "positions.cuh"

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

// ---- the closed-form terms of the rows that keep no key (POS) ----

constexpr int SUM_CHUNKS = 8;  // row chunks a (batch, kv head) and job

// Elements of one (batch, kv head, job)'s sums: G [D][D], sx [D], sy [D].
__host__ __device__ __forceinline__ long long sum_elems(int d) {
  return (long long)d * d + 2LL * d;
}

// The no-key scratch of the positions route, behind the walk: int32
// chunk counts [B*Hkv][SUM_CHUNKS] and counts [B*Hkv]; f32 partial sums
// [B*Hkv][2][SUM_CHUNKS][sum_elems] and sums [B*Hkv][2][sum_elems].
struct NoKey {
  int* chunk_counts;
  int* counts;
  float* partials;
  float* sums;
};
__host__ __device__ __forceinline__ long long nokey_ints(long long bkv) {
  return bkv * (SUM_CHUNKS + 1);
}
__host__ __device__ __forceinline__ long long nokey_floats(long long bkv, int d) {
  return bkv * 2 * (SUM_CHUNKS + 1) * sum_elems(d);
}
__host__ __device__ __forceinline__ NoKey nokey_layout(int* ints, float* floats,
                                                       long long bkv, int d) {
  return {ints, ints + bkv * SUM_CHUNKS, floats,
          floats + bkv * 2 * SUM_CHUNKS * sum_elems(d)};
}

// One chunk of one job's sums for one (batch, kv head) (blockIdx.x), over
// rows in ascending order, 32 at a time: G[a][b] = sum_r w_r X_ra Y_rb,
// sx[a] = sum_r w_r X_ra, sy[b] = sum_r w_r e_r Y_rb.
//   job 0 (the rows that keep no key): r over the group's query rows, head
//     by head; w_r = 1 iff lse_r == NEG_INF; X = dO, Y = q, e = delta:
//     G = N^T (G[e][c] = N[c][e]), sx = sigma, sy = rho; it also counts
//     the rows (chunk_counts)
//   job 1 (the keys): r over the keys j < Sk, w = e = 1; X = v, Y = k:
//     G = A^T, sy = kappa; it does nothing where job 0 counted no row.
// Thread t < (D/8)^2 holds an 8 x 8 block of G; threads t < D and
// 128 <= t < 128 + D hold sx[t] and sy[t - 128].
template <typename T>
__global__ void __launch_bounds__(256)
    gram_kernel(int job, const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                long long delta_stride, NoKey nk, int n_heads, int n_rep, long long sq,
                long long sk, int d) {
  __shared__ __align__(16) float xs[32][128];
  __shared__ __align__(16) float ys[32][128];
  __shared__ float es[32];
  __shared__ int ws[32];
  const long long bkv = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_kv = n_heads / n_rep;
  const long long b = bkv / n_kv, g = bkv - b * n_kv;
  if (job == 1) {
    int total = 0;
    for (int c = 0; c < SUM_CHUNKS; ++c) total += nk.chunk_counts[bkv * SUM_CHUNKS + c];
    if (total == 0) return;
  }
  const long long rows = job == 0 ? n_rep * sq : sk;
  const long long r0 = rows * chunk / SUM_CHUNKS, r1 = rows * (chunk + 1) / SUM_CHUNKS;
  const int np = (d + 7) / 8;
  const int pa = tid / np, pb = tid - (tid / np) * np;
  const bool patch = tid < np * np;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float border = 0.f;
  int count = 0;
  for (long long base = r0; base < r1; base += 32) {
    __syncthreads();  // the previous rows are consumed
    int w = 0;
    if (tid < 32) {
      const long long r = base + tid;
      float e = 0.f;
      if (r < r1) {
        if (job == 0) {
          const long long hr = r / sq, i = r - hr * sq;
          const long long bh = b * n_heads + g * n_rep + hr;
          w = lse[bh * sq + i] == NEG_INF;
          e = w ? delta[bh * delta_stride + i] : 0.f;
        } else {
          w = 1;
          e = 1.f;
        }
      }
      ws[tid] = w;
      es[tid] = e;
      const unsigned ballot = __ballot_sync(0xffffffffu, w);
      if (tid == 0) count += __popc(ballot);
    }
    if (!__syncthreads_or(w)) continue;  // no row of these 32 is summed
    for (int idx = tid; idx < 32 * d; idx += 256) {
      const int r = idx / d, c = idx - (idx / d) * d;
      const long long row = base + r;
      float x = 0.f, y = 0.f;
      if (ws[r]) {
        if (job == 0) {
          const long long hr = row / sq, i = row - hr * sq;
          const long long at = ((b * n_heads + g * n_rep + hr) * sq + i) * d + c;
          x = widen(dout[at]);
          y = widen(q[at]);
        } else {
          const long long at = (bkv * sk + row) * d + c;
          x = widen(v[at]);
          y = widen(k[at]);
        }
      }
      xs[r][c] = x;
      ys[r][c] = y;
    }
    for (int idx = tid; idx < 32 * (np * 8 - d); idx += 256) {  // columns past D: 0
      const int r = idx / (np * 8 - d), c = d + idx - r * (np * 8 - d);
      xs[r][c] = 0.f;
      ys[r][c] = 0.f;
    }
    __syncthreads();
    if (patch) {
      for (int r = 0; r < 32; ++r) {
        const float4 x0 = *reinterpret_cast<const float4*>(&xs[r][8 * pa]);
        const float4 x1 = *reinterpret_cast<const float4*>(&xs[r][8 * pa + 4]);
        const float4 y0 = *reinterpret_cast<const float4*>(&ys[r][8 * pb]);
        const float4 y1 = *reinterpret_cast<const float4*>(&ys[r][8 * pb + 4]);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
    }
    if (tid < d) {
      for (int r = 0; r < 32; ++r) border += xs[r][tid];
    } else if (tid >= 128 && tid < 128 + d) {
      for (int r = 0; r < 32; ++r) border = fmaf(es[r], ys[r][tid - 128], border);
    }
  }
  const long long E = sum_elems(d);
  float* out = nk.partials + ((bkv * 2 + job) * SUM_CHUNKS + chunk) * E;
  if (patch) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * pa + i < d && 8 * pb + j < d) out[(8 * pa + i) * d + 8 * pb + j] = acc[i][j];
  }
  if (tid < d) out[(long long)d * d + tid] = border;
  else if (tid >= 128 && tid < 128 + d) out[(long long)d * d + d + tid - 128] = border;
  if (job == 0 && tid == 0) nk.chunk_counts[bkv * SUM_CHUNKS + chunk] = count;
}

// One m16n8k16 bf16 product with f32 accumulation, c += a b.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// gram_kernel on the tensor cores, for bf16 with D % 8 == 0 (the
// tensor-core route's): the products of two bf16 values are exact and the
// m16n8k16 mma adds them in f32, so G carries the f32 sums' precision.
// Rows GRAM_ROWS at a time (k-steps of 16), staged transposed as bf16
// ([col][row]: an mma fragment's row pairs are one 32-bit word; a warp's
// lanes stage 32 rows of one column vector, so the stores spread over the
// banks); G's (DP/16) x (DP/8) tiles of 16 x 8 dealt round-robin to the 8
// warps, at most 16 a warp; sx and sy on the f32 units from the same rows.
constexpr int GRAM_ROWS = 128;
constexpr int GRAM_LD = GRAM_ROWS + 8;  // a staged column (bf16)
__global__ void __launch_bounds__(256, 2)
    gram_mma(int job, const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, long long delta_stride, NoKey nk, int n_heads,
             int n_rep, long long sq, long long sk, int d) {
  extern __shared__ __align__(16) uint8_t smem_u8[];
  __shared__ float es[GRAM_ROWS];
  __shared__ int ws[GRAM_ROWS];
  __shared__ int counted[GRAM_ROWS / 32];
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(smem_u8);  // [128 cols][GRAM_LD]
  __nv_bfloat16* yt = xt + 128 * GRAM_LD;
  const long long bkv = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_kv = n_heads / n_rep;
  const long long b = bkv / n_kv, grp = bkv - b * n_kv;
  if (job == 1) {
    int total = 0;
    for (int c = 0; c < SUM_CHUNKS; ++c) total += nk.chunk_counts[bkv * SUM_CHUNKS + c];
    if (total == 0) return;
  }
  const int dp = (d + 15) / 16 * 16;
  const int n_tiles = (dp / 16) * (dp / 8);
  for (int i = tid; i < 2 * 128 * GRAM_LD; i += 256)  // columns past D stay 0
    xt[i] = __float2bfloat16_rn(0.f);
  const long long rows = job == 0 ? n_rep * sq : sk;
  const long long r0 = rows * chunk / SUM_CHUNKS, r1 = rows * (chunk + 1) / SUM_CHUNKS;
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float border = 0.f;
  int count = 0;
  const int vecs = d / 8;  // 16-byte vectors a row
  for (long long base = r0; base < r1; base += GRAM_ROWS) {
    __syncthreads();  // the previous rows are consumed (and the zeros written)
    int w = 0;
    if (tid < GRAM_ROWS) {
      const long long r = base + tid;
      float e = 0.f;
      if (r < r1) {
        if (job == 0) {
          const long long hr = r / sq, i = r - hr * sq;
          const long long bh = b * n_heads + grp * n_rep + hr;
          w = lse[bh * sq + i] == NEG_INF;
          e = w ? delta[bh * delta_stride + i] : 0.f;
        } else {
          w = 1;
          e = 1.f;
        }
      }
      ws[tid] = w;
      es[tid] = e;
      const unsigned ballot = __ballot_sync(0xffffffffu, w);
      if (lane == 0) counted[warp] = __popc(ballot);
    }
    if (!__syncthreads_or(w)) continue;  // no row of these is summed
    if (tid == 0)
      for (int i = 0; i < GRAM_ROWS / 32; ++i) count += counted[i];
    // the round's loads in two halves (at most 4 vector pairs a thread each),
    // each issued before its transposed stores
#pragma unroll
    for (int half = 0; half < 2; ++half) {
    constexpr int U = GRAM_ROWS * 16 / 256 / 2;
    uint4 xv[U], yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = tid + 256 * (u + U * half), r = idx % GRAM_ROWS, c = idx / GRAM_ROWS * 8;
      const long long row = base + r;
      xv[u] = yv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < GRAM_ROWS * vecs && ws[r]) {
        long long at;
        if (job == 0) {
          const long long hr = row / sq, i = row - hr * sq;
          at = ((b * n_heads + grp * n_rep + hr) * sq + i) * d + c;
          xv[u] = *reinterpret_cast<const uint4*>(dout + at);
          yv[u] = *reinterpret_cast<const uint4*>(q + at);
        } else {
          at = (bkv * sk + row) * d + c;
          xv[u] = *reinterpret_cast<const uint4*>(v + at);
          yv[u] = *reinterpret_cast<const uint4*>(k + at);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = tid + 256 * (u + U * half), r = idx % GRAM_ROWS, c = idx / GRAM_ROWS * 8;
      if (idx >= GRAM_ROWS * vecs) break;
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv[u]);
      const __nv_bfloat16* ye = reinterpret_cast<const __nv_bfloat16*>(&yv[u]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xt[(c + j) * GRAM_LD + r] = xe[j];
        yt[(c + j) * GRAM_LD + r] = ye[j];
      }
    }
    }
    __syncthreads();
    for (int ks = 0; ks < GRAM_ROWS; ks += 16) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int tile = warp + 8 * i;
        if (tile >= n_tiles) break;
        const int ma = tile / (dp / 8), nb = tile - ma * (dp / 8);
        const int a = (16 * ma + g) * GRAM_LD + ks + 2 * t;
        const int bc = (8 * nb + g) * GRAM_LD + ks + 2 * t;
        const uint32_t frag[4] = {*reinterpret_cast<const uint32_t*>(xt + a),
                                  *reinterpret_cast<const uint32_t*>(xt + a + 8 * GRAM_LD),
                                  *reinterpret_cast<const uint32_t*>(xt + a + 8),
                                  *reinterpret_cast<const uint32_t*>(xt + a + 8 * GRAM_LD + 8)};
        mma_bf16(acc[i], frag, *reinterpret_cast<const uint32_t*>(yt + bc),
                 *reinterpret_cast<const uint32_t*>(yt + bc + 8));
      }
    }
    if (tid < d) {  // two rows a 32-bit read
      const __nv_bfloat162* col = reinterpret_cast<const __nv_bfloat162*>(xt + tid * GRAM_LD);
      for (int r = 0; r < GRAM_ROWS / 2; ++r) {
        const float2 x2 = __bfloat1622float2(col[r]);
        border += x2.x;
        border += x2.y;
      }
    } else if (tid >= 128 && tid < 128 + d) {
      const __nv_bfloat162* col =
          reinterpret_cast<const __nv_bfloat162*>(yt + (tid - 128) * GRAM_LD);
      for (int r = 0; r < GRAM_ROWS / 2; ++r) {
        const float2 y2 = __bfloat1622float2(col[r]);
        border = fmaf(es[2 * r], y2.x, border);
        border = fmaf(es[2 * r + 1], y2.y, border);
      }
    }
  }
  const long long E = sum_elems(d);
  float* out = nk.partials + ((bkv * 2 + job) * SUM_CHUNKS + chunk) * E;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int tile = warp + 8 * i;
    if (tile >= n_tiles) break;
    const int ma = tile / (dp / 8), nb = tile - ma * (dp / 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = 16 * ma + g + 8 * (j >> 1), bcol = 8 * nb + 2 * t + (j & 1);
      if (a < d && bcol < d) out[(long long)a * d + bcol] = acc[i][j];
    }
  }
  if (tid < d) out[(long long)d * d + tid] = border;
  else if (tid >= 128 && tid < 128 + d) out[(long long)d * d + d + tid - 128] = border;
  if (job == 0 && tid == 0) nk.chunk_counts[bkv * SUM_CHUNKS + chunk] = count;
}

// sums = the chunks' partial sums added in order, per (batch, kv head)
// (blockIdx.x) and job (blockIdx.y); counts = the no-key rows of the group.
// Nothing where the group has no such row.
__global__ void __launch_bounds__(256)
    sum_chunks(NoKey nk, int d) {
  const long long bkv = blockIdx.x;
  const int job = blockIdx.y;
  int total = 0;
  for (int c = 0; c < SUM_CHUNKS; ++c) total += nk.chunk_counts[bkv * SUM_CHUNKS + c];
  if (job == 0 && blockIdx.z == 0 && threadIdx.x == 0) nk.counts[bkv] = total;
  if (total == 0) return;
  const long long E = sum_elems(d);
  const long long i = blockIdx.z * 256LL + threadIdx.x;
  if (i >= E) return;
  const float* part = nk.partials + (bkv * 2 + job) * SUM_CHUNKS * E + i;
  float acc = 0.f;
  for (int c = 0; c < SUM_CHUNKS; ++c) acc += part[c * E];
  nk.sums[(bkv * 2 + job) * E + i] = acc;
}

// The sums of both jobs: gram_kernel's (or on the tensor cores gram_mma's)
// two launches, then sum_chunks.
template <typename T>
cudaError_t launch_nokey_sums(const T* q, const T* k, const T* v, const T* dout,
                              const float* lse, const float* delta, long long delta_stride,
                              NoKey nk, long long batch, int n_heads, int n_kv_heads,
                              long long sq, long long sk, int d, bool tensor_cores,
                              cudaStream_t stream) {
  const dim3 grid((unsigned)(batch * n_kv_heads), SUM_CHUNKS);
  const size_t mma_smem = 2 * 128 * GRAM_LD * sizeof(__nv_bfloat16);
  if (tensor_cores) {
    const cudaError_t err =
        cudaFuncSetAttribute(gram_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mma_smem);
    if (err != cudaSuccess) return err;
  }
  for (int job = 0; job < 2; ++job) {
    if (tensor_cores)
      gram_mma<<<grid, 256, mma_smem, stream>>>(
          job, reinterpret_cast<const __nv_bfloat16*>(q),
          reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<const __nv_bfloat16*>(v),
          reinterpret_cast<const __nv_bfloat16*>(dout), lse, delta, delta_stride, nk, n_heads,
          n_heads / n_kv_heads, sq, sk, d);
    else
      gram_kernel<T><<<grid, 256, 0, stream>>>(job, q, k, v, dout, lse, delta, delta_stride,
                                               nk, n_heads, n_heads / n_kv_heads, sq, sk, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 sgrid((unsigned)(batch * n_kv_heads), 2,
                   (unsigned)((sum_elems(d) + 255) / 256));
  sum_chunks<<<sgrid, 256, 0, stream>>>(nk, d);
  return cudaGetLastError();
}

// dK and dV of one 64-key tile of one kv head, over its group's query heads
template <typename T, int NJ, bool POS>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int n_heads, int n_rep,
                int64_t sq, int64_t sk, int d, int causal, int has_window,
                int64_t window, float scale, int round_scores,
                const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                const uint8_t* __restrict__ kv_mask, const int* __restrict__ kb,
                const int* __restrict__ qb, NoKey nk, int* __restrict__ visited) {
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
  int* qp_s = reinterpret_cast<int*>(delta_s + BT);  // [BT], POS only

  const int64_t bkv = blockIdx.x;  // b * Hkv + g
  const int n_kv = n_heads / n_rep;
  const int64_t b = bkv / n_kv;
  const int g = (int)(bkv - b * n_kv);
  const int64_t k0 = (int64_t)blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, r0 = (tid / 16) * RPT;

  stage(ks, k + bkv * sk * d, k0, sk, d);
  stage(vs, v + bkv * sk * d, k0, sk, d);

  // the query tiles that keep any key of this tile (on the positions route
  // those the bounds leave live), and this thread's keys' positions
  const int64_t n_qt = (sq + BT - 1) / BT;
  const int64_t qt_begin = causal && !POS ? k0 / BT : 0;
  int64_t qt_end = n_qt;
  int kp[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    kp[i] = POS && k0 + r0 + i < sk ? key_position(k_pos, kv_mask, b, sk, k0 + r0 + i)
                                    : MASKED;
  if (has_window && !POS) {
    const int64_t last = k0 + BT - 1 + window - 1;  // last query any key keeps
    const int64_t e = last < 0 ? 0 : last / BT + 1;
    qt_end = e < qt_end ? e : qt_end;
  }

  float acc_k[RPT][NJ], acc_v[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int64_t n_kb = bound_tiles(sk), n_qb = bound_tiles(sq);
  const Bounds kbd = POS ? key_bounds(kb, b, n_kb, blockIdx.y, blockIdx.y + 1) : Bounds{};
  int seen = 0;  // the live tiles visited (POS)
  for (int hr = 0; hr < n_rep; ++hr) {
    const int64_t bh = b * n_heads + (int64_t)g * n_rep + hr;
    const T* qh = q + bh * sq * d;
    const T* doh = dout + bh * sq * d;
    for (int64_t qt = qt_begin; qt < qt_end; ++qt) {
      const int64_t q0 = qt * BT;
      if (POS && tile_kind(query_bounds(qb, b, n_qb, qt), kbd, causal, has_window,
                           window) == TILE_DEAD)
        continue;  // the same for every thread: no pair of it is kept
      ++seen;
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage(qs, qh, q0, sq, d);
      stage(dos, doh, q0, sq, d);
      if (tid < BT) {
        lse_s[tid] = q0 + tid < sq ? lse[bh * sq + q0 + tid] : INFINITY;
        delta_s[tid] = q0 + tid < sq ? delta[bh * sq + q0 + tid] : 0.f;
        if (POS) qp_s[tid] = q0 + tid < sq ? q_pos[b * sq + q0 + tid] : 0;
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
          const float raw = round_scores ? widen(narrow<T>(s[i][j])) : s[i][j];
          float p;
          if (POS) {  // a masked pair, any pair of a row that keeps no key: 0
            p = k0 + r0 + i < sk && keeps(qp_s[qi], kp[i], causal, has_window, window)
                    ? expf(raw * scale - lse_s[qi])
                    : 0.f;
          } else {
            const bool ok = kept(q0 + qi, k0 + r0 + i, sq, sk, causal, has_window, window);
            p = ok ? expf(raw * scale - lse_s[qi]) : 0.f;
          }
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

  if (POS && tid == 0) atomicAdd(visited, seen);
  if (POS && nk.counts[bkv] > 0) {
    // the rows that keep no key: dV += sigma, dK += scale (N v - rho), with
    // G = N^T, sigma and rho staged where Q, dO, P and dS were
    __syncthreads();
    float* gs = qs;
    const float* sums = nk.sums + bkv * 2 * sum_elems(d);
    for (int64_t i = tid; i < sum_elems(d); i += THREADS) gs[i] = sums[i];
    __syncthreads();
    const float* sigma = gs + d * d;
    const float* rho = sigma + d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= d) continue;
      float nv[RPT] = {};
      for (int e = 0; e < d; ++e) {
        const float ge = gs[e * d + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) nv[i] = fmaf(ge, vs[(r0 + i) * ld + e], nv[i]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        acc_k[i][j] += scale * (nv[i] - rho[c]);
        acc_v[i][j] += sigma[c];
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
template <typename T, int NJ, bool POS>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int n_heads, int n_rep, int64_t sq,
              int64_t sk, int d, int causal, int has_window, int64_t window,
              float scale, int round_scores, const int* __restrict__ q_pos,
              const int* __restrict__ k_pos, const uint8_t* __restrict__ kv_mask,
              const int* __restrict__ kb, const int* __restrict__ qb, NoKey nk,
              int* __restrict__ visited) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;               // [BT][ld]
  float* dos = qs + BT * ld;      // [BT][ld]
  float* ks = dos + BT * ld;      // [BT][ld]
  float* vs = ks + BT * ld;       // [BT][ld]
  float* dss = vs + BT * ld;      // [query][key], [BT][BT + 1]
  int* kp_s = reinterpret_cast<int*>(dss + BT * (BT + 1));  // [BT], POS only

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
  int qp[RPT];  // the rows' positions (POS)
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q0 + r0 + i;
    row_lse[i] = row < sq ? lse[bh * sq + row] : INFINITY;
    row_delta[i] = row < sq ? delta[bh * sq + row] : 0.f;
    qp[i] = POS && row < sq ? q_pos[b * sq + row] : 0;
  }

  // the live key tiles of this query tile, the forward's rule (on the
  // positions route those the bounds leave live)
  const int64_t n_kt = (sk + BT - 1) / BT;
  int64_t kt_end = n_kt;
  if (causal && !POS) {
    const int64_t last = (q0 + BT - 1) / BT + 1;
    kt_end = last < n_kt ? last : n_kt;
  }
  int64_t kt_begin = 0;
  if (has_window && !POS) {
    const int64_t lo = q0 - window + 1;  // first key any row keeps
    if (lo > 0) kt_begin = lo / BT;
  }

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int64_t n_kb = bound_tiles(sk), n_qb = bound_tiles(sq);
  const Bounds qbd = POS ? query_bounds(qb, b, n_qb, blockIdx.y) : Bounds{};
  int seen = 0;  // the live tiles visited (POS)
  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * BT;
    if (POS && tile_kind(qbd, key_bounds(kb, b, n_kb, kt, kt + 1), causal, has_window,
                         window) == TILE_DEAD)
      continue;  // the same for every thread: no pair of it is kept
    ++seen;
    __syncthreads();  // the previous tile is consumed (and Q, dO staged)
    stage(ks, k + bkv * sk * d, k0, sk, d);
    stage(vs, v + bkv * sk * d, k0, sk, d);
    if (POS && tid < BT)
      kp_s[tid] = k0 + tid < sk ? key_position(k_pos, kv_mask, b, sk, k0 + tid) : MASKED;
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
        const float raw = round_scores ? widen(narrow<T>(s[i][j])) : s[i][j];
        float p;
        if (POS) {  // a masked pair, any pair of a row that keeps no key: 0
          p = k0 + kj < sk && keeps(qp[i], kp_s[kj], causal, has_window, window)
                  ? expf(raw * scale - row_lse[i])
                  : 0.f;
        } else {
          const bool ok = kept(q0 + r0 + i, k0 + kj, sq, sk, causal, has_window, window);
          p = ok ? expf(raw * scale - row_lse[i]) : 0.f;
        }
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

  if (POS && tid == 0) atomicAdd(visited + 1, seen);
  if (POS) {
    // a row that keeps no key: dQ = scale (A dO - delta kappa), with G = A^T
    // and kappa staged where K, V and dS were
    bool none[RPT], mine = false;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      none[i] = q0 + r0 + i < sq && row_lse[i] == NEG_INF;
      mine = mine || none[i];
    }
    if (__syncthreads_or(mine) && nk.counts[bkv] > 0) {
      float* gs = ks;
      const float* sums = nk.sums + (bkv * 2 + 1) * sum_elems(d);
      for (int64_t i = tid; i < sum_elems(d); i += THREADS) gs[i] = sums[i];
      __syncthreads();
      const float* kappa = gs + d * d + d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c >= d) continue;
        float ad[RPT] = {};
        for (int e = 0; e < d; ++e) {
          const float ge = gs[e * d + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) ad[i] = fmaf(ge, dos[(r0 + i) * ld + e], ad[i]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          if (none[i]) acc[i][j] += scale * (ad[i] - row_delta[i] * kappa[c]);
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

template <typename T, int NJ, bool POS>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
           int64_t sk, int d, int causal, int has_window, int64_t window,
           float scale, int round_scores, const int* q_pos, const int* k_pos,
           const uint8_t* kv_mask, const int* kb, const int* qb, NoKey nk, int* visited,
           cudaStream_t stream) {
  const int ld = d + 1;
  const size_t tile = sizeof(float) * (size_t)BT * ld;
  const size_t grid_tile = sizeof(float) * (size_t)BT * (BT + 1);
  const size_t pos_row = POS ? sizeof(int) * BT : 0;  // a tile's positions
  const size_t smem_dkdv = 4 * tile + 2 * grid_tile + 2 * sizeof(float) * BT + pos_row;
  const size_t smem_dq = 4 * tile + grid_tile + pos_row;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, NJ, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, NJ, POS>,
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
  if (POS) {
    err = launch_nokey_sums<T>(qt, kt, vt, dot, lse, delta, sq, nk, batch, n_heads,
                               n_kv_heads, sq, sk, d, false, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (sk > 0) {
    const dim3 grid_kv((unsigned)(batch * n_kv_heads), (unsigned)((sk + BT - 1) / BT));
    dkdv_kernel<T, NJ, POS><<<grid_kv, THREADS, smem_dkdv, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n_heads,
        n_rep, sq, sk, d, causal, has_window, window, scale, round_scores, q_pos, k_pos,
        kv_mask, kb, qb, nk, visited);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((unsigned)(batch * n_heads), (unsigned)((sq + BT - 1) / BT));
  dq_kernel<T, NJ, POS><<<grid_q, THREADS, smem_dq, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), n_heads, n_rep, sq, sk, d,
      causal, has_window, window, scale, round_scores, q_pos, k_pos, kv_mask, kb, qb, nk,
      visited);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk,
             void* dv, int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
             int64_t sk, int d, int causal, int has_window, int64_t window,
             float scale, int round_scores, const int* q_pos, const int* k_pos,
             const uint8_t* kv_mask, const int* kb, const int* qb, NoKey nk, int* visited,
             cudaStream_t s) {
  const int nj = (d + 15) / 16;
#define BWD_CASE(N)                                                                   \
  return q_pos != nullptr                                                             \
             ? launch<T, N, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,     \
                                  n_heads, n_kv_heads, sq, sk, d, causal, has_window,  \
                                  window, scale, round_scores, q_pos, k_pos, kv_mask,  \
                                  kb, qb, nk, visited, s)                              \
             : launch<T, N, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,    \
                                   n_heads, n_kv_heads, sq, sk, d, causal, has_window, \
                                   window, scale, round_scores, q_pos, k_pos, kv_mask, \
                                   kb, qb, nk, visited, s)
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
// a stage's lse and delta rows, on the positions route also the rows' positions
__host__ __device__ constexpr uint32_t rows_bytes(bool pos) { return (pos ? 3 : 2) * BQ * 4; }
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
// NEG_INF in log2 units: the rows kernel's lse2 of a row whose forward lse
// is NEG_INF, bit for bit (one rounded product of the same two floats)
constexpr float NEG2 = NEG_INF * LOG2E;

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
// tile meets (the accumulator holds nothing there: on the index route by
// the tile rule, on the positions route where no key tile counted an add
// on its counter). One thread per 8 columns of a row.
template <bool POS>
__global__ void __launch_bounds__(256)
    dq_kernel(const float* __restrict__ acc, const int* __restrict__ counters,
              __nv_bfloat16* __restrict__ dq, long long rows, int sq, int sk, int d, int dp,
              int causal, int has_window, int window, float scale) {
  const int groups = d / 8;
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= rows * groups) return;
  const long long row = i / groups;  // bh * sq + r
  const int c = (int)(i - row * groups) * 8;
  const long long bh = row / sq;
  const int r = (int)(row - bh * sq);
  const int qt = r / BQ, n_qt = (sq + BQ - 1) / BQ;
  bool added;
  if (POS) {
    added = counters[bh * n_qt + qt] > 0;
  } else {
    int kt_begin, kt_end;
    key_tiles(qt, sk, causal, has_window, window, kt_begin, kt_end);
    added = kt_begin < kt_end;
  }
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (added) {
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

constexpr int NOKEY_DQ_CHUNKS = 16;  // row chunks a (batch, kv head)
constexpr int NOKEY_ROWS = 128;      // rows a step of dq_nokey_kernel

// The positions route's dq of the rows that keep no key (lse NEG_INF),
// after dq_kernel: dq = scale * (the accumulator + A dO - delta kappa), on
// the tensor cores. A (f32) is split as A_hi + A_lo, both bf16 (A_lo the
// bf16 rounding of A - A_hi, so the pair holds A to about 2^-17); dO is
// bf16, so both products are exact and the m16n8k16 mma adds them in f32.
// One block per (batch, kv head) (blockIdx.x) and chunk of the group's
// rows, head by head (blockIdx.y); A_hi, A_lo ([c][e], bf16) and kappa
// staged once, then 128 rows at a time (a set with no such row skipped):
// their dO staged as it lies ([row][e]), warp w the rows 16w..16w+15
// against every 8-column tile of DP.
__global__ void __launch_bounds__(256)
    dq_nokey_kernel(const float* __restrict__ acc, const int* __restrict__ counters,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, NoKey nk,
                    __nv_bfloat16* __restrict__ dq, int n_heads, int n_rep, int sq, int d,
                    int dp, float scale) {
  extern __shared__ __align__(16) uint8_t smem_u8[];
  __shared__ int none_s[NOKEY_ROWS];
  const long long bkv = blockIdx.x;
  if (nk.counts[bkv] == 0) return;
  const int n_kv = n_heads / n_rep;
  const long long b = bkv / n_kv, g = bkv - b * n_kv;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const int ld = dp + 8;  // bf16 a staged row
  __nv_bfloat16* ahi = reinterpret_cast<__nv_bfloat16*>(smem_u8);  // [dp][ld]
  __nv_bfloat16* alo = ahi + dp * ld;                               // [dp][ld]
  __nv_bfloat16* dos = alo + dp * ld;                               // [NOKEY_ROWS][ld]
  float* kappa = reinterpret_cast<float*>(dos + NOKEY_ROWS * ld);   // [dp]
  const float* sums = nk.sums + (bkv * 2 + 1) * sum_elems(d);  // G[e][c] = A[c][e]
  for (int i = tid; i < dp * ld; i += 256) {
    const int c = i / ld, e = i - c * ld;
    const float a = c < d && e < d ? sums[e * d + c] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(a);
    ahi[i] = hi;
    alo[i] = __float2bfloat16_rn(a - __bfloat162float(hi));
  }
  for (int c = tid; c < dp; c += 256) kappa[c] = c < d ? sums[d * d + d + c] : 0.f;
  const long long rows = (long long)n_rep * sq;
  const long long r0 = rows * blockIdx.y / NOKEY_DQ_CHUNKS;
  const long long r1 = rows * (blockIdx.y + 1) / NOKEY_DQ_CHUNKS;
  auto at_of = [&](long long row) {  // b*H + h and row of the group's row, as bh * sq + r
    const long long hr = row / sq;
    return (b * n_heads + g * n_rep + hr) * sq + row - hr * sq;
  };
  const int vecs = dp / 8;  // 16-byte vectors of a staged row
  for (long long base = r0; base < r1; base += NOKEY_ROWS) {
    __syncthreads();  // the previous rows' dO is consumed (and A staged)
    bool mine = false;
    if (tid < NOKEY_ROWS) {
      const long long row = base + tid;
      none_s[tid] = row < r1 && lse[at_of(row)] == NEG_INF;
      mine = none_s[tid];
    }
    if (!__syncthreads_or(mine)) continue;
    uint4 xv[NOKEY_ROWS * 16 / 256];  // every load of the round first, then the stores
#pragma unroll
    for (int u = 0; u < NOKEY_ROWS * 16 / 256; ++u) {
      const int i = tid + 256 * u, r = i / vecs, e = (i - r * vecs) * 8;
      xv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < NOKEY_ROWS * vecs && none_s[r] && e < d)
        xv[u] = *reinterpret_cast<const uint4*>(dout + at_of(base + r) * d + e);
    }
#pragma unroll
    for (int u = 0; u < NOKEY_ROWS * 16 / 256; ++u) {
      const int i = tid + 256 * u, r = i / vecs, e = (i - r * vecs) * 8;
      if (i < NOKEY_ROWS * vecs) *reinterpret_cast<uint4*>(dos + r * ld + e) = xv[u];
    }
    __syncthreads();
    float cacc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) cacc[n][j] = 0.f;
    const int m0 = 16 * warp;
    for (int k0 = 0; k0 < dp; k0 += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(dos + (m0 + gr) * ld + k0 + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(dos + (m0 + gr + 8) * ld + k0 + 2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(dos + (m0 + gr) * ld + k0 + 2 * t + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(dos + (m0 + gr + 8) * ld + k0 + 2 * t + 8);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (8 * n >= dp) break;
        const int at = (8 * n + gr) * ld + k0 + 2 * t;
        mma_bf16(cacc[n], a, *reinterpret_cast<const uint32_t*>(ahi + at),
                 *reinterpret_cast<const uint32_t*>(ahi + at + 8));
        mma_bf16(cacc[n], a, *reinterpret_cast<const uint32_t*>(alo + at),
                 *reinterpret_cast<const uint32_t*>(alo + at + 8));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows m0 + gr and m0 + gr + 8
      const int r = m0 + gr + 8 * h;
      if (!none_s[r]) continue;
      const long long at = at_of(base + r);
      const long long bh = at / sq, rr = at - bh * sq;
      const long long tile = bh * n_qt + rr / BQ;
      const float dl = delta[bh * (n_qt * BQ) + rr];
      const bool added = counters[tile] > 0;
      const float* src = acc + (tile * BQ + rr % BQ) * dp;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = 8 * n + 2 * t;
        if (c >= d) break;  // D % 8 == 0: c + 1 < D too
        float v0 = cacc[n][2 * h] - dl * kappa[c];
        float v1 = cacc[n][2 * h + 1] - dl * kappa[c + 1];
        if (added) {
          const float2 s2 = *reinterpret_cast<const float2*>(src + c);
          v0 += s2.x;
          v1 += s2.y;
        }
        *reinterpret_cast<uint32_t*>(dq + at * d + c) = pack_bf16(v0 * scale, v1 * scale);
      }
    }
  }
}

template <int DP, bool POS>
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
           int round_scores, const int* __restrict__ q_pos,
           const int* __restrict__ k_pos, const uint8_t* __restrict__ kv_mask,
           const int* __restrict__ walk, const int* __restrict__ queries, NoKey nk,
           const __nv_bfloat16* __restrict__ v) {
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
  constexpr uint32_t RB = rows_bytes(POS);
  const uint32_t rows_s = dq_s + 2 * DQ_BYTES;   // + stage * RB
  const uint32_t bars = rows_s + STAGES * RB;
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
  int qt_begin = 0, qt_end = n_qt;
  if (!POS) query_tiles(kt, sq, causal, has_window, window, qt_begin, qt_end);
  // On the positions route the query tiles whose bounds leave this key
  // tile live, ascending, each with its warpgroups' kinds (interior:
  // mask-free) and its rank among the query tile's live key tiles: the
  // list that bwd_walk (csrc/positions.cuh) wrote, which every role reads
  const int* list = POS ? walk + ((long long)b * gridDim.y + kt) * (1 + 2 * n_qt) : nullptr;
  const long long n_qb = bound_tiles(sq);  // the padded query positions' blocks a row
  if (POS) {
    qt_begin = 0;
    qt_end = list[0];
  }
  const int n_q = qt_end - qt_begin;
  // step i: head h0 + i / n_q, the (i % n_q)-th live query tile
  const int steps = n_rep * n_q;
  auto step_tile = [&](int i) {  // the query tile of step i
    return POS ? walk_tile(list[1 + 2 * (i % n_q)]) : qt_begin + i % n_q;
  };

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
        const int q0 = step_tile(i) * BQ;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * QT + RB);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load(q_s + s * QT + c * QBOX, &qmap, c * CHUNK, q0, bh, full(s));
          tma_load(do_s + s * QT + c * QBOX, &domap, c * CHUNK, q0, bh, full(s));
        }
        const long long row = (long long)bh * sq_pad + q0;
        bulk_load(rows_s + s * RB, lse2 + row, BQ * 4, full(s));
        bulk_load(rows_s + s * RB + BQ * 4, delta + row, BQ * 4, full(s));
        if (POS)
          bulk_load(rows_s + s * RB + 2 * BQ * 4, queries + (long long)b * n_qb * BND + q0,
                    BQ * 4, full(s));
      }
    } else if (warp == DQ_WARP && lane == 0) {
      // ---- the ordered dQ adds: key tiles in ascending order per query tile ----
      for (int i = 0; i < steps; ++i) {
        const int buf = i & 1;
        const int hr = i / n_q;
        const int qt = step_tile(i);
        const long long tile = (long long)(h0 + hr) * n_qt + qt;
        int before;  // the (live) key tiles that add before this one
        if (POS) {
          before = list[2 + 2 * (i % n_q)];
        } else {
          int kt_first, kt_end;
          key_tiles(qt, sk, causal, has_window, window, kt_first, kt_end);
          before = kt - kt_first;
        }
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
    int kp[2] = {MASKED, MASKED};  // this thread's keys' positions (POS)
    if (POS) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (key0 + 8 * r < sk) kp[r] = key_position(k_pos, kv_mask, b, sk, key0 + 8 * r);
    }

    float acc_v[DP / 2], acc_k[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
    mbar_wait(kv_full, 0);

    int e_next = POS && steps > 0 ? list[1] : 0;  // the walk's next entry (POS)
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES, buf = i & 1;
      const int e = e_next;
      if (POS && i + 1 < steps) e_next = list[1 + 2 * ((i + 1) % n_q)];  // a step ahead
      const int q0 = (POS ? walk_tile(e) : step_tile(i)) * BQ;
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
      // need the mask (on the positions route: those the bounds do not
      // prove interior)
      const float* lse_row = rows_g + s * (RB / 4);
      const float* delta_row = lse_row + BQ;
      const int* qpos_row = reinterpret_cast<const int*>(delta_row + BQ);  // POS
      const bool edge =
          POS ? walk_kind(e, wg) != TILE_INTERIOR
              : kw + WG_KEYS > sk || (causal && kw + WG_KEYS - 1 > q0) ||
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
          const float lr = (e & 1) ? l2.y : l2.x;
          float p = ex2(fmaf(sc[4 * j + e], scale_log2, -lr));
          if (edge) {
            const int key = key0 + 8 * (e >> 1);
            const int qpos = q0 + 8 * j + 2 * t + (e & 1);
            bool ok = key < sk;
            if (POS) {  // a masked pair, any pair of a row that keeps no key: 0
              const int qp = qpos_row[8 * j + 2 * t + (e & 1)];
              p = ok && keeps(qp, kp[e >> 1], causal, has_window, window) ? p : 0.f;
            } else {
              if (causal) ok = ok && key <= qpos;
              if (has_window) ok = ok && (long long)qpos - key < window;
              p = ok ? p : 0.f;
            }
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

    if (POS && nk.counts[bkv] > 0) {
      // the rows that keep no key: dV += sigma, dK += N v - rho (the scale
      // comes below), with G = N^T [D][DP], sigma and rho staged in the
      // Q/dO ring and the dS buffers, free once both warpgroups are done
      consumers_sync();
      float* gs = reinterpret_cast<float*>(gen + (q_s - base));
      const float* sums = nk.sums + (long long)bkv * 2 * sum_elems(d);
      for (int idx = threadIdx.x; idx < d * DP; idx += CONSUMERS * 128) {
        const int e = idx / DP, c = idx - e * DP;
        gs[idx] = c < d ? sums[e * d + c] : 0.f;
      }
      for (int c = threadIdx.x; c < 2 * DP; c += CONSUMERS * 128) {
        const int which = c / DP, cc = c - which * DP;  // sigma, then rho
        gs[d * DP + c] = cc < d ? sums[d * d + which * d + cc] : 0.f;
      }
      consumers_sync();
      const __nv_bfloat16* v0 = v + ((long long)bkv * sk + key0) * d;
      const bool has0 = key0 < sk, has1 = key0 + 8 < sk;
      for (int e = 0; e < d; e += 2) {
        const float2 a = has0 ? __bfloat1622float2(
                                    *reinterpret_cast<const __nv_bfloat162*>(v0 + e))
                              : make_float2(0.f, 0.f);
        const float2 c = has1 ? __bfloat1622float2(
                                    *reinterpret_cast<const __nv_bfloat162*>(v0 + 8 * d + e))
                              : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 g0 = *reinterpret_cast<const float2*>(gs + e * DP + col);
          const float2 g1 = *reinterpret_cast<const float2*>(gs + (e + 1) * DP + col);
          acc_k[4 * j] = fmaf(g0.x, a.x, fmaf(g1.x, a.y, acc_k[4 * j]));
          acc_k[4 * j + 1] = fmaf(g0.y, a.x, fmaf(g1.y, a.y, acc_k[4 * j + 1]));
          acc_k[4 * j + 2] = fmaf(g0.x, c.x, fmaf(g1.x, c.y, acc_k[4 * j + 2]));
          acc_k[4 * j + 3] = fmaf(g0.y, c.x, fmaf(g1.y, c.y, acc_k[4 * j + 3]));
        }
      }
      const float* sigma = gs + d * DP;
      const float* rho = sigma + DP;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          acc_k[4 * j + x] -= rho[col + (x & 1)];
          acc_v[4 * j + x] += sigma[col + (x & 1)];
        }
      }
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

constexpr size_t smem_bytes(int dp, bool pos) {
  return (size_t)2 * (dp / CHUNK) * KBOX + (size_t)2 * STAGES * (dp / CHUNK) * QBOX +
         2 * DS_BYTES + (size_t)2 * BQ * dp * 4 + STAGES * rows_bytes(pos) +
         8 * (1 + 2 * STAGES + 4) + 1024;
}

// scratch: lse2 then delta, f32 [B*H, n_qt * 64] each; dq_acc f32
// [B*H, n_qt, 64, DP]; counters int32 [B*H, n_qt] (zeroed here).
template <int DP, bool POS>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* scratch, float* dq_acc, int* counters, void* dq,
           void* dk, void* dv, long long batch, int n_heads, int n_kv_heads, long long sq,
           long long sk, int d, int causal, int has_window, long long window,
           float scale, int round_scores, const int* q_pos, const int* k_pos,
           const uint8_t* kv_mask, const int* bounds, int* walk, NoKey nk,
           cudaStream_t stream) {
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
  if (POS) {
    err = launch_walk(bounds, walk, true, batch, sq, sk, causal, has_window, win, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_nokey_sums<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), dob, lse, delta, sq_pad, nk, batch, n_heads,
        n_kv_heads, sq, sk, d, true, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_kt = (sk + BK - 1) / BK;
  if (n_kt > 0) {
    CUtensorMap qm, km, vm, dom;
    int rc = encode(&qm, q, bh, sq, d, BQ);
    if (rc == 0) rc = encode(&dom, dout, bh, sq, d, BQ);
    if (rc == 0) rc = encode(&km, k, batch * n_kv_heads, sk, d, BK);
    if (rc == 0) rc = encode(&vm, v, batch * n_kv_heads, sk, d, BK);
    if (rc != 0) return rc;
    const size_t smem = smem_bytes(DP, POS);
    err = cudaFuncSetAttribute(bwd_tc<DP, POS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg moves registers inside the block only: the producer
    // warpgroup must free at least what the consumers take
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, bwd_tc<DP, POS>);
    if (err != cudaSuccess) return (int)err;
    if (128 * (attr.numRegs - PRODUCER_REGS) <
        CONSUMERS * 128 * (CONSUMER_REGS - attr.numRegs))
      return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)(batch * n_kv_heads), (unsigned)n_kt);
    bwd_tc<DP, POS><<<grid, THREADS, smem, stream>>>(
        qm, km, vm, dom, lse2, delta, dq_acc, counters, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n_heads, n_heads / n_kv_heads, (int)sq, (int)sk,
        d, causal, has_window, win, scale, scale * LOG2E, round_scores, q_pos, k_pos,
        kv_mask, walk, bounds + bounds_head(batch, sq, sk), nk,
        static_cast<const __nv_bfloat16*>(v));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows = bh * sq;
  dq_kernel<POS><<<(unsigned)((rows * (d / 8) + 255) / 256), 256, 0, stream>>>(
      dq_acc, counters, static_cast<__nv_bfloat16*>(dq), rows, (int)sq, (int)sk, d, DP,
      causal, has_window, win, scale);
  err = cudaGetLastError();
  if (!POS || err != cudaSuccess) return (int)err;
  const size_t dq_smem = sizeof(__nv_bfloat16) * (2 * DP + NOKEY_ROWS) * (DP + 8) +
                         sizeof(float) * DP;
  err = cudaFuncSetAttribute(dq_nokey_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  dq_nokey_kernel<<<dim3((unsigned)(batch * n_kv_heads), NOKEY_DQ_CHUNKS), 256, dq_smem,
                    stream>>>(dq_acc, counters, dob, lse, delta, nk,
                              static_cast<__nv_bfloat16*>(dq), n_heads, n_heads / n_kv_heads,
                              (int)sq, d, DP, scale);
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

// The positions route's scratch, in elements: int32 (the tile bounds and
// the padded query positions, positions.cuh's bounds_ints, the tensor
// cores' walk, bwd_walk_ints, the no-key counts, then the SIMT route's
// visit counts, VISITED_INTS) and f32 (the no-key sums: SUM_CHUNKS
// partials and their total, per (batch, kv head) and job); `walk_at`,
// where in the int32 scratch the walk begins.
extern "C" void flash_attention_bwd_pos_scratch(long long batch, int n_kv_heads,
                                                long long sq, long long sk, int d,
                                                long long* ints, long long* floats,
                                                long long* walk_at) {
  *walk_at = bounds_ints(batch, sq, sk, false, true);
  *ints = *walk_at + bwd_walk_ints(batch, sq, sk) + nokey_ints(batch * n_kv_heads) +
          VISITED_INTS;
  *floats = nokey_floats(batch * n_kv_heads, d);
}

// q, o, dout, dq [B, H, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D], all contiguous
// and of one type (0 float32, 1 bfloat16); lse f32 [B, H, Sq] from the
// forward. Scratch: on the f32 route `rows` is delta, f32 [B, H, Sq], and
// `acc` and `counters` are unused; on the tensor-core route their sizes
// are flash_attention_bwd_scratch's. D <= 128, H a multiple of Hkv, Sq and
// Sk / 64 within the grid's y limit; on the tensor-core route besides Sq,
// Sk and B*H below 2^31 and the bf16 tensors 16-byte aligned. The
// positions route: the forward's q_pos int32 [B, Sq], k_pos int32 [B, Sk]
// and kv_mask bool [B, Sk] (all three, or null for the index route), and
// the scratch of flash_attention_bwd_pos_scratch (`pos_ints`, `pos_floats`).
// Returns 0 on success, else the cudaError_t.
extern "C" int flash_attention_bwd_launch(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* rows, float* acc, int* counters,
    void* dq, void* dk, void* dv, long long batch, int n_heads, int n_kv_heads,
    long long sq, long long sk, int d, int dtype, int causal, int has_window,
    long long window, float scale, int round_scores, const int* q_pos,
    const int* k_pos, const uint8_t* kv_mask, int* pos_ints, float* pos_floats,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      (sq + BT - 1) / BT > 65535 || (sk + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  if (q_pos != nullptr && (k_pos == nullptr || kv_mask == nullptr || pos_ints == nullptr ||
                           pos_floats == nullptr))
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
  const int* kb = nullptr;
  const int* qb = nullptr;
  int* walk = nullptr;
  NoKey nk = {};
  if (q_pos != nullptr) {  // the tile bounds (the walk comes in tcb::launch)
    err = launch_tile_bounds(q_pos, k_pos, kv_mask, pos_ints, false, true, batch, sq, sk, s);
    if (err != cudaSuccess) return (int)err;
    kb = pos_ints;
    qb = kb + batch * bound_tiles(sk) * 3;
    walk = pos_ints + bounds_ints(batch, sq, sk, false, true);
    nk = nokey_layout(walk + bwd_walk_ints(batch, sq, sk), pos_floats, batch * n_kv_heads,
                      d);
  }
  if (flash_attention_bwd_uses_tc(dtype, d)) {
    const long long lim = 1LL << 31;
    if (sq >= lim || sk >= lim || batch * n_heads >= lim)
      return (int)cudaErrorInvalidValue;
    if (q_pos != nullptr && (sq + BND - 1) / BND >= (1LL << WALK_SHIFT))  // walk entries
      return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
         reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
         reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(acc) |
         reinterpret_cast<uintptr_t>(rows)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
#define TC_CASE(DP)                                                                    \
  if (d <= DP)                                                                         \
    return q_pos != nullptr                                                            \
               ? tcb::launch<DP, true>(q, k, v, o, dout, lse, rows, acc, counters, dq, \
                                       dk, dv, batch, n_heads, n_kv_heads, sq, sk, d,  \
                                       causal, has_window, window, scale,              \
                                       round_scores, q_pos, k_pos, kv_mask, pos_ints,  \
                                       walk, nk, s)                                    \
               : tcb::launch<DP, false>(q, k, v, o, dout, lse, rows, acc, counters,    \
                                        dq, dk, dv, batch, n_heads, n_kv_heads, sq,    \
                                        sk, d, causal, has_window, window, scale,      \
                                        round_scores, q_pos, k_pos, kv_mask, pos_ints, \
                                        walk, nk, s)
    TC_CASE(16); TC_CASE(32); TC_CASE(48); TC_CASE(64);
    TC_CASE(80); TC_CASE(96); TC_CASE(112); TC_CASE(128);
#undef TC_CASE
    return (int)cudaErrorInvalidValue;
  }
  int* visited = nullptr;  // the SIMT route's visit counts
  if (q_pos != nullptr) {
    visited = nk.counts + batch * n_kv_heads;
    err = cudaMemsetAsync(visited, 0, VISITED_INTS * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, dout, lse, rows, dq, dk, dv, batch, n_heads,
                             n_kv_heads, sq, sk, d, causal, has_window, window, scale,
                             round_scores, q_pos, k_pos, kv_mask, kb, qb, nk, visited, s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, rows, dq, dk, dv, batch,
                                     n_heads, n_kv_heads, sq, sk, d, causal, has_window,
                                     window, scale, round_scores, q_pos, k_pos, kv_mask,
                                     kb, qb, nk, visited, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
