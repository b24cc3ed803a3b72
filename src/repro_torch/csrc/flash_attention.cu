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
//   - Softmax in registers on the accumulator's fragments: a row's max is
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
// exp(scale * q.k) over its kept keys) is stored only where the caller
// passes a pointer for it: the training forward, whose backward
// (csrc/flash_attention_bwd.cu) recomputes P = exp(scale * q.k - lse) from
// it, as the JAX package's _flash_bwd does. A row with no key kept gets
// +inf, so every P of it is 0. Storing it changes no bit of O.
//
// All element offsets are 64-bit in the SIMT kernel; the tensor-core
// kernel takes Sq, Sk < 2^31 (TMA coordinates are 32-bit).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// NJ: output columns per thread (8 * NJ >= D).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n_heads,
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
    if (lse != nullptr && tx == 0)
      lse[bh * sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    T* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 8 * j;
      if (c < d) orow[c] = narrow<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t batch,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, n_heads,
      n_heads / n_kv_heads, sq, sk, d, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int64_t batch, int n_heads, int n_kv_heads, int64_t sq,
             int64_t sk, int d, int causal, int has_window, int64_t window,
             float scale, cudaStream_t s) {
  const int nj = (d + 7) / 8;
#define FLASH_CASE(N)                                                        \
  return launch<T, N>(q, k, v, o, lse, batch, n_heads, n_kv_heads, sq, sk, d, \
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

}  // namespace simt

namespace tc {

constexpr int BQ = 128;        // query rows per block
constexpr int BK = 128;        // keys per tile
constexpr int WG_ROWS = 64;    // query rows per consumer warpgroup
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int PRODUCER_WARP = CONSUMERS * 4;  // first warp of the producer
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 3;      // K/V ring depth
constexpr int CHUNK = 16;      // bf16 columns per TMA box (32 bytes)
constexpr uint32_t BOX_BYTES = BK * CHUNK * 2;  // one 128-row box
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// ~10 s (a pipeline fault) traps, so a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > 20000000000LL) {
      __trap();
    }
  }
}

// One box of 16 columns x 128 rows at (column c0, row c1, head c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A 128-row tile of NC chunks of 16 columns, one box each.
template <int NC>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int row, int head, uint32_t bar) {
  mbar_expect_tx(bar, NC * BOX_BYTES);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(dst + c * BOX_BYTES, map, c * CHUNK, row, head, bar);
}

// wgmma shared-memory descriptor, 32-byte swizzle (layout type 3); the
// offsets in bytes.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) | (3ull << 62);
}
// K-major operand (Q, K): one chunk, rows of 32 B, 8-row groups 256 B apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw32_desc(addr, 16, 256);
}
// MN-major operand (V): 16 keys from `addr`, the next 16 columns of D one
// chunk further, 8-key groups 256 B apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw32_desc(addr, BOX_BYTES, 256);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Pin the accumulators after a wait: the compiler must not read them
// between the asynchronous product and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (+)= A B^T, m64n128k16, A and B K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O (+)= A B, m64nNk16: A from registers (4 x bf16x2), B MN-major in
// shared memory (descriptor, transposed: imm-trans-b = 1)
template <int N> struct WgmmaRS;
template <> struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaRS<48> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaRS<80> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaRS<96> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaRS<112> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};


template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
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

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue S = Q_wg K^T for one key tile (NC k-steps of m64n128k16) as one
// wgmma group; the caller waits.
template <int NC>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t q_wg,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
    wgmma_ss_n128(s, kmajor_desc(q_wg + c * BOX_BYTES),
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
    WgmmaRS<DP>::run(o, p[kk], mnmajor_desc(v_tile + kk * 16 * 32),
                     accumulate || kk > 0);
  wgmma_commit();
}

// Accumulator fragment of m64nNk16 (f32): thread (warp w, lane 4g + t) of
// a warpgroup holds, for each 8-column block j, rows 16w + g (d[4j],
// d[4j+1]) and 16w + g + 8 (d[4j+2], d[4j+3]) at columns 8j + 2t, +1.
// These are also P's A fragment for k-step kk: p[kk][i] = bf16x2 of
// s[8kk + 2i], s[8kk + 2i + 1].

// Online softmax of one score tile in place, in the log2 domain: masks it
// where it straddles Sk, the diagonal or the window's edge (interior
// tiles skip the mask), updates the rows' max m and per-thread partial sum
// l, leaves p = 2^(s - m) in s and the factor for the old accumulator in
// corr. A row whose max is still -inf takes p = 0 and keeps l = 0.
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], int k0,
                                             int row0, int qa, int sk, int causal,
                                             int has_window, int window,
                                             float scale_log2, int t) {
  const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qa) ||
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
          if (causal) ok = ok && col <= row;
          if (has_window) ok = ok && (long long)row - col < window;
          x = ok ? x : -INFINITY;
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

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int n_heads, int n_rep, int sq,
                 int sk, int d, int causal, int has_window, int window,
                 float scale_log2) {
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

  const int bh = blockIdx.x;  // b * n_heads + h
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int kvh = b * (n_heads / n_rep) + h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tiles first

  // the live KV tiles of this query tile, as the TPU kernel's rule
  const int n_kt = (sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (has_window) {
    const long long lo = (long long)q0 - window + 1;  // first key any row keeps
    if (lo > 0) kt_begin = (int)(lo / BK);
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
    if (warp == PRODUCER_WARP && lane == 0) {
      load_tile<NC>(q_s, &qmap, q0, bh, q_bar);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        load_tile<NC>(k_s + s * TILE, &kmap, kt * BK, kvh, k_full(s));
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
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // Per tile i: S(i+1) = Q K^T and O += P(i) V are issued back to back,
    // then softmax(i+1) runs while P(i) V is still on the tensor cores.
    // The warpgroups take turns to issue (ping-pong), so one's softmax
    // overlaps the other's products; warpgroup 0 goes first, and the
    // last turn of warpgroup 1 is not passed on, as nobody waits for it.
    mbar_wait(q_bar, 0);
    const int n_tiles = kt_end - kt_begin;
    float sc[BK / 2] = {};
    uint32_t p[BK / 16][4];
    float corr[2];
    if (n_tiles > 0) {
      if (wg == 1) turn_pass(wg);
      mbar_wait(k_full(0), 0);
      turn_wait(wg);
      qk_issue<NC>(sc, q_wg, k_s);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, m, l, corr, kt_begin * BK, row0, qa, sk, causal, has_window,
                   window, scale_log2, t);
      pack_p(sc, p);
    }
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int s = i % STAGES, s1 = (i + 1) % STAGES;
      mbar_wait(k_full(s1), ((i + 1) / STAGES) & 1);
      mbar_wait(v_full(s), (i / STAGES) & 1);
      turn_wait(wg);
      qk_issue<NC>(sc, q_wg, k_s + s1 * TILE);
      pv_issue<DP>(acc, p, v_s + s * TILE, 1);
      turn_pass(wg);
      wgmma_wait<1>();  // S(i+1) is ready, P(i) V may still run
      fence_regs(sc);
      softmax_tile(sc, m, l, corr, (kt_begin + i + 1) * BK, row0, qa, sk, causal,
                   has_window, window, scale_log2, t);
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

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (lse != nullptr && t == 0 && row < sq)  // m is in log2 units
        lse[(long long)bh * sq + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : INFINITY;
      l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;  // D % 8 == 0: col + 1 < D too
      if (col >= d) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= sq) continue;
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[4 * j + 2 * r] * l[r],
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


// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 [heads, rows, d] as a 3-D map of boxes 16 x 128 x 1, 32-byte
// swizzle; out of bounds reads as zero.
int encode(CUtensorMap* map, const void* ptr, long long heads, long long rows,
           int d) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)(rows * d * 2)};
  const cuuint32_t box[3] = {CHUNK, BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

constexpr size_t smem_bytes(int dp, int tiles) {
  return (size_t)tiles * (dp / CHUNK) * BOX_BYTES + 8 * (1 + 3 * STAGES) + 1024;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long batch,
           int n_heads, int n_kv_heads, long long sq, long long sk, int d,
           int causal, int has_window, long long window, float scale,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode(&qm, q, batch * n_heads, sq, d);
  if (rc == 0) rc = encode(&km, k, batch * n_kv_heads, sk, d);
  if (rc == 0) rc = encode(&vm, v, batch * n_kv_heads, sk, d);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes(DP, 1 + 2 * STAGES);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers inside the block only: the producer
  // warpgroup must free at least what the consumers take, or their
  // increase waits forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_tc<DP>);
  if (err != cudaSuccess) return (int)err;
  if (128 * (attr.numRegs - PRODUCER_REGS) <
      CONSUMERS * 128 * (CONSUMER_REGS - attr.numRegs))
    return (int)cudaErrorInvalidConfiguration;
  // positions are 32-bit in the kernel: a window past every key is none
  const long long lim = 1LL << 30;
  const int win = (int)(window > lim ? lim : (window < -lim ? -lim : window));
  const dim3 grid((unsigned)(batch * n_heads), (unsigned)((sq + BQ - 1) / BQ));
  flash_fwd_tc<DP><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, n_heads, n_heads / n_kv_heads,
      (int)sq, (int)sk, d, causal, has_window, win, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DP>
int probe(const void* q, const void* k, const void* v, const void* p, void* s_out,
          void* o_out, long long sq, long long sk, int d, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode(&qm, q, 1, sq, d);
  if (rc == 0) rc = encode(&km, k, 1, sk, d);
  if (rc == 0) rc = encode(&vm, v, 1, sk, d);
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
// 2^31 and q, k, v 16-byte aligned. Returns 0 on success, else the
// cudaError_t.
extern "C" int flash_attention_launch(int device, const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      long long batch,
                                      int n_heads, int n_kv_heads,
                                      long long sq, long long sk, int d,
                                      int dtype, int causal, int has_window,
                                      long long window, float scale,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch * n_heads * sq == 0) return 0;
  if (d < 1 || d > 128 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      (sq + simt::BQ - 1) / simt::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attention_uses_tc(dtype, d)) {
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
    TC_DISPATCH(d, tc::launch<DP>(q, k, v, o, lse, batch, n_heads, n_kv_heads, sq, sk,
                                  d, causal, has_window, window, scale, s));
  }
  switch (dtype) {
    case 0:
      return simt::dispatch<float>(q, k, v, o, lse, batch, n_heads, n_kv_heads, sq,
                                   sk, d, causal, has_window, window, scale, s);
    case 1:
      return simt::dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, n_heads,
                                           n_kv_heads, sq, sk, d, causal,
                                           has_window, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
