// The flash kernels' positions route (csrc/flash_attention.cu and
// csrc/flash_attention_bwd.cu): the keep rule of the JAX package's
// attention_chunked (_mask_bias with its kv_mask), from int32 positions;
// the tile bounds that decide which tiles a kernel visits; and the launch
// that writes them.
//
// Tiles are decided from bounds, never from every pair: a first launch
// (tile_bounds) writes, per batch row, the min and max kept key position of
// every 64-key tile (and whether all its keys are kept) and the min and max
// query position of every 64-row block. A key tile is dead for a query
// block (tile_kind) iff it keeps no key, or under causal its lowest key
// lies above the block's highest query, or under a window the block's
// lowest query lies a window or more past the tile's highest key: no pair
// of a dead tile is kept, so a kernel skips it. A tile is interior iff
// every key of it is kept and below Sk and every query of the block keeps
// every one of them; a kernel runs it mask-free. Larger tiles (the tensor
// cores' 128 keys, 128 query rows) take the union of their 64-wide bounds.
// With positions 0..S-1 and no mask the rule gives the index route's tile
// ranges.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

constexpr float NEG_INF = -1e30f;  // the JAX package's finite mask value
constexpr int MASKED = INT_MIN;    // the position of a key that kv_mask removes

// The position of key j of batch row b, MASKED where kv_mask removes it.
__device__ __forceinline__ int key_position(const int* k_pos, const uint8_t* kv_mask,
                                            long long b, long long sk, long long j) {
  return kv_mask[b * sk + j] ? k_pos[b * sk + j] : MASKED;
}

// Whether query position qp keeps key position kp: the key is not masked,
// qp >= kp under causal, qp - kp < window under a window (positions within
// +-2^30, as JAX's int32 difference needs).
__device__ __forceinline__ bool keeps(int qp, int kp, int causal, int has_window,
                                      long long window) {
  bool keep = kp != MASKED;
  if (causal) keep = keep && qp >= kp;
  if (has_window) keep = keep && (long long)qp - kp < window;
  return keep;
}

constexpr int BND = 64;  // keys of a bound tile, query rows of a bound block
constexpr int TILE_DEAD = 0, TILE_EDGE = 1, TILE_INTERIOR = 2;

// Bound tiles of a batch row: ceil(S / 128) * 2, so that every 128-wide
// tile is the union of two of them.
__host__ __device__ __forceinline__ long long bound_tiles(long long s) {
  return (s + 2 * BND - 1) / (2 * BND) * 2;
}

// The positions route's int32 scratch, in elements: key bounds kb [B,
// bound_tiles(Sk), 3] (lo, hi, full), query bounds qb [B, bound_tiles(Sq),
// 2] (lo, hi), then (with_keys, the tensor-core forward) the folded key
// positions [B, bound_tiles(Sk) * 64], or (with_queries, the tensor-core
// backward) the query positions padded with 0 [B, bound_tiles(Sq) * 64]:
// whole 64-row blocks that a bulk copy may read, from a 128-byte boundary
// (bounds_head elements in).
__host__ __device__ __forceinline__ long long bounds_head(long long batch, long long sq,
                                                          long long sk) {
  return (batch * (3 * bound_tiles(sk) + 2 * bound_tiles(sq)) + 31) / 32 * 32;
}
__host__ __device__ __forceinline__ long long bounds_ints(long long batch, long long sq,
                                                          long long sk, bool with_keys,
                                                          bool with_queries = false) {
  return bounds_head(batch, sq, sk) + batch * ((with_keys ? bound_tiles(sk) * BND : 0) +
                                               (with_queries ? bound_tiles(sq) * BND : 0));
}

// The SIMT route keeps no walk list: its kernels count the tiles they
// visit instead, into the last VISITED_INTS ints of the scratch (the
// forward's blocks into [0]; the backward's dK/dV blocks into [0], its dQ
// blocks into [1]), which the launch zeroes first. A tile is one block's
// 64 x 64 tile, so a count is the heads times the live tiles of the walk.
constexpr int VISITED_INTS = 2;

struct Bounds {
  int lo, hi, full;  // lo > hi: empty
};

// Key tiles [t0, t1) of batch row b, as one tile.
__device__ __forceinline__ Bounds key_bounds(const int* kb, long long b, long long nk,
                                             long long t0, long long t1) {
  Bounds u = {INT_MAX, INT_MIN, 1};
  for (long long t = t0; t < t1; ++t) {
    const int* e = kb + (b * nk + t) * 3;
    u.lo = min(u.lo, __ldg(e));
    u.hi = max(u.hi, __ldg(e + 1));
    u.full = u.full & __ldg(e + 2);
  }
  return u;
}

// Query block t of batch row b.
__device__ __forceinline__ Bounds query_bounds(const int* qb, long long b, long long nq,
                                               long long t) {
  const int* e = qb + (b * nq + t) * 2;
  return {__ldg(e), __ldg(e + 1), 0};
}

// TILE_DEAD, TILE_EDGE or TILE_INTERIOR: the key tile k for the query block q.
__host__ __device__ __forceinline__ int tile_kind(Bounds q, Bounds k, int causal,
                                                  int has_window, long long window) {
  if (k.lo > k.hi || q.lo > q.hi) return TILE_DEAD;
  if (causal && k.lo > q.hi) return TILE_DEAD;
  if (has_window && (long long)q.lo - k.hi >= window) return TILE_DEAD;
  const bool inner = k.full && (!causal || k.hi <= q.lo) &&
                     (!has_window || (long long)q.hi - k.lo < window);
  return inner ? TILE_INTERIOR : TILE_EDGE;
}

// One warp a tile: warps [0, B * nk) the key tiles, then B * nq query
// blocks. With `keys`, the key warps also write the key positions folded
// with the mask (MASKED past Sk too), 64 a tile; with `queries`, the query
// warps the query positions (0 past Sq).
__global__ void __launch_bounds__(256)
    tile_bounds(const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                const uint8_t* __restrict__ kv_mask, int* __restrict__ kb,
                int* __restrict__ qb, int* __restrict__ keys, int* __restrict__ queries,
                long long batch, long long sq, long long sk, long long nk, long long nq) {
  const long long w = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= batch * (nk + nq)) return;
  int lo = INT_MAX, hi = INT_MIN;
  bool all = true;
  if (w < batch * nk) {
    const long long b = w / nk, t = w - b * nk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long j = t * BND + h * 32 + lane;
      const int kp = j < sk ? key_position(k_pos, kv_mask, b, sk, j) : MASKED;
      if (keys != nullptr) keys[b * nk * BND + j] = kp;
      if (kp != MASKED) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
      all = all && kp != MASKED;
    }
  } else {
    const long long i = w - batch * nk, b = i / nq, t = i - b * nq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = t * BND + h * 32 + lane;
      const int qp = r < sq ? q_pos[b * sq + r] : 0;
      if (queries != nullptr) queries[b * nq * BND + r] = qp;
      if (r < sq) {
        lo = min(lo, qp);
        hi = max(hi, qp);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  all = __all_sync(0xffffffffu, all);
  if (lane == 0) {
    if (w < batch * nk) {
      kb[w * 3] = lo;
      kb[w * 3 + 1] = hi;
      kb[w * 3 + 2] = all;
    } else {
      const long long i = w - batch * nk;
      qb[i * 2] = lo;
      qb[i * 2 + 1] = hi;
    }
  }
}

// The tensor cores' walks, written from the bounds by a launch after
// tile_bounds so that a kernel reads its next tile with one independent
// load instead of evaluating the rule in its critical path. An entry packs
// a tile index (< 2^24) with two kinds: t | kind_0 << 24 | kind_1 << 26.
//   fwd_walk [B][ceil(Sq/128)][1 + ceil(Sk/128)]: per 128-row query tile,
//     its count, then its live 128-key tiles ascending, kind_h that of the
//     tile for the query tile's 64-row half h (live: either not dead).
//   bwd_walk [B][ceil(Sk/128)][1 + 2 ceil(Sq/64)]: per 128-key tile, its
//     count, then its live 64-row query tiles ascending as pairs (entry,
//     rank), kind_h that of the tile's 64-key half h for the query tile,
//     rank the number of live key tiles below this one for the query tile
//     (the dQ adds that come first).
constexpr int WALK_TILE = 2 * BND;
constexpr int WALK_SHIFT = 24;
__host__ __device__ __forceinline__ long long walk_tiles(long long s) {
  return (s + WALK_TILE - 1) / WALK_TILE;
}
__host__ __device__ __forceinline__ long long fwd_walk_ints(long long batch, long long sq,
                                                            long long sk) {
  return batch * walk_tiles(sq) * (1 + walk_tiles(sk));
}
__host__ __device__ __forceinline__ long long bwd_walk_ints(long long batch, long long sq,
                                                            long long sk) {
  return batch * walk_tiles(sk) * (1 + 2 * ((sq + BND - 1) / BND));
}
__host__ __device__ __forceinline__ int walk_entry(int t, int kind0, int kind1) {
  return t | kind0 << WALK_SHIFT | kind1 << (WALK_SHIFT + 2);
}
__host__ __device__ __forceinline__ int walk_tile(int e) { return e & ((1 << WALK_SHIFT) - 1); }
__host__ __device__ __forceinline__ int walk_kind(int e, int h) {
  return (e >> (WALK_SHIFT + 2 * h)) & 3;
}

// One warp a (batch row, 128-row query tile): its live key tiles, 32 at a
// time, compacted by ballot in ascending order.
__global__ void __launch_bounds__(256)
    fwd_walk(const int* __restrict__ kb, const int* __restrict__ qb, int* __restrict__ walk,
             long long batch, long long sq, long long sk, int causal, int has_window,
             long long window) {
  const long long n_qt = walk_tiles(sq), n_kt = walk_tiles(sk);
  const long long nk = bound_tiles(sk), nq = bound_tiles(sq);
  const long long w = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= batch * n_qt) return;
  const long long b = w / n_qt, qt = w - b * n_qt;
  const Bounds q0 = query_bounds(qb, b, nq, 2 * qt), q1 = query_bounds(qb, b, nq, 2 * qt + 1);
  int* out = walk + w * (1 + n_kt);
  int count = 0;
  for (long long base = 0; base < n_kt; base += 32) {
    const long long kt = base + lane;
    int e = 0;
    bool live = false;
    if (kt < n_kt) {
      const Bounds k = key_bounds(kb, b, nk, 2 * kt, 2 * kt + 2);
      const int k0 = tile_kind(q0, k, causal, has_window, window);
      const int k1 = tile_kind(q1, k, causal, has_window, window);
      live = k0 != TILE_DEAD || k1 != TILE_DEAD;
      e = walk_entry((int)kt, k0, k1);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) out[1 + count + __popc(ballot & ((1u << lane) - 1))] = e;
    count += __popc(ballot);
  }
  if (lane == 0) out[0] = count;
}

// One warp a (batch row, 128-key tile): its live 64-row query tiles with
// their kinds and ranks.
__global__ void __launch_bounds__(256)
    bwd_walk(const int* __restrict__ kb, const int* __restrict__ qb, int* __restrict__ walk,
             long long batch, long long sq, long long sk, int causal, int has_window,
             long long window) {
  const long long n_kt = walk_tiles(sk), n_qt = (sq + BND - 1) / BND;
  const long long nk = bound_tiles(sk), nq = bound_tiles(sq);
  const long long w = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= batch * n_kt) return;
  const long long b = w / n_kt, kt = w - b * n_kt;
  const Bounds k = key_bounds(kb, b, nk, 2 * kt, 2 * kt + 2);
  const Bounds h0 = key_bounds(kb, b, nk, 2 * kt, 2 * kt + 1);
  const Bounds h1 = key_bounds(kb, b, nk, 2 * kt + 1, 2 * kt + 2);
  int* out = walk + w * (1 + 2 * n_qt);
  int count = 0;
  for (long long base = 0; base < n_qt; base += 32) {
    const long long qt = base + lane;
    int e = 0, rank = 0;
    bool live = false;
    if (qt < n_qt) {
      const Bounds q = query_bounds(qb, b, nq, qt);
      live = tile_kind(q, k, causal, has_window, window) != TILE_DEAD;
      e = walk_entry((int)qt, tile_kind(q, h0, causal, has_window, window),
                     tile_kind(q, h1, causal, has_window, window));
      if (live)
        for (long long j = 0; j < kt; ++j)
          rank += tile_kind(q, key_bounds(kb, b, nk, 2 * j, 2 * j + 2), causal, has_window,
                            window) != TILE_DEAD;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int at = count + __popc(ballot & ((1u << lane) - 1));
      out[1 + 2 * at] = e;
      out[2 + 2 * at] = rank;
    }
    count += __popc(ballot);
  }
  if (lane == 0) out[0] = count;
}

// Launches tile_bounds over the scratch laid out as bounds_ints says.
inline cudaError_t launch_tile_bounds(const int* q_pos, const int* k_pos,
                                      const uint8_t* kv_mask, int* scratch, bool with_keys,
                                      bool with_queries, long long batch, long long sq,
                                      long long sk, cudaStream_t stream) {
  const long long nk = bound_tiles(sk), nq = bound_tiles(sq);
  int* kb = scratch;
  int* qb = kb + batch * nk * 3;
  int* keys = with_keys ? scratch + bounds_head(batch, sq, sk) : nullptr;
  int* queries = with_queries ? scratch + bounds_head(batch, sq, sk) : nullptr;
  const long long warps = batch * (nk + nq);
  if (warps == 0) return cudaSuccess;
  tile_bounds<<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      q_pos, k_pos, kv_mask, kb, qb, keys, queries, batch, sq, sk, nk, nq);
  return cudaGetLastError();
}

// Launches fwd_walk (bwd = false) or bwd_walk into `walk` from the bounds
// at the head of `scratch`.
inline cudaError_t launch_walk(const int* scratch, int* walk, bool bwd, long long batch,
                               long long sq, long long sk, int causal, int has_window,
                               long long window, cudaStream_t stream) {
  const int* kb = scratch;
  const int* qb = kb + batch * bound_tiles(sk) * 3;
  const long long warps = batch * (bwd ? walk_tiles(sk) : walk_tiles(sq));
  if (warps == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((warps + 7) / 8);
  if (bwd)
    bwd_walk<<<grid, 256, 0, stream>>>(kb, qb, walk, batch, sq, sk, causal, has_window,
                                       window);
  else
    fwd_walk<<<grid, 256, 0, stream>>>(kb, qb, walk, batch, sq, sk, causal, has_window,
                                       window);
  return cudaGetLastError();
}
