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
// or false, and true. Only rows in [offsets[0], offsets[n_seg]) are read.
//
// Bound on this card: bytes. Every value row is read once (plus one mask
// byte per row and the n+1 offsets) and every output row written once, at
// 3.35 TB/s; one combine per element is far below the arithmetic peak.
//
// Design, rows of one element (the "rows" route, the message combiner's):
// merge-path over rows and segments (Merrill & Garland, "Merge-based
// Parallel Sparse Matrix-Vector Multiplication", SC 2016), so that a block's
// work does not depend on the degrees: a power-law hub is cut into many
// tiles, and empty segments cost one item each. The items are the rows
// [offsets[0], offsets[n_seg]) and the n_seg segment ends, merged in order;
// tile k is items [k*kTile, (k+1)*kTile). Three launches, one call:
//   1. seg_search: one thread per tile edge finds, by binary search in
//      offsets, how many segments end before it (tile_seg[k]);
//   2. seg_tiles: a block copies its tile's values, mask and segment ends
//      into shared memory with cp.async, 16 bytes at a time, into a layout
//      padded against bank conflicts; each thread finds its kItems-item
//      span by a merge-path search there and folds it in order (without a
//      test per row when all its items are rows of one segment; a masked
//      row is skipped). A segment that ends inside the thread is written
//      at once; the thread's first one waits for the carry of the threads
//      before it, from a segmented inclusive scan over the block (head
//      flags by segment, warp shuffles, then one value per warp). The
//      segment open at the tile's end leaves its partial in carry[k]; the
//      first segment, if an earlier tile holds rows of it, leaves its
//      partial in head[k];
//   3. seg_fixup: one thread per run of tiles that carry the same segment
//      folds their carries in tile order, then the head partial of the tile
//      that ends it, and writes the segment.
// No value goes through an atomic, and the order of combination depends on
// the offsets alone, so a float sum is the same bits from launch to launch.
// Rows wider than one element take the "cols" route (one warp per
// segment, a lane per column), chosen by width alone.

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

// ---- rows route: merge-path tiles ------------------------------------------

constexpr int kThreads = 256;  // per tile
constexpr int kItems = 24;     // merge items per thread
constexpr int kTile = kThreads * kItems;

// Shared memory is staged in 16-byte chunks by cp.async. A staged array of
// `n` elements of B bytes, starting `skew` elements into its first chunk,
// pads 16 bytes after every 8 chunks, so that threads reading elements
// ~kItems apart fall on different banks.
template <int B>
struct Staged {
  static constexpr int V = 16 / B;                               // elements a chunk
  static constexpr int kChunks = (kTile + 1 + 2 * V) / V;         // covers a tile
  static constexpr int kSlots = kChunks + kChunks / 8 + 1;
  static __device__ __forceinline__ int slot(int c) { return c + (c >> 3); }
  // byte offset of element q (counted from the first chunk's start)
  static __device__ __forceinline__ int at(int q) {
    return slot(q / V) * 16 + (q % V) * B;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

// copy elements [0, n) of `src` (B bytes each) into `dst`, 16 bytes at a
// time from the 16-byte block holding src[0]; sets the skew and returns the
// slots used
template <int B>
__device__ __forceinline__ int stage(uint4* dst, const void* src, int n, int tid, int* skew) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  *skew = (int)((p & 15) / B);
  const uint4* from = reinterpret_cast<const uint4*>(p - (p & 15));
  const int chunks = n > 0 ? (*skew + n + Staged<B>::V - 1) / Staged<B>::V : 0;
  for (int c = tid; c < chunks; c += kThreads) cp_async16(dst + Staged<B>::slot(c), from + c);
  return Staged<B>::slot(chunks);
}

// the values' and the segment ends' staging share one buffer: together they
// are at most kTile + 1 elements of at most 4 bytes, plus two skews and pads
constexpr int kBufSlots = Staged<4>::kSlots + 8;

template <typename A> __device__ __forceinline__ uint32_t to_bits(A a);
template <> __device__ __forceinline__ uint32_t to_bits(float a) { return __float_as_uint(a); }
template <> __device__ __forceinline__ uint32_t to_bits(int32_t a) { return (uint32_t)a; }
template <> __device__ __forceinline__ uint32_t to_bits(uint32_t a) { return a; }
template <typename A> __device__ __forceinline__ A from_bits(uint32_t b);
template <> __device__ __forceinline__ float from_bits(uint32_t b) { return __uint_as_float(b); }
template <> __device__ __forceinline__ int32_t from_bits(uint32_t b) { return (int32_t)b; }
template <> __device__ __forceinline__ uint32_t from_bits(uint32_t b) { return b; }

// tile_seg[k] = segments whose end item comes before item k*kTile, for
// k in [0, n_tiles]: the merge-path split of that diagonal
__global__ void seg_search(const int32_t* __restrict__ offsets, int n_seg,
                           int64_t n_tiles, int32_t* __restrict__ tile_seg) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k > n_tiles) return;
  const int64_t r0 = offsets[0];
  const int64_t n_rows = (int64_t)offsets[n_seg] - r0;
  const int64_t total = n_rows + n_seg;
  const int64_t d = k * kTile < total ? k * kTile : total;
  // end item of segment s sits at (offsets[s+1] - r0) + s, increasing in s
  int64_t lo = d - n_rows > 0 ? d - n_rows : 0;
  int64_t hi = d < n_seg ? d : n_seg;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)offsets[mid + 1] - r0 + mid < d) lo = mid + 1;
    else hi = mid;
  }
  tile_seg[k] = (int32_t)lo;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
seg_tiles(const T* __restrict__ values, const uint8_t* __restrict__ mask,
          const int32_t* __restrict__ offsets, T* __restrict__ out, int n_seg,
          const int32_t* __restrict__ tile_seg, int32_t* __restrict__ carry_seg,
          uint32_t* __restrict__ carry, uint32_t* __restrict__ head) {
  using A = typename Io<T>::A;
  using SV = Staged<sizeof(T)>;
  using SM = Staged<1>;
  using SE = Staged<4>;
  __shared__ uint4 sm_buf[kBufSlots];  // values, then segment ends
  __shared__ uint4 sm_mask[SM::kSlots];
  __shared__ int32_t sm_wkey[kThreads / 32], sm_pkey[kThreads / 32];
  __shared__ A sm_wval[kThreads / 32], sm_pval[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t k = blockIdx.x;
  const int r0 = offsets[0];
  const int64_t total = (int64_t)offsets[n_seg] - r0 + n_seg;
  const int64_t d0 = k * kTile;
  if (d0 >= total) {  // a tile past the last item (the grid is sized by E)
    if (tid == 0) carry_seg[k] = -1;
    return;
  }
  const int tile_items = (int)(total - d0 < kTile ? total - d0 : kTile);
  const int s0 = tile_seg[k], s1 = tile_seg[k + 1];
  const int n_ends = s1 - s0;
  const int rb = r0 + (int)(d0 - s0);  // first row of the tile
  const int n_rows = tile_items - n_ends;
  const A ident = Comb<OP>::id(A());

  // the tile's values, mask and segment ends (offsets[s0 + 1 + i], the last
  // one the open segment's end where there is one) land in shared memory
  // straight from the 16-byte blocks that hold them
  int vskew, mskew = 0, eskew;
  const int ebase = stage<sizeof(T)>(sm_buf, values + rb, n_rows, tid, &vskew) + 1;
  if (mask != nullptr) stage<1>(sm_mask, mask + rb, n_rows, tid, &mskew);
  const int n_known = n_ends + (s1 < n_seg ? 1 : 0);
  stage<4>(sm_buf + ebase, offsets + s0 + 1, n_known, tid, &eskew);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const char* vals_b = reinterpret_cast<const char*>(sm_buf);
  const char* mask_b = reinterpret_cast<const char*>(sm_mask);
  const char* ends_b = reinterpret_cast<const char*>(sm_buf + ebase);
  auto end_of = [&](int i) {  // the end of local segment i (none past the last)
    return i < n_known ? *reinterpret_cast<const int32_t*>(ends_b + SE::at(eskew + i))
                       : INT32_MAX;
  };

  // this thread's span: the merge-path split of its first item
  const int dt = tid * kItems < tile_items ? tid * kItems : tile_items;
  int lo = dt - n_rows > 0 ? dt - n_rows : 0;
  int hi = dt < n_ends ? dt : n_ends;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (end_of(mid) - rb + mid < dt) lo = mid + 1;
    else hi = mid;
  }
  const int x_start = lo;
  int x = lo, y = dt - lo;
  int end_x = end_of(x) - rb;  // local row where segment s0 + x ends
  A acc = ident, first = ident;
  bool has_first = false;
  // the staged addresses of row y, stepped one row at a time across the pads
  int q = vskew + y, av = SV::at(q);
  int p = mskew + y, am = SM::at(p);
  auto fold_row = [&]() {
    const A v = Io<T>::load(*reinterpret_cast<const T*>(vals_b + av));
    if (mask == nullptr || mask_b[am]) acc = Comb<OP>::f(acc, v);
    ++q;
    ++p;
    av += (int)sizeof(T) + (q % (8 * SV::V) == 0 ? 16 : 0);
    am += 1 + (p % (8 * SM::V) == 0 ? 16 : 0);
  };
  if (dt + kItems <= tile_items && y + kItems <= end_x && y + kItems <= n_rows) {
    // all kItems items are rows of segment s0 + x (most threads, on a
    // power-law graph): no test per row
#pragma unroll
    for (int it = 0; it < kItems; ++it) fold_row();
    y += kItems;
  } else {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (dt + it < tile_items) {
        if (y < end_x && y < n_rows) {  // a row of segment s0 + x
          fold_row();
          ++y;
        } else {  // the end of segment s0 + x
          if (has_first) out[s0 + x] = Io<T>::store(acc);
          else first = acc;
          has_first = true;
          acc = ident;
          ++x;
          end_x = end_of(x) - rb;
        }
      }
    }
  }

  // segmented inclusive scan of (x, acc) over the block: keys ascend, so
  // lanes with one key are contiguous
  A run = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xk = __shfl_up_sync(0xffffffffu, x, o);
    const A v = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o && xk == x) run = Comb<OP>::f(v, run);
  }
  if (lane == 31) {
    sm_wkey[warp] = x;
    sm_wval[warp] = run;
  }
  __syncthreads();
  if (tid == 0) {  // each warp's prefix: the scan of the warps before it
    int pk = -1;
    A pv = ident;
    for (int w = 0; w < kThreads / 32; ++w) {
      sm_pkey[w] = pk;
      sm_pval[w] = pv;
      pv = sm_wkey[w] == pk ? Comb<OP>::f(pv, sm_wval[w]) : sm_wval[w];
      pk = sm_wkey[w];
    }
  }
  __syncthreads();
  if (x == sm_pkey[warp]) run = Comb<OP>::f(sm_pval[warp], run);
  // the scan up to the thread before: its key is this thread's x_start
  A before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = sm_pval[warp];
  if (has_first) {
    const A v = tid > 0 ? Comb<OP>::f(before, first) : first;
    if (x_start == 0 && rb > offsets[s0]) head[k] = to_bits(v);
    else out[s0 + x_start] = Io<T>::store(v);
  }
  if (tid == kThreads - 1) {  // x == n_ends: the segment open at the end
    const int open_start = n_ends > 0 ? end_of(n_ends - 1) : offsets[s0];
    const bool carries = s1 < n_seg && rb + n_rows > open_start;
    carry_seg[k] = carries ? s1 : -1;
    carry[k] = to_bits(run);
  }
}

// one thread per tile; the first tile of a run that carries segment s folds
// the run's carries in tile order, then the head partial of the tile that
// ends s, and writes s
template <typename T, int OP>
__global__ void seg_fixup(const int32_t* __restrict__ carry_seg,
                          const uint32_t* __restrict__ carry,
                          const uint32_t* __restrict__ head, T* __restrict__ out,
                          int64_t n_tiles) {
  using A = typename Io<T>::A;
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_tiles) return;
  const int s = carry_seg[k];
  if (s < 0 || (k > 0 && carry_seg[k - 1] == s)) return;
  A acc = from_bits<A>(carry[k]);
  int64_t m = k + 1;
  for (bool open = true; open; m += 8) {  // 8 tiles' loads in flight
    int32_t ks[8];
    uint32_t vs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ks[i] = m + i < n_tiles ? carry_seg[m + i] : -1;
      vs[i] = m + i < n_tiles ? carry[m + i] : 0u;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (open && ks[i] == s) {
        acc = Comb<OP>::f(acc, from_bits<A>(vs[i]));
      } else if (open) {  // tile m + i ends s
        if (m + i < n_tiles) acc = Comb<OP>::f(acc, from_bits<A>(head[m + i]));
        open = false;
      }
    }
  }
  out[s] = Io<T>::store(acc);
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

// The scratch of the rows route, 4 * n_tiles + 1 words: tile_seg
// [n_tiles + 1], carry_seg, carry and head [n_tiles] each. n_tiles covers
// every item the offsets can name: (max_rows + n_seg) / kTile, rounded up.
struct Scratch {
  int32_t* tile_seg;
  int32_t* carry_seg;
  uint32_t* carry;
  uint32_t* head;
  Scratch(void* p, int64_t n_tiles) {
    tile_seg = static_cast<int32_t*>(p);
    carry_seg = tile_seg + n_tiles + 1;
    carry = reinterpret_cast<uint32_t*>(carry_seg + n_tiles);
    head = carry + n_tiles;
  }
};

template <typename T, int OP>
int launch(const void* values, const uint8_t* mask, const int32_t* offsets,
           void* out, int n_seg, int64_t width, void* scratch, int64_t n_tiles,
           cudaStream_t stream) {
  if (width == 1) {
    Scratch sc(scratch, n_tiles);
    seg_search<<<(unsigned)((n_tiles + 1 + 255) / 256), 256, 0, stream>>>(
        offsets, n_seg, n_tiles, sc.tile_seg);
    seg_tiles<T, OP><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
        static_cast<const T*>(values), mask, offsets, static_cast<T*>(out), n_seg,
        sc.tile_seg, sc.carry_seg, sc.carry, sc.head);
    seg_fixup<T, OP><<<(unsigned)((n_tiles + 255) / 256), 256, 0, stream>>>(
        sc.carry_seg, sc.carry, sc.head, static_cast<T*>(out), n_tiles);
  } else {
    const int threads = 256;  // 8 segments per block
    const int64_t blocks = ((int64_t)n_seg * 32 + threads - 1) / threads;
    segment_reduce_cols<T, OP><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(values), mask, offsets, static_cast<T*>(out),
        n_seg, width);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int by_op_numeric(int op, const void* v, const uint8_t* m, const int32_t* o,
                  void* out, int n, int64_t w, void* sc, int64_t nt, cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch<T, OP_SUM>(v, m, o, out, n, w, sc, nt, s);
    case OP_PROD: return launch<T, OP_PROD>(v, m, o, out, n, w, sc, nt, s);
    case OP_MIN: return launch<T, OP_MIN>(v, m, o, out, n, w, sc, nt, s);
    case OP_MAX: return launch<T, OP_MAX>(v, m, o, out, n, w, sc, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int by_op_bool(int op, const void* v, const uint8_t* m, const int32_t* o,
               void* out, int n, int64_t w, void* sc, int64_t nt, cudaStream_t s) {
  switch (op) {
    case OP_MIN: return launch<uint8_t, OP_MIN>(v, m, o, out, n, w, sc, nt, s);
    case OP_MAX: return launch<uint8_t, OP_MAX>(v, m, o, out, n, w, sc, nt, s);
    case OP_OR: return launch<uint8_t, OP_OR>(v, m, o, out, n, w, sc, nt, s);
    case OP_AND: return launch<uint8_t, OP_AND>(v, m, o, out, n, w, sc, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Items of one tile of the rows route (the wrapper sizes the scratch by it).
extern "C" int segment_reduce_tile_items() { return kTile; }

// values [rows, width] (only rows in [offsets[0], offsets[n_seg]) are
// read), mask [rows] of bytes or NULL, offsets [n_seg + 1] int32 ascending,
// out [n_seg, width]; for width 1, scratch of 4 * n_tiles + 1 words with
// n_tiles = ceil((rows + n_seg) / segment_reduce_tile_items()) (unused
// otherwise). Returns 0 on success, else the cudaError_t of the launch.
extern "C" int segment_reduce_launch(int device, const void* values,
                                     const uint8_t* mask,
                                     const int32_t* offsets, void* out,
                                     int n_seg, long long width, int dtype,
                                     int op, void* scratch, long long n_tiles,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_seg == 0 || width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return by_op_numeric<float>(op, values, mask, offsets, out, n_seg, width,
                                  scratch, n_tiles, s);
    case DT_BF16:
      return by_op_numeric<__nv_bfloat16>(op, values, mask, offsets, out, n_seg,
                                          width, scratch, n_tiles, s);
    case DT_I32:
      return by_op_numeric<int32_t>(op, values, mask, offsets, out, n_seg, width,
                                    scratch, n_tiles, s);
    case DT_BOOL:
      return by_op_bool(op, values, mask, offsets, out, n_seg, width, scratch,
                        n_tiles, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
