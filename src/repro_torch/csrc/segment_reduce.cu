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
// What keeps a kernel from it is the degree skew of power-law graphs: a
// design that gives a segment to one thread or warp is as slow as its hub.
//
// Both routes cut the work the same way, so that a block's work does not
// depend on the degrees: merge-path over rows and segments (Merrill &
// Garland, "Merge-based Parallel Sparse Matrix-Vector Multiplication", SC
// 2016). The items are the rows [offsets[0], offsets[n_seg]) and the n_seg
// segment ends, merged in order; a tile is a run of items. A power-law hub
// is cut into many tiles, and an empty segment costs one item. No value
// goes through an atomic, and the order of combination depends on the
// offsets alone, so a float sum is the same bits from launch to launch.
//
// Rows of one element (the "rows" route, the message combiner's), tiles of
// kTile items. Three launches, one call:
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
//
// Rows of W > 1 elements (the "cols" route, the GNN layers': W = 8 to 512),
// chosen by width alone. The GNN graphs' hubs (93,838 rows at SAGE's
// shape) and their rows of 32 to 1,024 bytes, not always a multiple of 16
// (PNA's 75 bf16), are what bound it. The same three launches, at tiles of
// kColsChunks chunks, a chunk being as many items as kColsChunkBytes of
// rows hold (cols_geom: SAGE's 400-byte rows 80 items, GAT's 32-byte ones
// 1,024, GraphCast's 1,024-byte bf16 ones 32):
//   1. seg_search at every chunk edge;
//   2. cols_tiles: a block walks its tile chunk by chunk. Sorted by segment,
//      a chunk's rows are one contiguous span of bytes whatever W, so the
//      block stages it with 16-byte cp.async from the 16-byte block holding
//      its first byte (rows of more than kColsSlice elements: a slice of
//      columns a block, each row's piece staged apart), with the chunk's
//      mask bytes and segment ends. Threads lie over rows x columns: `lanes`
//      threads across the columns (a power of two up to 32; `cpt` columns
//      each, lanes apart, so a warp reads one row's neighbouring elements),
//      `groups` = 256 / lanes groups each over a contiguous merge-path span
//      of the chunk's items; at W = 8, 32 groups of 8 lanes, so no lane is
//      idle. A group folds its span in order, writes a segment that starts
//      and ends in it, and leaves its first (a segment begun before it) and
//      last (the one open at its end) partials in shared memory. One thread
//      a column then folds the groups' partials in order onto the partial
//      carried from the chunk before, writing each segment that ends; the
//      first segment of the tile, if an earlier tile holds rows of it, goes
//      to head[k] instead, and the partial open at the tile's end to
//      carry[k] (W wide: f32 for f32/bf16, else the accumulator type);
//   3. cols_fixup: one thread per tile and column; the first tile of a run
//      that carries segment s folds the run's carries in tile order, eight
//      tiles' loads in flight, then the head of the tile that ends s. A hub
//      of 93,838 rows of 100 f32 is about 150 tiles of 640 items.
// Tiles of eight chunks keep the W-wide carries and heads small (SAGE's
// [E, 100] f32: about 0.1 GB beside 24.8 GB of values). Measured at the GNN
// shapes on the H100 (PERF.md): chunks of 16 KB were 20 % slower on SAGE's
// sum, of 64 KB 1.6x slower on GAT's width-8 max; 4 or 16 chunks a tile
// within 2 % on the large shapes. At GraphCast's 10,552 rows the route is
// 57 tiles of eight chunks in turn: about 30 us of device time.

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

// tile_seg[k] = segments whose end item comes before item k*tile, for
// k in [0, n_tiles]: the merge-path split of that diagonal
__global__ void seg_search(const int32_t* __restrict__ offsets, int n_seg,
                           int64_t n_tiles, int32_t* __restrict__ tile_seg,
                           int64_t tile) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k > n_tiles) return;
  const int64_t r0 = offsets[0];
  const int64_t n_rows = (int64_t)offsets[n_seg] - r0;
  const int64_t total = n_rows + n_seg;
  const int64_t d = k * tile < total ? k * tile : total;
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

// ---- cols route: merge-path tiles over rows of W elements ------------------

constexpr int kColsSlice = 512;         // columns a block folds; wider rows take slices
constexpr int kColsChunkBytes = 32768;  // row bytes a chunk stages
constexpr int kColsMaxChunkItems = 2048;
constexpr int kColsChunks = 8;          // chunks a tile

// A block's layout of rows of `width` elements of `elem` bytes, and its
// dynamic shared memory (byte offsets). The accumulator of every type is
// 4 bytes (f32, int32 or the bool's uint32).
struct ColsGeom {
  int lanes;        // threads across the columns: a power of two <= 32
  int cpt;          // columns a thread: lanes * cpt >= slice
  int groups;       // row groups, kThreads / lanes
  int chunk_items;  // merge items a chunk, a multiple of groups
  int slice;        // columns a block (the last slice may hold fewer)
  int n_slices;
  int rstride;      // staged bytes a row: width * elem, or a slice's + 16
  int off_mask, off_ends, off_first, off_last, off_run, off_key, off_cseg, smem;
};

inline int round16(long long b) { return (int)((b + 15) & ~15LL); }

ColsGeom cols_geom(long long width, int elem) {
  ColsGeom g;
  g.slice = (int)(width < kColsSlice ? width : kColsSlice);
  g.n_slices = (int)((width + g.slice - 1) / g.slice);
  g.lanes = 32;
  g.cpt = g.slice <= 32 ? 1 : (g.slice <= 128 ? 4 : 16);
  if (g.slice <= 32)
    for (g.lanes = 1; g.lanes < g.slice;) g.lanes <<= 1;
  g.groups = kThreads / g.lanes;
  g.rstride = g.n_slices == 1 ? (int)width * elem : g.slice * elem + 16;
  int items = kColsChunkBytes / g.rstride;
  if (items > kColsMaxChunkItems) items = kColsMaxChunkItems;
  items -= items % g.groups;
  g.chunk_items = items > g.groups ? items : g.groups;
  int off = round16((long long)g.chunk_items * g.rstride + 32);  // values
  g.off_mask = off;
  off += round16(g.chunk_items + 32);
  g.off_ends = off;
  off += round16((g.chunk_items + 1) * 4 + 32);
  g.off_first = off;
  off += g.groups * g.slice * 4;
  g.off_last = off;
  off += g.groups * g.slice * 4;
  g.off_run = off;
  off += round16(g.slice * 4);
  g.off_key = off;
  off += round16(g.groups * 4);
  g.off_cseg = off;
  off += round16((kColsChunks + 1) * 4);
  g.smem = off;
  return g;
}

// cp.async the `len` bytes at `src` into `dst`, 16 at a time from the
// 16-byte block holding src[0] (threads `first`, `first + step`, ...);
// returns the skew of src[0] in dst
__device__ __forceinline__ int stage_bytes(unsigned char* dst, const void* src, int64_t len,
                                           int first, int step) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const int skew = (int)(p & 15);
  const uint4* from = reinterpret_cast<const uint4*>(p - skew);
  const int64_t n16 = len > 0 ? (skew + len + 15) >> 4 : 0;
  for (int64_t c = first; c < n16; c += step) cp_async16(dst + 16 * c, from + c);
  return skew;
}

// One block per (tile k, column slice): see the notes at the top.
template <typename T, int OP, int CPT>
__global__ void __launch_bounds__(kThreads)
cols_tiles(const T* __restrict__ values, const uint8_t* __restrict__ mask,
           const int32_t* __restrict__ offsets, T* __restrict__ out, int n_seg,
           int64_t width, ColsGeom g, const int32_t* __restrict__ chunk_seg,
           int32_t* __restrict__ carry_seg, uint32_t* __restrict__ carry,
           uint32_t* __restrict__ head) {
  using A = typename Io<T>::A;
  constexpr int B = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_vals = smem;
  unsigned char* s_mask = smem + g.off_mask;
  unsigned char* s_ends = smem + g.off_ends;
  A* s_first = reinterpret_cast<A*>(smem + g.off_first);  // [groups][slice]
  A* s_last = reinterpret_cast<A*>(smem + g.off_last);    // [groups][slice]
  A* s_run = reinterpret_cast<A*>(smem + g.off_run);      // [slice]
  int32_t* s_key = reinterpret_cast<int32_t*>(smem + g.off_key);
  int32_t* s_cseg = reinterpret_cast<int32_t*>(smem + g.off_cseg);

  const int tid = threadIdx.x;
  const int lane = tid & (g.lanes - 1), grp = tid / g.lanes;
  const int64_t k = blockIdx.x;
  const int64_t c0 = (int64_t)blockIdx.y * g.slice;
  const int cw = (int)(width - c0 < g.slice ? width - c0 : g.slice);
  const int64_t r0 = offsets[0];
  const int64_t total = (int64_t)offsets[n_seg] - r0 + n_seg;
  const int64_t tile = (int64_t)g.chunk_items * kColsChunks;
  const int64_t d0 = k * tile;
  if (d0 >= total) {  // a tile past the last item (the grid is sized by E)
    if (tid == 0 && blockIdx.y == 0) carry_seg[k] = -1;
    return;
  }
  const int64_t d1 = total - d0 < tile ? total : d0 + tile;
  if (tid <= kColsChunks) s_cseg[tid] = chunk_seg[k * kColsChunks + tid];
  const A ident = Comb<OP>::id(A());
  for (int c = tid; c < cw; c += kThreads) s_run[c] = ident;
  __syncthreads();
  const int s0 = s_cseg[0], s1 = s_cseg[kColsChunks];
  bool head_open = r0 + (d0 - s0) > offsets[s0];  // s0 has rows in an earlier tile
  const bool rowwise = g.n_slices > 1;
  const int64_t wb = width * B;  // bytes a row
  const int ipr = g.chunk_items / g.groups;

  for (int j = 0; j < kColsChunks && d0 + (int64_t)j * g.chunk_items < d1; ++j) {
    const int64_t dc = d0 + (int64_t)j * g.chunk_items;
    const int items = (int)(d1 - dc < g.chunk_items ? d1 - dc : g.chunk_items);
    const int cs0 = s_cseg[j], n_ends = s_cseg[j + 1] - cs0;
    const int64_t crb = r0 + (dc - cs0);  // the chunk's first row
    const int n_rows = items - n_ends;
    const int n_known = n_ends + (cs0 + n_ends < n_seg ? 1 : 0);  // + the open segment's end

    // the chunk's rows (slice), mask bytes and segment ends into shared memory
    const unsigned char* v0 = reinterpret_cast<const unsigned char*>(values) + (crb * width + c0) * B;
    int vskew = 0;
    if (!rowwise) {
      vskew = stage_bytes(s_vals, v0, n_rows * wb, tid, kThreads);
    } else {
      const int bpr = g.rstride / 16;
      for (int t = tid; t < n_rows * bpr; t += kThreads) {
        const int y = t / bpr, b = t - y * bpr;
        const uintptr_t p = reinterpret_cast<uintptr_t>(v0 + y * wb);
        const int sk = (int)(p & 15);
        if (16 * b < sk + cw * B)
          cp_async16(s_vals + y * g.rstride + 16 * b, reinterpret_cast<const uint4*>(p - sk) + b);
      }
    }
    const int mskew = mask != nullptr ? stage_bytes(s_mask, mask + crb, n_rows, tid, kThreads) : 0;
    const int eskew = stage_bytes(s_ends, offsets + cs0 + 1, 4 * (int64_t)n_known, tid, kThreads);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    auto end_of = [&](int i) {  // the local row where segment cs0 + i ends
      return i < n_known
                 ? (int)(*reinterpret_cast<const int32_t*>(s_ends + eskew + 4 * i) - crb)
                 : INT32_MAX;
    };
    auto row_at = [&](int y) {  // row y of the chunk in shared memory
      return s_vals + (rowwise ? y * g.rstride + (int)((reinterpret_cast<uintptr_t>(v0) + y * wb) & 15)
                               : vskew + y * (int)wb);
    };

    // this group's span: the merge-path split of its first item
    const int dt = grp * ipr < items ? grp * ipr : items;
    const int dt1 = dt + ipr < items ? dt + ipr : items;
    int lo = dt - n_rows > 0 ? dt - n_rows : 0;
    int hi = dt < n_ends ? dt : n_ends;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (end_of(mid) + mid < dt) lo = mid + 1;
      else hi = mid;
    }
    const int x_start = lo;
    int x = lo, y = dt - lo, end_x = end_of(x);
    A acc[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[q] = ident;
    bool has_first = false;
    for (int d = dt; d < dt1; ++d) {
      if (y < end_x && y < n_rows) {  // a row of segment cs0 + x
        if (mask == nullptr || s_mask[mskew + y]) {
          const unsigned char* row = row_at(y);
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const int c = lane + q * g.lanes;
            if (c < cw) acc[q] = Comb<OP>::f(acc[q], Io<T>::load(*reinterpret_cast<const T*>(row + c * B)));
          }
        }
        ++y;
      } else {  // the end of segment cs0 + x
        if (has_first) {
          T* o = out + (int64_t)(cs0 + x) * width + c0;
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const int c = lane + q * g.lanes;
            if (c < cw) o[c] = Io<T>::store(acc[q]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const int c = lane + q * g.lanes;
            if (c < cw) s_first[grp * g.slice + c] = acc[q];
          }
          has_first = true;
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[q] = ident;
        ++x;
        end_x = end_of(x);
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int c = lane + q * g.lanes;
      if (c < cw) s_last[grp * g.slice + c] = acc[q];
    }
    if (lane == 0) s_key[grp] = has_first ? cs0 + x_start : -1;
    const bool any_end = __syncthreads_or(has_first);

    // one thread a column folds the groups' partials in order: a group's
    // first partial ends its segment, its last one is open at its end
    for (int c = tid; c < cw; c += kThreads) {
      A run = s_run[c];
      bool to_head = head_open;
      for (int q = 0; q < g.groups; ++q) {
        const int key = s_key[q];
        const A last = s_last[q * g.slice + c];
        if (key >= 0) {
          const A v = Comb<OP>::f(run, s_first[q * g.slice + c]);
          if (to_head) {
            head[k * width + c0 + c] = to_bits(v);
            to_head = false;
          } else {
            out[(int64_t)key * width + c0 + c] = Io<T>::store(v);
          }
          run = last;
        } else {
          run = Comb<OP>::f(run, last);
        }
      }
      s_run[c] = run;
    }
    if (any_end) head_open = false;
    __syncthreads();
  }

  // the segment open at the tile's end, where the tile holds rows of it
  const int64_t re = r0 + (d1 - s1);
  const bool carries = s1 < n_seg && re > offsets[s1];
  if (tid == 0 && blockIdx.y == 0) carry_seg[k] = carries ? s1 : -1;
  if (carries)
    for (int c = tid; c < cw; c += kThreads) carry[k * width + c0 + c] = to_bits(s_run[c]);
}

// One thread per tile and column; the first tile of a run that carries
// segment s folds the run's carries in tile order, then the head partial of
// the tile that ends s, and writes column c of s.
template <typename T, int OP>
__global__ void cols_fixup(const int32_t* __restrict__ carry_seg,
                           const uint32_t* __restrict__ carry,
                           const uint32_t* __restrict__ head, T* __restrict__ out,
                           int64_t n_tiles, int64_t width) {
  using A = typename Io<T>::A;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t k = t / width, c = t - k * width;
  if (k >= n_tiles) return;
  const int s = carry_seg[k];
  if (s < 0 || (k > 0 && carry_seg[k - 1] == s)) return;
  A acc = from_bits<A>(carry[k * width + c]);
  int64_t m = k + 1;
  for (bool open = true; open; m += 8) {  // 8 tiles' loads in flight
    int32_t ks[8];
    uint32_t vs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ks[i] = m + i < n_tiles ? carry_seg[m + i] : -1;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (m + i < n_tiles) vs[i] = ks[i] == s ? carry[(m + i) * width + c] : head[(m + i) * width + c];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (open && m + i < n_tiles) acc = Comb<OP>::f(acc, from_bits<A>(vs[i]));
      if (ks[i] != s) open = false;
    }
  }
  out[(int64_t)s * width + c] = Io<T>::store(acc);
}

// The scratch of both routes: tile_seg [n_tiles * chunks + 1] (the split at
// every chunk edge; the rows route's tile is one chunk), carry_seg
// [n_tiles], carry and head [n_tiles, width] words each.
struct Scratch {
  int32_t* tile_seg;
  int32_t* carry_seg;
  uint32_t* carry;
  uint32_t* head;
  Scratch(void* p, int64_t n_tiles, int chunks, int64_t width) {
    tile_seg = static_cast<int32_t*>(p);
    carry_seg = tile_seg + n_tiles * chunks + 1;
    carry = reinterpret_cast<uint32_t*>(carry_seg + n_tiles);
    head = carry + n_tiles * width;
  }
};

int64_t scratch_words(int64_t n_tiles, int chunks, int64_t width) {
  return n_tiles * (chunks + 1 + 2 * width) + 1;
}

int elem_bytes(int dtype) { return dtype == 0 || dtype == 2 ? 4 : (dtype == 1 ? 2 : 1); }

template <typename T, int OP, int CPT>
int launch_cols(const ColsGeom& g, const void* values, const uint8_t* mask,
                const int32_t* offsets, void* out, int n_seg, int64_t width,
                const Scratch& sc, int64_t n_tiles, cudaStream_t stream) {
  auto kernel = cols_tiles<T, OP, CPT>;
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)n_tiles, (unsigned)g.n_slices), kThreads, g.smem, stream>>>(
      static_cast<const T*>(values), mask, offsets, static_cast<T*>(out), n_seg, width, g,
      sc.tile_seg, sc.carry_seg, sc.carry, sc.head);
  return (int)cudaGetLastError();
}

template <typename T, int OP>
int launch(const void* values, const uint8_t* mask, const int32_t* offsets,
           void* out, int n_seg, int64_t width, void* scratch, int64_t n_tiles,
           cudaStream_t stream) {
  if (width == 1) {
    Scratch sc(scratch, n_tiles, 1, 1);
    seg_search<<<(unsigned)((n_tiles + 1 + 255) / 256), 256, 0, stream>>>(
        offsets, n_seg, n_tiles, sc.tile_seg, kTile);
    seg_tiles<T, OP><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
        static_cast<const T*>(values), mask, offsets, static_cast<T*>(out), n_seg,
        sc.tile_seg, sc.carry_seg, sc.carry, sc.head);
    seg_fixup<T, OP><<<(unsigned)((n_tiles + 255) / 256), 256, 0, stream>>>(
        sc.carry_seg, sc.carry, sc.head, static_cast<T*>(out), n_tiles);
    return (int)cudaGetLastError();
  }
  const ColsGeom g = cols_geom(width, sizeof(T));
  Scratch sc(scratch, n_tiles, kColsChunks, width);
  const int64_t n_chunks = n_tiles * kColsChunks;
  seg_search<<<(unsigned)((n_chunks + 1 + 255) / 256), 256, 0, stream>>>(
      offsets, n_seg, n_chunks, sc.tile_seg, g.chunk_items);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  switch (g.cpt) {
    case 1: err = launch_cols<T, OP, 1>(g, values, mask, offsets, out, n_seg, width, sc, n_tiles, stream); break;
    case 4: err = launch_cols<T, OP, 4>(g, values, mask, offsets, out, n_seg, width, sc, n_tiles, stream); break;
    default: err = launch_cols<T, OP, 16>(g, values, mask, offsets, out, n_seg, width, sc, n_tiles, stream);
  }
  if (err != 0) return err;
  cols_fixup<T, OP><<<(unsigned)((n_tiles * width + 255) / 256), 256, 0, stream>>>(
      sc.carry_seg, sc.carry, sc.head, static_cast<T*>(out), n_tiles, width);
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

// Merge items a tile for rows of `width` elements of type `dtype` (0 f32,
// 1 bf16, 2 int32, 3 bool), and the chunks a tile in *chunks: the rows
// route's kTile in one chunk for width 1, else kColsChunks chunks of
// cols_geom's chunk_items. The wrapper sizes the scratch by them.
extern "C" long long segment_reduce_tile_items(long long width, int dtype, int* chunks) {
  if (width == 1) {
    *chunks = 1;
    return kTile;
  }
  *chunks = kColsChunks;
  return (long long)cols_geom(width, elem_bytes(dtype)).chunk_items * kColsChunks;
}

// values [rows, width] (only rows in [offsets[0], offsets[n_seg]) are
// read), mask [rows] of bytes or NULL, offsets [n_seg + 1] int32 ascending,
// out [n_seg, width]; scratch of scratch_words words (at least
// n_tiles * (chunks + 1 + 2 * width) + 1) with n_tiles = ceil((rows +
// n_seg) / segment_reduce_tile_items(width, dtype, &chunks)). Returns 0 on
// success, else the cudaError_t of the launch.
extern "C" int segment_reduce_launch(int device, const void* values,
                                     const uint8_t* mask,
                                     const int32_t* offsets, void* out,
                                     int n_seg, long long width, int dtype,
                                     int op, void* scratch, long long n_tiles,
                                     long long n_scratch_words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_seg == 0 || width == 0) return 0;
  if (dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
  int chunks = 0;
  segment_reduce_tile_items(width, dtype, &chunks);
  if (n_scratch_words < scratch_words(n_tiles, chunks, width)) return (int)cudaErrorInvalidValue;
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
    default:
      return by_op_bool(op, values, mask, offsets, out, n_seg, width, scratch,
                        n_tiles, s);
  }
}
