// The values' gradient of the sorted segmented reduction, for Hopper
// (sm_90a), driven by the segment offsets alone.
//
// For row i of segment s (offsets[s] <= i < offsets[s+1]) and the output's
// cotangent g [n_seg, W]:
//   sum       dv[i, :] = g[s, :]
//   max, min  dv[i, c] = g[s, c] * [v[i, c] == out[s, c]] / ties[s, c]
//             ties[s, c] = #{rows i' of s: v'[i', c] == out[s, c]}
//                          + [out[s, c] is the combiner's identity]
// where v' is v with masked rows replaced by the identity (JAX's rule: the
// gradient of a scatter max/min splits evenly across the entries equal to
// the result, the initial value one of them). Rows before offsets[0] or at
// or after offsets[n_seg], and masked rows, get 0. f32 and bf16; the share
// is taken in f32 (g * (1 / ties), each correctly rounded) and rounded
// once, bit for bit as the plain version takes it.
//
// Replaces no TPU kernel by itself: it is the backward of
// src/repro/kernels/segment_reduce/kernel.py (segment_sum_ell_kernel),
// whose port csrc/segment_reduce.cu computes the forward; PR 16 composed
// it of gather_rows launches over ids expanded per row and, for max and
// min, a gathered copy of the output and a segment_reduce of the ties.
//
// Bound on this card: bytes. Sum reads g once for each segment's rows
// (the segment's row stays in L1/L2 while its rows are written) and
// writes every value row once; max and min read the values twice and out
// and g once per segment. At gat-cora's aggregation (41,182 rows of 64
// f32 from 4,096 segments) that is a few microseconds.
//
// Design: rows x units, as csrc/scatter_rows.cu lays them out (`lanes`
// threads a row of A-byte units, rows::row_access, rows::row_lanes;
// slices of 32 units on blockIdx.y), `groups` = 256 / lanes groups of
// kRows consecutive rows a block. A block finds the segments of its first
// and last row by a search of all its threads at once (each round one
// probe a thread, __syncthreads_count, ~log_256(n_seg) rounds), then each
// row's segment by a binary search between those two. No id is read and
// nothing is expanded per row.
//   sum       one launch: each row's unit is g's unit of its segment, or 0.
//   max, min  two launches after zeroing the tie counts [n_seg, W] on the
//             stream: bwd_ties counts each group's ties per segment in
//             registers and adds them with one int32 atomicAdd a segment
//             and column (an integer count is the same whatever the order
//             of its additions, so the result is the same from launch to
//             launch; a long segment is split across blocks by rows);
//             bwd_write then writes each row's share.

#include "rows.cuh"

namespace {

enum { OP_SUM = 0, OP_MIN = 2, OP_MAX = 3 };

constexpr int kThreads = 256;
constexpr int kRows = 8;  // consecutive rows a group takes

struct Geom {
  int64_t units;  // units a row
  int lshift;     // log2 of the lanes a row
  int rows;       // rows a block: (kThreads >> lshift) * kRows
  int slices;     // slices of 32 units a row
};

Geom geom(int64_t row_bytes, int access) {
  Geom g;
  g.units = row_bytes / access;
  g.lshift = rows::row_lanes(g.units);
  g.rows = (kThreads >> g.lshift) * kRows;
  g.slices = (int)((g.units + 31) / 32);
  return g;
}

// The last s in [0, n_seg) with offsets[s] <= i, for offsets[0] <= i <
// offsets[n_seg], found by all threads of the block together (all must
// call it, with the same i).
__device__ int block_segment(const int32_t* __restrict__ offsets, int n_seg, int64_t i) {
  int lo = 0, hi = n_seg - 1;  // offsets[lo] <= i; the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t span = (int64_t)hi - lo + 1;
    const int probe = lo + (int)(span * threadIdx.x / kThreads);  // ascending; thread 0 at lo
    const int below = __syncthreads_count(offsets[probe] <= i);  // a prefix of the threads
    const int t = below - 1;                                      // the last probe at or below i
    const int nlo = lo + (int)(span * t / kThreads);
    hi = t + 1 < kThreads ? lo + (int)(span * (t + 1) / kThreads) - 1 : hi;
    lo = nlo;
  }
  return lo;
}

// The last s in [lo, hi] with offsets[s] <= i (offsets[lo] <= i).
__device__ __forceinline__ int row_segment(const int32_t* __restrict__ offsets, int lo, int hi,
                                           int64_t i) {
  while (lo < hi) {
    const int mid = (int)(((int64_t)lo + hi + 1) >> 1);
    if (offsets[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// This block's rows [i0, i1), and the segments of the first and last of
// them inside [offsets[0], offsets[n_seg]) in *sa, *sb (sb < sa: none).
struct Block {
  int64_t i0, i1, lo, hi;  // rows, and the rows of any segment [lo, hi)
  int sa, sb;
};

__device__ Block block_rows(const int32_t* __restrict__ offsets, int n_seg, int64_t n_rows,
                            const Geom& g) {
  Block b;
  b.i0 = (int64_t)blockIdx.x * g.rows;
  b.i1 = n_rows - b.i0 < g.rows ? n_rows : b.i0 + g.rows;
  b.lo = offsets[0];
  b.hi = offsets[n_seg];
  const int64_t r0 = b.i0 > b.lo ? b.i0 : b.lo, r1 = b.i1 < b.hi ? b.i1 : b.hi;
  b.sa = 0;
  b.sb = -1;
  if (r0 < r1) {
    b.sa = block_segment(offsets, n_seg, r0);
    b.sb = block_segment(offsets, n_seg, r1 - 1);
  }
  return b;
}

// sum: dv[i] = g[segment of i], or 0
template <int A>
__global__ void __launch_bounds__(kThreads)
bwd_sum(const typename rows::Unit<A>::V* __restrict__ g, const int32_t* __restrict__ offsets,
        const uint8_t* __restrict__ mask, typename rows::Unit<A>::V* __restrict__ dv, int n_seg,
        int64_t n_rows, Geom geo) {
  using V = typename rows::Unit<A>::V;
  const Block b = block_rows(offsets, n_seg, n_rows, geo);
  const int lane = threadIdx.x & ((1 << geo.lshift) - 1);
  const int64_t u = (int64_t)blockIdx.y * 32 + lane;
  const int64_t first = b.i0 + (int64_t)(threadIdx.x >> geo.lshift) * kRows;
  if (u >= geo.units) return;
  V v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = first + r;
    v[r] = V();
    if (i < b.i1 && i >= b.lo && i < b.hi && (mask == nullptr || mask[i]))
      v[r] = __ldg(g + (int64_t)row_segment(offsets, b.sa, b.sb, i) * geo.units + u);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (first + r < b.i1) dv[(first + r) * geo.units + u] = v[r];
}

template <int OP> __device__ __forceinline__ float ident();
template <> __device__ __forceinline__ float ident<OP_MAX>() { return __int_as_float(0xff800000); }
template <> __device__ __forceinline__ float ident<OP_MIN>() { return __int_as_float(0x7f800000); }

// max, min: count[s, c] += the rows of s whose (masked: identity) value
// equals out[s, c]
template <typename T, int A, int OP>
__global__ void __launch_bounds__(kThreads)
bwd_ties(const typename rows::Unit<A>::V* __restrict__ values,
         const typename rows::Unit<A>::V* __restrict__ out, const int32_t* __restrict__ offsets,
         const uint8_t* __restrict__ mask, int32_t* __restrict__ count, int n_seg,
         int64_t n_rows, Geom geo, int64_t width) {
  constexpr int E = A / (int)sizeof(T);
  const Block b = block_rows(offsets, n_seg, n_rows, geo);
  const int lane = threadIdx.x & ((1 << geo.lshift) - 1);
  const int64_t u = (int64_t)blockIdx.y * 32 + lane;
  const int64_t first = b.i0 + (int64_t)(threadIdx.x >> geo.lshift) * kRows;
  if (u >= geo.units) return;
  int cur = -1;  // the segment being counted
  int cnt[E];
  float o[E];
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (cnt[e]) atomicAdd(count + (int64_t)cur * width + u * E + e, cnt[e]);
  };
#pragma unroll
  for (int e = 0; e < E; ++e) cnt[e] = 0;
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = first + r;
    if (i >= b.i1 || i < b.lo || i >= b.hi) continue;
    const int s = row_segment(offsets, b.sa, b.sb, i);
    if (s != cur) {
      flush();
      cur = s;
      rows::unpack<T, A>(__ldg(out + (int64_t)s * geo.units + u), o);
#pragma unroll
      for (int e = 0; e < E; ++e) cnt[e] = 0;
    }
    float v[E];
    if (mask == nullptr || mask[i]) {
      rows::unpack<T, A>(__ldg(values + i * geo.units + u), v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = ident<OP>();
    }
#pragma unroll
    for (int e = 0; e < E; ++e) cnt[e] += v[e] == o[e];
  }
  flush();
}

// max, min: dv[i, c] = g[s, c] * (1 / (count[s, c] + [out[s, c] == identity]))
// where the row is unmasked and v[i, c] == out[s, c], else 0
template <typename T, int A, int OP>
__global__ void __launch_bounds__(kThreads)
bwd_write(const typename rows::Unit<A>::V* __restrict__ values,
          const typename rows::Unit<A>::V* __restrict__ out,
          const typename rows::Unit<A>::V* __restrict__ g, const int32_t* __restrict__ offsets,
          const uint8_t* __restrict__ mask, const int32_t* __restrict__ count,
          typename rows::Unit<A>::V* __restrict__ dv, int n_seg, int64_t n_rows, Geom geo,
          int64_t width) {
  constexpr int E = A / (int)sizeof(T);
  const Block b = block_rows(offsets, n_seg, n_rows, geo);
  const int lane = threadIdx.x & ((1 << geo.lshift) - 1);
  const int64_t u = (int64_t)blockIdx.y * 32 + lane;
  const int64_t first = b.i0 + (int64_t)(threadIdx.x >> geo.lshift) * kRows;
  if (u >= geo.units) return;
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = first + r;
    if (i >= b.i1) break;
    float d[E];
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = 0.f;
    if (i >= b.lo && i < b.hi && (mask == nullptr || mask[i])) {
      const int64_t s = row_segment(offsets, b.sa, b.sb, i);
      float v[E], o[E], gs[E];
      rows::unpack<T, A>(__ldg(values + i * geo.units + u), v);
      rows::unpack<T, A>(__ldg(out + s * geo.units + u), o);
      rows::unpack<T, A>(__ldg(g + s * geo.units + u), gs);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (v[e] == o[e]) {
          const int ties = __ldg(count + s * width + u * E + e) + (o[e] == ident<OP>());
          d[e] = __fmul_rn(gs[e], __frcp_rn((float)ties));
        }
      }
    }
    dv[i * geo.units + u] = rows::pack<T, A>(d);
  }
}

template <typename T, int A, int OP>
int launch_extremum(const void* g, const void* values, const void* out,
                    const int32_t* offsets, const uint8_t* mask, void* dv, int n_seg,
                    int64_t n_rows, int64_t width, int32_t* count, cudaStream_t s) {
  using V = typename rows::Unit<A>::V;
  const Geom geo = geom(width * (int64_t)sizeof(T), A);
  const dim3 grid((unsigned)((n_rows + geo.rows - 1) / geo.rows), (unsigned)geo.slices);
  cudaError_t err = cudaMemsetAsync(count, 0, (size_t)n_seg * width * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  bwd_ties<T, A, OP><<<grid, kThreads, 0, s>>>(
      static_cast<const V*>(values), static_cast<const V*>(out), offsets, mask, count, n_seg,
      n_rows, geo, width);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  bwd_write<T, A, OP><<<grid, kThreads, 0, s>>>(
      static_cast<const V*>(values), static_cast<const V*>(out), static_cast<const V*>(g),
      offsets, mask, count, static_cast<V*>(dv), n_seg, n_rows, geo, width);
  return (int)cudaGetLastError();
}

template <typename T, int A>
int launch(int op, const void* g, const void* values, const void* out, const int32_t* offsets,
           const uint8_t* mask, void* dv, int n_seg, int64_t n_rows, int64_t width,
           int32_t* count, cudaStream_t s) {
  using V = typename rows::Unit<A>::V;
  if (op == OP_SUM) {
    const Geom geo = geom(width * (int64_t)sizeof(T), A);
    const dim3 grid((unsigned)((n_rows + geo.rows - 1) / geo.rows), (unsigned)geo.slices);
    bwd_sum<A><<<grid, kThreads, 0, s>>>(static_cast<const V*>(g), offsets, mask,
                                          static_cast<V*>(dv), n_seg, n_rows, geo);
    return (int)cudaGetLastError();
  }
  return op == OP_MAX
      ? launch_extremum<T, A, OP_MAX>(g, values, out, offsets, mask, dv, n_seg, n_rows, width,
                                      count, s)
      : launch_extremum<T, A, OP_MIN>(g, values, out, offsets, mask, dv, n_seg, n_rows, width,
                                      count, s);
}

template <typename T>
int launch(int access, int op, const void* g, const void* values, const void* out,
           const int32_t* offsets, const uint8_t* mask, void* dv, int n_seg, int64_t n_rows,
           int64_t width, int32_t* count, cudaStream_t s) {
  switch (access) {
    case 16: return launch<T, 16>(op, g, values, out, offsets, mask, dv, n_seg, n_rows, width, count, s);
    case 8: return launch<T, 8>(op, g, values, out, offsets, mask, dv, n_seg, n_rows, width, count, s);
    case 4: return launch<T, 4>(op, g, values, out, offsets, mask, dv, n_seg, n_rows, width, count, s);
    default: break;
  }
  if constexpr (sizeof(T) == 2)  // 2-byte units: bf16 rows of an odd width
    return launch<T, 2>(op, g, values, out, offsets, mask, dv, n_seg, n_rows, width, count, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// op 0 sum, 2 min, 3 max (segment_reduce's codes); dtype 0 f32, 1 bf16. g
// [n_seg, width], offsets int32 [n_seg + 1] ascending, mask [n_rows] of
// bytes or NULL, dv [n_rows, width]; for min and max also values [n_rows,
// width], out [n_seg, width] and count, int32 scratch [n_seg, width]. Writes
// every row of dv. Returns 0 on success, else a cudaError_t.
extern "C" int segment_reduce_bwd_launch(int device, int op, int dtype, const void* g,
                                         const void* values, const void* out,
                                         const int32_t* offsets, const uint8_t* mask, void* dv,
                                         int n_seg, long long n_rows, long long width,
                                         int32_t* count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((dtype != 0 && dtype != 1) || (op != OP_SUM && op != OP_MIN && op != OP_MAX))
    return (int)cudaErrorInvalidValue;
  const bool extremum = op != OP_SUM;
  if (extremum && (values == nullptr || out == nullptr || count == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows * width == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  const void* bases[4] = {g, dv, values, out};
  const int access = rows::row_access(width * elem, elem, bases, 4);
  if (access == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? launch<float>(access, op, g, values, out, offsets, mask, dv, n_seg, n_rows, width, count, s)
      : launch<__nv_bfloat16>(access, op, g, values, out, offsets, mask, dv, n_seg, n_rows, width,
                              count, s);
}
