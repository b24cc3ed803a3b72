// Deterministic reduce-by-key for Hopper (sm_90a): the table gradient of a
// row gather and of an embedding bag.
//
//   out[r, :] = sum over j with sorted[j] = r, in ascending j, of
//               w[perm[j]] * values[perm[j] / h, :]       (0 if no j)
//
// for r in [0, n_out), where sorted = the ids sorted stably and perm the
// sort's permutation (int64, as torch.sort returns it). Ids outside
// [0, n_out) sort first or last and are skipped. Without weights (a null
// pointer) every slot weighs 1; h is the slots a value row has (an
// embedding bag's H, 1 for a gather). f32 and bf16 sum in f32 and round
// once.
//
// Replaces no TPU kernel by itself: it is the backward of two that the
// port already has, src/repro/kernels/gather_rows/kernel.py
// (gather_rows_kernel; JAX's gradient of jnp.take is a scatter-add) and
// src/repro/kernels/embedding_bag/kernel.py (embedding_bag_kernel; the
// table's gradient of the lookup), where PR 16 composed it of a sort,
// gather_rows and segment_reduce.
//
// Bound on this card: bytes. The sorted ids and the permutation are read
// once (12 bytes an id), each slot's value row once, and every output row
// written once, rows that no id names included (the C entry zeroes the
// output on the stream first). At AutoInt's train_batch (2,555,904 ids,
// rows of 16 f32, 39 M table rows) the dense 2.5 GB output is nearly all
// of it; at gat-cora's h[src] (41,182 ids of 64 f32 into 4,096 rows) the
// work is a few microseconds and the call is paced by the host.
//
// Design. No offsets and no permuted copy of the values:
//   scatter_tiles: a block takes a tile of `tile` consecutive sorted
//     positions (and, for rows of more than 32 units, one slice of 32
//     units: blockIdx.y). It stages the tile's ids (and the one before and
//     after it) and its permutation in shared memory. Threads lie over
//     positions x units: `lanes` threads a row (rows::row_lanes), `groups`
//     = 256 / lanes groups each over `span` consecutive positions. A group
//     issues kBatch row loads through perm (A-byte units, __ldg), then
//     folds them in ascending position into f32 registers; a position
//     whose id differs from the one before (a run head) ends a run. A run
//     that starts and ends inside the group is written at once; the
//     group's first finished run and its partial open at the end go to
//     shared memory. One thread a column then folds the groups' partials
//     in group order, writing every run that ends in the tile; the tile's
//     first run, where it began in an earlier tile, goes to part[k] and
//     the run open at the tile's end, where it began in this tile, to
//     carry[k]; flags[k] says which (bit 0: carries; bit 1: the tile lies
//     inside one run that goes on after it).
//   scatter_fixup: one thread per tile and column; a tile that carries a
//     run adds the part of every tile after it, in tile order, up to the
//     tile where the run ends, and writes the row.
// The order of every addition depends on the ids alone, so a sum is the
// same bits from launch to launch (no atomics). A hub run of 163,558 ids
// at rows of 16 f32 spans 80 tiles of 2,048 positions.

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 32;        // positions a group walks, at most
constexpr int kTileMax = 2048;   // positions a tile, at most
constexpr int kBatch = 8;        // row loads a lane keeps in flight
constexpr int kFixupLoads = 8;   // tiles' parts the fix-up keeps in flight

// A tile's layout for rows of `units` units.
struct Geom {
  int64_t units;  // units a row
  int lshift;     // log2 of the lanes a row
  int groups;     // kThreads >> lshift
  int span;       // positions a group
  int tile;       // positions a tile: groups * span
  int slices;     // slices of 32 units a row
};

Geom geom(int64_t row_bytes, int access) {
  Geom g;
  g.units = row_bytes / access;
  g.lshift = rows::row_lanes(g.units);
  g.groups = kThreads >> g.lshift;
  g.span = kTileMax / g.groups < kSpan ? kTileMax / g.groups : kSpan;
  g.tile = g.groups * g.span;
  g.slices = (int)((g.units + 31) / 32);
  return g;
}

// flags [n_tiles], row [n_tiles] (the id of the run open at the tile's
// end), part and carry [n_tiles, width] f32
struct Scratch {
  uint32_t* flags;
  int32_t* row;
  float* part;
  float* carry;
  Scratch(void* p, int64_t n_tiles, int64_t width) {
    flags = static_cast<uint32_t*>(p);
    row = reinterpret_cast<int32_t*>(flags + n_tiles);
    part = reinterpret_cast<float*>(row + n_tiles);
    carry = part + n_tiles * width;
  }
  static int64_t bytes(int64_t n_tiles, int64_t width) { return n_tiles * (8 + 8 * width); }
};

constexpr uint32_t kCarries = 1u, kContinues = 2u;

template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
scatter_tiles(const int32_t* __restrict__ sorted, const int64_t* __restrict__ perm,
              const typename rows::Unit<A>::V* __restrict__ values, const T* __restrict__ w,
              typename rows::Unit<A>::V* __restrict__ out, int64_t n_ids, int n_out, int h,
              Geom g, Scratch sc, int64_t width) {
  using V = typename rows::Unit<A>::V;
  constexpr int E = A / (int)sizeof(T);  // elements a unit
  __shared__ int32_t s_id[kTileMax + 2];  // sorted[t0 - 1 .. t0 + n]
  __shared__ int64_t s_perm[kTileMax];
  __shared__ float s_first[kThreads * E], s_last[kThreads * E];
  __shared__ int32_t s_key[kThreads];
  __shared__ int s_has[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & ((1 << g.lshift) - 1), grp = tid >> g.lshift;
  const int64_t k = blockIdx.x;
  const int64_t t0 = k * g.tile;
  const int n = (int)(n_ids - t0 < g.tile ? n_ids - t0 : g.tile);
  const int64_t u = (int64_t)blockIdx.y * 32 + lane;  // this lane's unit
  const bool has_unit = u < g.units;

  for (int i = tid; i < n + 2; i += kThreads) {
    const int64_t j = t0 - 1 + i;
    s_id[i] = j >= 0 && j < n_ids ? sorted[j] : 0;
  }
  for (int i = tid; i < n; i += kThreads) s_perm[i] = perm[t0 + i];
  __syncthreads();
  // a run starts at local position i (at the tile's end: the next starts)
  auto head = [&](int i) { return t0 + i == 0 || t0 + i == n_ids || s_id[i + 1] != s_id[i]; };
  auto valid = [&](int32_t r) { return r >= 0 && r < n_out; };

  float acc[E], first[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = first[e] = 0.f;
  bool has = false;  // a run ended in this group's span
  int32_t key = 0;   // the id of the first one
  const int p0 = grp * g.span;
  const int p1 = p0 + g.span < n ? p0 + g.span : n;
  for (int p = p0; p < p1; p += kBatch) {
    V v[kBatch];
    float wt[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = p + b;
      wt[b] = 1.f;
      v[b] = V();
      if (i < p1 && has_unit && valid(s_id[i + 1])) {
        const int64_t slot = s_perm[i];
        const int64_t src = h == 1 ? slot : (int64_t)((uint64_t)slot / (uint32_t)h);
        v[b] = __ldg(values + src * g.units + u);
        if (w != nullptr) wt[b] = rows::widen(w[slot]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = p + b;
      if (i < p1) {
        if (i > 0 && head(i)) {  // the run of s_id[i] ends before i
          const int32_t r = s_id[i];
          if (!has) {
#pragma unroll
            for (int e = 0; e < E; ++e) first[e] = acc[e];
            key = r;
            has = true;
          } else if (valid(r) && has_unit) {  // it began in this span too
            out[(int64_t)r * g.units + u] = rows::pack<T, A>(acc);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = 0.f;
        }
        if (valid(s_id[i + 1])) {
          float f[E];
          rows::unpack<T, A>(v[b], f);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += wt[b] * f[e];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    s_first[tid * E + e] = first[e];
    s_last[tid * E + e] = acc[e];
  }
  if (lane == 0) {
    s_has[grp] = has;
    s_key[grp] = key;
  }
  __syncthreads();

  // one thread a column of the slice folds the groups' partials in order
  const int64_t units_here = g.units - (int64_t)blockIdx.y * 32;
  const int cols = (int)((units_here < (1 << g.lshift) ? units_here : (1 << g.lshift)) * E);
  const int stride = E << g.lshift;  // a group's partials
  const int64_t c0 = (int64_t)blockIdx.y * 32 * E;
  const bool began_before = !head(0);
  const bool ends = head(n);
  const int32_t last_id = s_id[n];
  T* out_e = reinterpret_cast<T*>(out);
  for (int c = tid; c < cols; c += kThreads) {
    float run = 0.f;
    bool open = began_before;  // the run in progress began in an earlier tile
    for (int q = 0; q < g.groups; ++q) {
      const float last = s_last[q * stride + c];
      if (s_has[q]) {
        const float v = run + s_first[q * stride + c];
        if (open) sc.part[k * width + c0 + c] = v;
        else if (valid(s_key[q])) out_e[(int64_t)s_key[q] * width + c0 + c] = rows::narrow<T>(v);
        open = false;
        run = last;
      } else {
        run += last;
      }
    }
    if (open) sc.part[k * width + c0 + c] = run;  // the tile lies inside one run
    else if (!ends) sc.carry[k * width + c0 + c] = run;
    else if (valid(last_id)) out_e[(int64_t)last_id * width + c0 + c] = rows::narrow<T>(run);
  }
  if (blockIdx.y == 0 && tid == 0) {
    bool any = false;
    for (int q = 0; q < g.groups; ++q) any = any || s_has[q];
    const bool inside = began_before && !any;
    sc.flags[k] = (!inside && !ends && valid(last_id) ? kCarries : 0u) |
                  (inside && !ends ? kContinues : 0u);
    sc.row[k] = last_id;
  }
}

// One thread per tile and column: a tile that carries a run adds the
// parts of the tiles after it in tile order, up to the one it ends in.
template <typename T>
__global__ void scatter_fixup(Scratch sc, T* __restrict__ out, int64_t n_tiles, int64_t width) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t k = t / width, c = t - k * width;
  if (k >= n_tiles || !(sc.flags[k] & kCarries)) return;
  float acc = sc.carry[k * width + c];
  bool open = true;
  for (int64_t m = k + 1; open; m += kFixupLoads) {
    uint32_t fl[kFixupLoads];
    float pv[kFixupLoads];
#pragma unroll
    for (int i = 0; i < kFixupLoads; ++i) {
      fl[i] = m + i < n_tiles ? sc.flags[m + i] : 0u;
      pv[i] = m + i < n_tiles ? sc.part[(m + i) * width + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kFixupLoads; ++i) {
      if (open) {
        acc += pv[i];
        open = (fl[i] & kContinues) != 0;
      }
    }
  }
  out[(int64_t)sc.row[k] * width + c] = rows::narrow<T>(acc);
}

template <typename T, int A>
int launch(const int32_t* sorted, const int64_t* perm, const void* values, const void* w,
           void* out, int64_t n_ids, int n_out, int64_t width, int h, void* scratch,
           cudaStream_t s) {
  using V = typename rows::Unit<A>::V;
  const Geom g = geom(width * (int64_t)sizeof(T), A);
  const int64_t n_tiles = (n_ids + g.tile - 1) / g.tile;
  const Scratch sc(scratch, n_tiles, width);
  scatter_tiles<T, A><<<dim3((unsigned)n_tiles, (unsigned)g.slices), kThreads, 0, s>>>(
      sorted, perm, static_cast<const V*>(values), static_cast<const T*>(w),
      static_cast<V*>(out), n_ids, n_out, h, g, sc, width);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  scatter_fixup<T><<<(unsigned)((n_tiles * width + 255) / 256), 256, 0, s>>>(
      sc, static_cast<T*>(out), n_tiles, width);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int access, const int32_t* sorted, const int64_t* perm, const void* values,
           const void* w, void* out, int64_t n_ids, int n_out, int64_t width, int h,
           void* scratch, cudaStream_t s) {
  switch (access) {
    case 16: return launch<T, 16>(sorted, perm, values, w, out, n_ids, n_out, width, h, scratch, s);
    case 8: return launch<T, 8>(sorted, perm, values, w, out, n_ids, n_out, width, h, scratch, s);
    case 4: return launch<T, 4>(sorted, perm, values, w, out, n_ids, n_out, width, h, scratch, s);
    default: break;
  }
  if constexpr (sizeof(T) == 2)  // 2-byte units: bf16 rows of an odd width
    return launch<T, 2>(sorted, perm, values, w, out, n_ids, n_out, width, h, scratch, s);
  return (int)cudaErrorInvalidValue;
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// The plan of a launch for rows of `width` elements of `dtype` (0 f32,
// 1 bf16) read from `values` and written to `out`: the bytes of one
// access in *access, the positions a tile in *tile. The wrapper sizes the
// scratch by them: scatter_rows_scratch_bytes(ceil(n_ids / tile), width).
extern "C" int scatter_rows_plan(long long width, int dtype, const void* values,
                                 const void* out, int* access, int* tile) {
  const int elem = elem_bytes(dtype);
  const void* bases[2] = {values, out};
  *access = rows::row_access(width * elem, elem, bases, 2);
  *tile = *access ? geom(width * elem, *access).tile : 0;
  return *access ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" long long scatter_rows_scratch_bytes(long long n_tiles, long long width) {
  return Scratch::bytes(n_tiles, width);
}

// sorted int32 [n_ids] ascending, perm int64 [n_ids], values [n_ids / h,
// width] and w [n_ids] (or NULL) of `dtype` (0 f32, 1 bf16), out [n_out,
// width] of it; scratch of at least scatter_rows_scratch_bytes bytes for
// the plan's tiles. Zeroes out, then sums into it: a memset and two
// launches on `stream`. Returns 0 on success, else a cudaError_t.
extern "C" int scatter_rows_launch(int device, const int32_t* sorted, const int64_t* perm,
                                   const void* values, const void* w, void* out,
                                   long long n_ids, int n_out, long long width, int h,
                                   int dtype, void* scratch, long long scratch_bytes,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((dtype != 0 && dtype != 1) || h < 1) return (int)cudaErrorInvalidValue;
  if ((long long)n_out * width == 0) return 0;
  int access = 0, tile = 0;
  if (scatter_rows_plan(width, dtype, values, out, &access, &tile) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n_ids + tile - 1) / tile;
  if (scratch_bytes < Scratch::bytes(n_tiles, width)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)n_out * width * elem_bytes(dtype), s);
  if (err != cudaSuccess) return (int)err;
  if (n_ids == 0) return 0;
  return dtype == 0
      ? launch<float>(access, sorted, perm, values, w, out, n_ids, n_out, width, h, scratch, s)
      : launch<__nv_bfloat16>(access, sorted, perm, values, w, out, n_ids, n_out, width, h,
                              scratch, s);
}
