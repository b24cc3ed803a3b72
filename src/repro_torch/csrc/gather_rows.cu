// Row gather for Hopper (sm_90a): out[i, :] = table[j(i), :].
//
// Replaces the TPU kernel src/repro/kernels/gather_rows/kernel.py
// (gather_rows_kernel, body _gather_kernel), the Palgol remote read: chain
// access D[D[u]], neighbour reads F[e.id] and gathers of per-vertex values
// onto edges. Index modes, as jnp.take computes them:
//   mode 0 (clip): j = clamp(idx[i], 0, V-1) -- what the TPU kernel does;
//   mode 1 (fill): idx in [-V, -1] wraps to idx + V, any other index outside
//                  [0, V) writes the fill value instead of reading.
//
// Bound on this card: bytes. Each output row moves its bytes twice (one
// read of the table, one write) plus 4 index bytes per row, at 3.35 TB/s;
// there is no arithmetic to speak of. The table reads are random, so each
// one-element read costs a 32-byte sector of L2 (or an L1 hit), and for
// the graph's neighbour reads the index and output streams are nearly all
// the bytes that reach device memory.
//
// What bounds it on an H100, measured at the graph's shapes (chip_smoke.py's
// index patterns): the L2's rate of random 32-byte sectors, not the index
// and output streams. A 16.8 MB int32 table read at 128 M uniform ids
// takes as long with every layout of the streams that was tried; the same
// streams over a table that stays in L1 run near the copy rate; the
// graph's own neighbour ids (hot low ids, partly L1 hits) sit close to the
// uniform case.
//
// Design, by two routes chosen by row length alone (the wrapper's
// ops.route names the same one):
//   vec    rows of one element (the graph's reads, any index alignment):
//          lane l of a warp takes output l, so each warp's index load,
//          table loads and store cover 32 neighbouring outputs. One output
//          a thread: runs of 2-8 outputs a thread (16-byte index vectors,
//          or warp-strided runs with the next run's indices prefetched, on
//          a persistent grid) were slower on the graph's ids and SSSP's
//          bool flag, and faster only where the table stays in L1.
//          Blocks of 1024 threads (256 and 512 were slower there).
//          The index and output streams are read and written once
//          (evict-first, "cs"); the table reads allocate in L1, where the
//          hot low ids of a power-law graph hit (an L2 evict-last policy on
//          them and an L1 evict-first on cold ids did not pay, and
//          L1::no_allocate made them slower).
//   scalar rows of more than one element (the GNN layers' feature reads:
//          rows of 16 to 2,408 bytes). What bounds a row copy on this card
//          is the count of memory instructions and of bytes in flight: one
//          2- or 4-byte access an element (and a 64-bit division by the row
//          length to find it) cannot keep 3.35 TB/s busy. So a group of
//          lanes copies a row (gather_units): the C entry takes the widest
//          access of 16, 8, 4, 2 or 1 bytes that divides the row's bytes and
//          both base addresses (access_bytes; SAGE's 400-byte and
//          GraphCast's 1,024-byte rows take 16, PNA's 200-byte bf16 rows and
//          the minibatch's 2,408-byte f32 rows 8), and reports it. A row is
//          `units` accesses; its group is the power of two of lanes at or
//          above that, up to a warp (several rows a warp for short rows), so
//          the row comes from the thread's group by a shift, and the group
//          reads the row's index once. Where a row is at most one access a
//          lane, a group takes kRowsInFlight = 4 neighbouring rows at once
//          and issues their index loads, then their row loads, before any
//          store; a wider row (the minibatch's: 301 accesses) keeps ten
//          accesses a lane in flight alone and takes one row (measured at
//          the GNN shapes on the H100: 4 rows 7.9 against 9.0 ms at PNA's,
//          1 row 0.478 against 0.566 ms at the minibatch's). Table reads
//          through L1 (__ldg), index and output streams evict-first, as the
//          vec route.
// A launch never falls back from one route to the other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // fewer, larger blocks read the graph's ids faster

// a table element, zero-extended to 32 bits, through L1
template <int E>
__device__ __forceinline__ uint32_t load_table(const uint8_t* table, int64_t j);
template <>
__device__ __forceinline__ uint32_t load_table<1>(const uint8_t* table, int64_t j) {
  return __ldg(table + j);
}
template <>
__device__ __forceinline__ uint32_t load_table<2>(const uint8_t* table, int64_t j) {
  return __ldg(reinterpret_cast<const uint16_t*>(table) + j);
}
template <>
__device__ __forceinline__ uint32_t load_table<4>(const uint8_t* table, int64_t j) {
  return __ldg(reinterpret_cast<const uint32_t*>(table) + j);
}

// an output element, evict-first
template <int E>
__device__ __forceinline__ void store_out(uint8_t* out, int64_t i, uint32_t v) {
  if (E == 1) __stcs(reinterpret_cast<unsigned char*>(out) + i, (unsigned char)v);
  else if (E == 2) __stcs(reinterpret_cast<unsigned short*>(out) + i, (unsigned short)v);
  else __stcs(reinterpret_cast<unsigned int*>(out) + i, v);
}

// the row an index reads; *ok is false where fill mode writes the fill
__device__ __forceinline__ int64_t resolve(int64_t j, int64_t n_rows, int mode,
                                           bool* ok) {
  if (mode == 0) {
    *ok = true;
    return j < 0 ? 0 : (j >= n_rows ? n_rows - 1 : j);
  }
  if (j < 0) j += n_rows;
  *ok = j >= 0 && j < n_rows;
  return j;
}

// ---- vec route, rows of one element -----------------------------------------

template <int E, int MODE>
__global__ void __launch_bounds__(kThreads)
gather_vec(const uint8_t* __restrict__ table, const int32_t* __restrict__ idx,
           uint8_t* __restrict__ out, int64_t n_rows, int64_t n_out,
           uint32_t fill) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_out; i += stride) {
    bool ok;
    const int64_t j = resolve(__ldcs(idx + i), n_rows, MODE, &ok);
    store_out<E>(out, i, ok ? load_table<E>(table, j) : fill);
  }
}

// ---- scalar route -------------------------------------------------------------

constexpr int kUnitThreads = 256;
// rows a group copies at once where a row is at most one access a lane;
// a wider row is several accesses a lane already, and takes one row
constexpr int kRowsInFlight = 4;

template <int A> struct Unit;  // one access of A bytes
template <> struct Unit<16> { using V = uint4; };
template <> struct Unit<8> { using V = uint2; };
template <> struct Unit<4> { using V = unsigned int; };
template <> struct Unit<2> { using V = unsigned short; };
template <> struct Unit<1> { using V = unsigned char; };

// the fill element repeated over an access (w: over 32 bits)
template <typename V> __device__ __forceinline__ V splat(uint32_t w);
template <> __device__ __forceinline__ uint4 splat(uint32_t w) { return make_uint4(w, w, w, w); }
template <> __device__ __forceinline__ uint2 splat(uint32_t w) { return make_uint2(w, w); }
template <> __device__ __forceinline__ unsigned int splat(uint32_t w) { return w; }
template <> __device__ __forceinline__ unsigned short splat(uint32_t w) { return (unsigned short)w; }
template <> __device__ __forceinline__ unsigned char splat(uint32_t w) { return (unsigned char)w; }

// Rows of `units` accesses of A bytes; groups of 2^gshift lanes, K
// neighbouring rows a group at a time.
template <int A, int MODE, int K>
__global__ void __launch_bounds__(kUnitThreads)
gather_units(const typename Unit<A>::V* __restrict__ table, const int32_t* __restrict__ idx,
             typename Unit<A>::V* __restrict__ out, int64_t n_rows, int64_t n_out,
             int64_t units, int gshift, uint32_t fill_word) {
  using V = typename Unit<A>::V;
  const int lane = threadIdx.x & ((1 << gshift) - 1);
  const int64_t n_groups = ((int64_t)gridDim.x * kUnitThreads) >> gshift;
  const int64_t group = ((int64_t)blockIdx.x * kUnitThreads + threadIdx.x) >> gshift;
  const V fill = splat<V>(fill_word);
  for (int64_t i0 = group * K; i0 < n_out; i0 += n_groups * K) {
    const V* src[K];  // nullptr: fill (or no row)
#pragma unroll
    for (int r = 0; r < K; ++r) {
      bool ok = false;
      const int64_t j = i0 + r < n_out ? resolve(__ldcs(idx + i0 + r), n_rows, MODE, &ok) : 0;
      src[r] = ok ? table + j * units : nullptr;
    }
    for (int64_t u = lane; u < units; u += (1 << gshift)) {
      V v[K];
#pragma unroll
      for (int r = 0; r < K; ++r) v[r] = src[r] ? __ldg(src[r] + u) : fill;
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (i0 + r < n_out) __stcs(out + (i0 + r) * units + u, v[r]);
    }
  }
}

// ---- launch -----------------------------------------------------------------------

int64_t grid_for(int64_t work, int64_t cap) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : blocks;
}

template <int E, int MODE>
int launch_vec(const void* table, const int32_t* idx, void* out,
               int64_t n_rows, int64_t n_out, uint32_t fill, cudaStream_t s) {
  const int64_t blocks = grid_for(n_out, int64_t(1) << 20);
  gather_vec<E, MODE><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(table), idx, static_cast<uint8_t*>(out),
      n_rows, n_out, fill);
  return (int)cudaGetLastError();
}

template <int E>
int launch_vec(const void* table, const int32_t* idx, void* out,
               int64_t n_rows, int64_t n_out, int mode, uint32_t fill,
               cudaStream_t s) {
  return mode == 0 ? launch_vec<E, 0>(table, idx, out, n_rows, n_out, fill, s)
                   : launch_vec<E, 1>(table, idx, out, n_rows, n_out, fill, s);
}

// the widest access of 16, 8, 4, 2 or 1 bytes that divides the row's bytes
// and both base addresses
int access_bytes(int64_t row_bytes, const void* table, const void* out) {
  const uintptr_t t = reinterpret_cast<uintptr_t>(table), o = reinterpret_cast<uintptr_t>(out);
  int a = 16;
  while (a > 1 && (row_bytes % a || t % a || o % a)) a >>= 1;
  return a;
}

template <int A, int K>
int launch_units(const void* table, const int32_t* idx, void* out, int64_t n_rows,
                 int64_t n_out, int64_t units, int gshift, int mode, uint32_t fill_word,
                 cudaStream_t s) {
  using V = typename Unit<A>::V;
  const int64_t groups = (n_out + K - 1) / K;
  int64_t blocks = ((groups << gshift) + kUnitThreads - 1) / kUnitThreads;
  if (blocks > (int64_t(1) << 20)) blocks = int64_t(1) << 20;
  if (mode == 0)
    gather_units<A, 0, K><<<(unsigned)blocks, kUnitThreads, 0, s>>>(
        static_cast<const V*>(table), idx, static_cast<V*>(out), n_rows, n_out, units, gshift,
        fill_word);
  else
    gather_units<A, 1, K><<<(unsigned)blocks, kUnitThreads, 0, s>>>(
        static_cast<const V*>(table), idx, static_cast<V*>(out), n_rows, n_out, units, gshift,
        fill_word);
  return (int)cudaGetLastError();
}

template <int A>
int launch_units(const void* table, const int32_t* idx, void* out, int64_t n_rows,
                 int64_t n_out, int64_t row_bytes, int mode, uint32_t fill_word,
                 cudaStream_t s) {
  const int64_t units = row_bytes / A;
  int gshift = 0;
  while (gshift < 5 && (int64_t(1) << gshift) < units) ++gshift;
  return units <= 32 ? launch_units<A, kRowsInFlight>(table, idx, out, n_rows, n_out, units,
                                                      gshift, mode, fill_word, s)
                     : launch_units<A, 1>(table, idx, out, n_rows, n_out, units, gshift, mode,
                                          fill_word, s);
}

}  // namespace

// table [n_rows, row_len] of elem_size-byte elements, idx int32 [n_out],
// out [n_out, row_len]; mode 0 clips, mode 1 fills with fill_bits. Writes
// the bytes of one access to *access_out (the element's on the vec route;
// 0 when nothing launched). Returns 0 on success, else the cudaError_t of
// the launch.
extern "C" int gather_rows_launch(int device, const void* table,
                                  const int32_t* idx, void* out,
                                  long long n_rows, long long n_out,
                                  long long row_len, int elem_size, int mode,
                                  unsigned int fill_bits, void* stream,
                                  int* access_out) {
  *access_out = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_out * row_len == 0) return 0;
  if (elem_size != 1 && elem_size != 2 && elem_size != 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t fill =  // one element's bits
      elem_size == 4 ? fill_bits : fill_bits & ((1u << (8 * elem_size)) - 1);
  int rc;
  if (row_len == 1) {
    switch (elem_size) {
      case 1: rc = launch_vec<1>(table, idx, out, n_rows, n_out, mode, fill, s); break;
      case 2: rc = launch_vec<2>(table, idx, out, n_rows, n_out, mode, fill, s); break;
      default: rc = launch_vec<4>(table, idx, out, n_rows, n_out, mode, fill, s);
    }
    if (rc == 0) *access_out = elem_size;
    return rc;
  }
  const int64_t row_bytes = row_len * elem_size;
  const uint32_t word = elem_size == 4 ? fill : (elem_size == 2 ? fill * 0x10001u : fill * 0x01010101u);
  const int a = access_bytes(row_bytes, table, out);
  switch (a) {
    case 16: rc = launch_units<16>(table, idx, out, n_rows, n_out, row_bytes, mode, word, s); break;
    case 8: rc = launch_units<8>(table, idx, out, n_rows, n_out, row_bytes, mode, word, s); break;
    case 4: rc = launch_units<4>(table, idx, out, n_rows, n_out, row_bytes, mode, word, s); break;
    case 2: rc = launch_units<2>(table, idx, out, n_rows, n_out, row_bytes, mode, word, s); break;
    default: rc = launch_units<1>(table, idx, out, n_rows, n_out, row_bytes, mode, word, s);
  }
  if (rc == 0) *access_out = a;
  return rc;
}
