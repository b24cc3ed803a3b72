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
//   scalar rows of more than one element (no graph program reads them):
//          one thread per output element.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_scalar(const T* __restrict__ table, const int32_t* __restrict__ idx,
              T* __restrict__ out, int64_t n_rows, int64_t n_out,
              int64_t row_len, int mode, T fill) {
  const int64_t total = n_out * row_len;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += stride) {
    const int64_t i = t / row_len;
    const int64_t c = t - i * row_len;
    bool ok;
    const int64_t j = resolve(idx[i], n_rows, mode, &ok);
    out[t] = ok ? table[j * row_len + c] : fill;
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

template <typename T>
int launch_scalar(const void* table, const int32_t* idx, void* out,
                  int64_t n_rows, int64_t n_out, int64_t row_len, int mode,
                  uint32_t fill, cudaStream_t s) {
  const int64_t blocks = grid_for(n_out * row_len, int64_t(1) << 20);
  gather_scalar<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), n_rows, n_out,
      row_len, mode, static_cast<T>(fill));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the launch.
extern "C" int gather_rows_launch(int device, const void* table,
                                  const int32_t* idx, void* out,
                                  long long n_rows, long long n_out,
                                  long long row_len, int elem_size, int mode,
                                  unsigned int fill_bits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_out * row_len == 0) return 0;
  if (elem_size != 1 && elem_size != 2 && elem_size != 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t fill =  // one element's bits
      elem_size == 4 ? fill_bits : fill_bits & ((1u << (8 * elem_size)) - 1);
  if (row_len == 1) {
    switch (elem_size) {
      case 1: return launch_vec<1>(table, idx, out, n_rows, n_out, mode, fill, s);
      case 2: return launch_vec<2>(table, idx, out, n_rows, n_out, mode, fill, s);
      default: return launch_vec<4>(table, idx, out, n_rows, n_out, mode, fill, s);
    }
  }
  switch (elem_size) {
    case 1:
      return launch_scalar<uint8_t>(table, idx, out, n_rows, n_out, row_len, mode, fill, s);
    case 2:
      return launch_scalar<uint16_t>(table, idx, out, n_rows, n_out, row_len, mode, fill, s);
    default:
      return launch_scalar<uint32_t>(table, idx, out, n_rows, n_out, row_len, mode, fill, s);
  }
}
