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
// Bound on this card: bytes. Each output element moves its element size
// twice (one read of the table, one write) plus 4 index bytes per row, at
// 3.35 TB/s; there is no arithmetic to speak of. The table reads are
// random, so what decides the time is how many 32-byte sectors the reads
// touch, not the element count.
//
// Design: rows are D elements of 1, 2 or 4 bytes, copied element-wise by
// size (bool, bf16, f32/int32 all go through uint8/uint16/uint32). One
// thread per output element in a grid-stride loop: neighbouring threads
// write neighbouring addresses, so the output and index loads coalesce,
// and for D > 1 the threads of one row read one contiguous row. The TPU's
// scalar prefetch of the indices has no counterpart: each thread loads its
// own index. Wider (16-byte) copies and load balancing are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t n_rows,
                                   int64_t n_out, int64_t row_len, int mode,
                                   T fill) {
  const int64_t total = n_out * row_len;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t i = row_len == 1 ? t : t / row_len;
    const int64_t c = t - i * row_len;
    int64_t j = idx[i];
    if (mode == 0) {
      j = j < 0 ? 0 : (j >= n_rows ? n_rows - 1 : j);
      out[t] = table[j * row_len + c];
    } else {
      if (j < 0) j += n_rows;
      out[t] = (j >= 0 && j < n_rows) ? table[j * row_len + c] : fill;
    }
  }
}

template <typename T>
int launch(const void* table, const int32_t* idx, void* out, int64_t n_rows,
           int64_t n_out, int64_t row_len, int mode, uint32_t fill_bits,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n_out * row_len;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  gather_rows_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), n_rows, n_out,
      row_len, mode, static_cast<T>(fill_bits));
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1:
      return launch<uint8_t>(table, idx, out, n_rows, n_out, row_len, mode,
                             fill_bits, s);
    case 2:
      return launch<uint16_t>(table, idx, out, n_rows, n_out, row_len, mode,
                              fill_bits, s);
    case 4:
      return launch<uint32_t>(table, idx, out, n_rows, n_out, row_len, mode,
                              fill_bits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
