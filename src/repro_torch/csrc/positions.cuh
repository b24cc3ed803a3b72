// The flash kernels' positions route (csrc/flash_attention.cu and
// csrc/flash_attention_bwd.cu): the keep rule of the JAX package's
// attention_chunked (_mask_bias with its kv_mask), from int32 positions.
#pragma once

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
