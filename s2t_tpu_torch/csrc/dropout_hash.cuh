// Counter-based attention-dropout bits shared by attention_fwd.cu and attention_bwd.cu.
//
// The key is the 64-bit seed, the counter (batch, head, query, key):
//   stream = mix(mix(seed_lo ^ mix(b * H + h)) ^ seed_hi)
//   bits   = mix(stream ^ mix(query << 16 | key))            (T < 65536)
//   keep   = bits >> 24 >= rate_u8
// with mix the 32-bit "lowbias32" integer hash.  s2t_tpu_torch/ops/attention_cuda.py
// (keep_mask) computes the same bits with torch integer ops, so the plain version drops
// exactly the entries the kernels drop.  The uint8-threshold semantics are those of
// s2t_tpu/ops/attention_pallas.py:71-78 (keep iff the top byte >= round(rate * 256));
// the bits themselves are not the TPU's.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t s2t_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t s2t_dropout_stream(unsigned long long seed, uint32_t bh) {
  const uint32_t lo = (uint32_t)(seed & 0xffffffffull);
  const uint32_t hi = (uint32_t)(seed >> 32);
  return s2t_mix32(s2t_mix32(lo ^ s2t_mix32(bh)) ^ hi);
}

__device__ __forceinline__ bool s2t_dropout_keep(uint32_t stream, int query, int key,
                                                 int rate_u8) {
  const uint32_t r = s2t_mix32(stream ^ s2t_mix32(((uint32_t)query << 16) | (uint32_t)key));
  return (int)(r >> 24) >= rate_u8;
}
