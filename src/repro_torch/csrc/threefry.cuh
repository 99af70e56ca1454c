// Threefry-2x32 (20 rounds) and the float32 uniform of jax.random, shared
// by the kernels that draw from the JAX package's key stream
// (randmask.cu: the dense wire's element mask and the uniforms of
// stochastic rounding; varco_pack_quant.cu: the fused stochastic codec).
//
//   bits(key, c)    = y0 ^ y1,  (y0, y1) = threefry2x32(key, (c >> 32,
//                     c & 0xffffffff))   (jax's partitionable layout)
//   uniform(key, c) = float((bits >> 9) | 0x3F800000) - 1   in [0, 1)
//
// k2 = k0 ^ k1 ^ 0x1BD11BDA is the key schedule's third word; callers
// compute it once per key.  A draw is 76 32-bit integer operations: the
// counter injection (2), 20 rounds of add, rotate and xor (60), 5 key
// injections of two adds (10), the output xor, shift, or and the float
// subtract (4).

#pragma once

#include <stdint.h>

namespace threefry {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, on the counter (hi, lo); returns y0 ^ y1
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint32_t k2, uint32_t hi,
                                         uint32_t lo) {
  uint32_t a = hi + k0, b = lo + k1;
#define TF_ROUND(r) \
  a += b;           \
  b = rotl(b, r);   \
  b ^= a;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  a += k1; b += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  a += k2; b += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  a += k0; b += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  a += k1; b += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  a += k2; b += k0 + 5u;
#undef TF_ROUND
  return a ^ b;
}

// jax.random.uniform's float32 draw at the 64-bit counter c
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1,
                                         uint32_t k2, uint64_t c) {
  const uint32_t b = bits(k0, k1, k2, (uint32_t)(c >> 32), (uint32_t)c);
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace threefry
