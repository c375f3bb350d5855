// JAX's threefry2x32 on the device, shared by kernel T1 (threefry_kernel.cu)
// and the engines' steps, kernel S1 (engine_kernel.cu) and kernels S2 and
// S3 (mixed_alt_kernel.cu).
//
// The same numbers as core/threefry.py and `jax.random` (JAX 0.9.0, the
// partitionable layout), bit for bit: `threefry2x32` is the 20-round hash
// of a counter pair under a key, `fold_in(k, d)` hashes the pair (0, d),
// and a uniform puts the top 23 bits of y0 ^ y1 under the exponent of 1.0
// and subtracts 1.0 (exact).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gst {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// One round: mix x1 into x0, rotate x1 by r, xor x0 into it.  Four rounds
// make a group; after group g (1-based) the key schedule's word g % 3 is
// added to x0 and word (g + 1) % 3 plus g to x1.
#define GST_ROUND(r)  \
  x0 += x1;           \
  x1 = rotl(x1, r);   \
  x1 ^= x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  GST_ROUND(13) GST_ROUND(15) GST_ROUND(26) GST_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  GST_ROUND(17) GST_ROUND(29) GST_ROUND(16) GST_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  GST_ROUND(13) GST_ROUND(15) GST_ROUND(26) GST_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  GST_ROUND(17) GST_ROUND(29) GST_ROUND(16) GST_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  GST_ROUND(13) GST_ROUND(15) GST_ROUND(26) GST_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
}
#undef GST_ROUND

__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// fold_in(k, d): the key hashed with the pair (0, d), in place.
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// The 32 random bits of element `j` (a flat index below 2**32) under the
// key (k0, k1): `random_bits(k, shape)` at j.
__device__ __forceinline__ uint32_t random_bits(uint32_t k0, uint32_t k1,
                                                uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// u[0..COUNT) of uniform(fold_in(key, n), (m,)) for any m >= COUNT (an
// element's bits do not depend on m), the key's words (kw0, kw1).
template <int COUNT>
__device__ __forceinline__ void uniforms_at(uint32_t kw0, uint32_t kw1,
                                            uint32_t n, float* u) {
  uint32_t k0 = kw0, k1 = kw1;
  fold_in(k0, k1, n);
#pragma unroll
  for (int w = 0; w < COUNT; ++w)
    u[w] = to_uniform(random_bits(k0, k1, (uint32_t)w));
}

// The lane's key after fold_in(key, n) and, when SALTED, fold_in(., salt).
template <bool SALTED>
__device__ __forceinline__ void lane_key(const int64_t* __restrict__ key,
                                         const int32_t* __restrict__ n,
                                         uint32_t salt, int i, uint32_t& k0,
                                         uint32_t& k1) {
  k0 = (uint32_t)key[2 * i];
  k1 = (uint32_t)key[2 * i + 1];
  fold_in(k0, k1, (uint32_t)n[i]);
  if (SALTED) fold_in(k0, k1, salt);
}

}  // namespace gst
