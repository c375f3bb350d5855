// Per-lane threefry uniforms for Hopper (sm_90a): kernel T1.
//
// It has no Pallas counterpart: the JAX package draws these with XLA's
// threefry under `batch.per_env_uniforms(state, count, salt)`
// (gym_soccer_tpu/core/batch.py, rng="threefry", its default), and the
// port's plain version (ops/threefry_kernel.py `threefry_uniforms_plain`)
// composes core/threefry's functions.  Every step of every threefry path
// (the batched engine, the HBM-table learners, SoccerVectorEnv, the
// mixed-geometry and alternating engines) draws this; as PyTorch ops it is
// ~100 elementwise launches a threefry block.
//
// What it computes, one thread a lane i, all in registers:
//   k = threefry2x32(key_i, (0, n_i))                 fold_in(key_i, n_i)
//   k = threefry2x32(k, (0, salt))    if salt != 0    fold_in(k, salt)
//   for j < count:
//     (y0, y1) = threefry2x32(k, (0, j))              random_bits(k, (count,))
//     out[i, j] = float((y0 ^ y1) >> 9 | 0x3F800000) - 1.0f
// key: int64 [B, 2] holding uint32 words; n: int32 [B] (a draw counter,
// taken as uint32); out: float32 [B, count].  The subtraction is exact
// (the float lies in [1, 2)), so the result equals the plain version's bit
// for bit.
//
// What bounds it: integer ALU work, 1 + (salt != 0) + count blocks of 20
// rounds (an add, a rotate and a xor each) and 6 key injections; per lane
// it reads 20 B and writes 4 * count B.  Counts 1 to 4 and both salt cases
// are instantiated with their loops unrolled; other counts loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // lanes a block
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

// The lane's key after fold_in(key, n) and, when SALTED, fold_in(., salt).
template <bool SALTED>
__device__ __forceinline__ void lane_key(const int64_t* __restrict__ key,
                                         const int32_t* __restrict__ n,
                                         uint32_t salt, int i, uint32_t& k0,
                                         uint32_t& k1) {
  uint32_t x0 = 0u, x1 = (uint32_t)n[i];
  threefry2x32((uint32_t)key[2 * i], (uint32_t)key[2 * i + 1], x0, x1);
  if (SALTED) {
    k0 = 0u;
    k1 = salt;
    threefry2x32(x0, x1, k0, k1);
  } else {
    k0 = x0;
    k1 = x1;
  }
}

// COUNT > 0: that many uniforms, unrolled; COUNT == 0: `count` of them.
template <int COUNT, bool SALTED>
__global__ void __launch_bounds__(kThreads)
threefry_uniforms_kernel(const int64_t* __restrict__ key,
                         const int32_t* __restrict__ n, int lanes, int count,
                         uint32_t salt, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= lanes) return;
  uint32_t k0, k1;
  lane_key<SALTED>(key, n, salt, i, k0, k1);
  const int c = COUNT > 0 ? COUNT : count;
  float* o = out + (size_t)i * c;
#pragma unroll
  for (int j = 0; j < (COUNT > 0 ? COUNT : c); ++j) {
    uint32_t x0 = 0u, x1 = (uint32_t)j;
    threefry2x32(k0, k1, x0, x1);
    o[j] = to_uniform(x0 ^ x1);
  }
}

template <int COUNT>
void launch(bool salted, int blocks, cudaStream_t s, const int64_t* key,
            const int32_t* n, int lanes, int count, uint32_t salt,
            float* out) {
  if (salted)
    threefry_uniforms_kernel<COUNT, true><<<blocks, kThreads, 0, s>>>(
        key, n, lanes, count, salt, out);
  else
    threefry_uniforms_kernel<COUNT, false><<<blocks, kThreads, 0, s>>>(
        key, n, lanes, count, salt, out);
}

}  // namespace

extern "C" {

// T1.  key: device int64 [lanes, 2] (uint32 words), n: device int32
// [lanes], out: device float32 [lanes, count], all contiguous; count >= 1;
// salt: a uint32 (0 = no second fold_in).  Launches on `stream` and
// returns its cudaError_t (0 on success); lanes == 0 launches nothing.
int gst_threefry_uniforms(int device, const int64_t* key, const int32_t* n,
                          int lanes, int count, uint32_t salt, float* out,
                          void* stream) {
  if (lanes < 0 || count < 1) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool salted = salt != 0u;
  switch (count) {
    case 1: launch<1>(salted, blocks, s, key, n, lanes, count, salt, out); break;
    case 2: launch<2>(salted, blocks, s, key, n, lanes, count, salt, out); break;
    case 3: launch<3>(salted, blocks, s, key, n, lanes, count, salt, out); break;
    case 4: launch<4>(salted, blocks, s, key, n, lanes, count, salt, out); break;
    default: launch<0>(salted, blocks, s, key, n, lanes, count, salt, out);
  }
  return (int)cudaGetLastError();
}

// Lanes a block, for chip_smoke.py's design line.
int gst_threefry_block() { return kThreads; }

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
