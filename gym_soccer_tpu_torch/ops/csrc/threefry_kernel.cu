// Per-lane threefry uniforms for Hopper (sm_90a): kernel T1, with its keyed
// entry for draws from one key.
//
// It has no Pallas counterpart: the JAX package draws these with XLA's
// threefry under `batch.per_env_uniforms(state, count, salt)`
// (gym_soccer_tpu/core/batch.py, rng="threefry", its default) and under
// `jax.random.uniform` / `randint` of `fold_in(key, i)` (its examples'
// policies), and the port's plain versions (ops/threefry_kernel.py) compose
// core/threefry's functions.  The engines' own steps draw inside kernels
// S1 (engine_kernel.cu), S2 and S3 (mixed_alt_kernel.cu); T1 draws for the
// learners' salted action draws, the engines' initial resets and the
// policies' per-lane draws (`random_rollout_stats`', the mixed-geometry
// rollouts').  As PyTorch ops a threefry block
// is ~100 elementwise launches.
//
// What `threefry_uniforms_kernel` computes, one thread a lane i, all in
// registers (threefry.cuh):
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
// The keyed entry (`keyed_kernel<RANDINT>`), one thread an output element
// j of a flat shape, from one key [2] in device memory and a host index i:
//   k = fold_in(key, i)
//   uniform:  out[j] = to_uniform(random_bits(k, j))
//   randint:  (k0, k1) = split(k); hi = random_bits(k0, j),
//             lo = random_bits(k1, j);
//             out[j] = minval + ((hi % span) * mult + lo % span) % span
// with the span and multiplier of `jax.random.randint` from the host, all
// in uint32 arithmetic.  Each element repeats the fold_in (and the split):
// a draw of 2 x 1024 elements is one launch either way.  Builds that took
// 2 to 8 elements a thread with one fold_in, or 32 to 128 threads a block,
// were no faster on an H100 (PERF.md, the keyed entry's row): a thread's
// chain (the key's load, 40 rounds, the store) does not shorten, and each
// extra element adds its rounds to it.
//
// What bounds it: integer ALU work, 1 + (salt != 0) + count blocks of 20
// rounds (an add, a rotate and a xor each) and 6 key injections; per lane
// it reads 20 B and writes 4 * count B.  Counts 1 to 4 and both salt cases
// are instantiated with their loops unrolled; other counts loop.  At the
// callers' sizes a launch's floor bounds every call.
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using gst::fold_in;
using gst::lane_key;
using gst::random_bits;
using gst::threefry2x32;
using gst::to_uniform;

constexpr int kThreads = 256;   // lanes (or elements) a block

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
  for (int j = 0; j < (COUNT > 0 ? COUNT : c); ++j)
    o[j] = to_uniform(random_bits(k0, k1, (uint32_t)j));
}

// The keyed entry: element j of `uniform(fold_in(key, i), shape)` (float32
// into `out`) or of `randint(fold_in(key, i), shape, minval, maxval)`
// (int32), `numel` elements.  key: device int64 [2] (uint32 words).
template <bool RANDINT>
__global__ void __launch_bounds__(kThreads)
keyed_kernel(const int64_t* __restrict__ key, uint32_t i, int numel,
             uint32_t minval, uint32_t span, uint32_t mult,
             void* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= numel) return;
  uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  fold_in(k0, k1, i);
  if (!RANDINT) {
    static_cast<float*>(out)[j] = to_uniform(random_bits(k0, k1, j));
    return;
  }
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;   // split(k): keys 0 and 1
  threefry2x32(k0, k1, a0, a1);
  threefry2x32(k0, k1, b0, b1);
  const uint32_t higher = random_bits(a0, a1, j);
  const uint32_t lower = random_bits(b0, b1, j);
  const uint32_t offset = ((higher % span) * mult + lower % span) % span;
  static_cast<int32_t*>(out)[j] = (int32_t)(minval + offset);
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

// T1's keyed entry.  key: device int64 [2] (uint32 words); i: the index
// folded in; out: device float32 [numel] (randint == 0) or int32 [numel]
// (randint == 1, with minval as uint32 bits, span >= 1 and the multiplier
// 2**32 mod span, both from the host).  Launches on `stream` and returns
// its cudaError_t; numel == 0 launches nothing.
int gst_threefry_keyed(int device, const int64_t* key, uint32_t i, int numel,
                       int randint, uint32_t minval, uint32_t span,
                       uint32_t mult, void* out, void* stream) {
  if (numel < 0 || span == 0u) return (int)cudaErrorInvalidValue;
  if (numel == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (numel + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (randint)
    keyed_kernel<true><<<blocks, kThreads, 0, s>>>(key, i, numel, minval,
                                                   span, mult, out);
  else
    keyed_kernel<false><<<blocks, kThreads, 0, s>>>(key, i, numel, minval,
                                                    span, mult, out);
  return (int)cudaGetLastError();
}

// Lanes a block, for chip_smoke.py's design line.
int gst_threefry_block() { return kThreads; }

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
