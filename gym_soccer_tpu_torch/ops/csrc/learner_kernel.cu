// Packed minimax-Q learner chunk for Hopper (sm_90a): kernel K5.
//
// Replaces the Pallas TPU kernel `_packed_kernel` (body `_packed_body`) of
// gym_soccer_tpu/ops/learner_kernel.py, wrapper `packed_learner_chunk`.
//
// What it computes, for every lane (one independent game) and step i:
// three murmur3 counter words keyed on (chunk seed, i, word, global lane);
// the compact cellpair code cp of the state; the lane's 10 exploration-mixed
// policy values and v at cp; the retirement of the PREVIOUS step, whose
// Bellman residual r + cont * v(cp) - v(cp_prev) now has its bootstrap
// value; actions sampled by first exceedance over the five pi values of
// each player (A from the low 16 bits of word 0, B from the high 16);
// the game transition and autoreset of K1; cont = 0 on a goal or a
// truncation, else gamma.  After the last step a trailing retirement uses
// v of the final (post-autoreset) state.  Per (cp, joint action) the
// kernel sums the residuals and counts the visits; the host completes the
// TD sums with cnt * (v - q) between chunks (ops/learner_kernel.py).
//
// Exactness: the residual sums are int64 fixed point in units of 2^-32
// (each residual rounded once, to nearest), added with integer atomics, so
// the sums are the same in any order: the kernel equals its plain PyTorch
// version bit for bit, for any block size, and a training run resumed
// from a checkpoint equals an uninterrupted one.  Every float operation is
// written with an explicit rounding intrinsic so that nvcc cannot contract
// r + cont * v into an FMA, which the plain version does not do.
//
// What bounds it on this card: the integer work of K1 (about 290 SASS
// instructions per lane-step) plus, per lane-step, two table reads (pi
// rows and v, 44 B, from L1/L2) and two global atomics (an 8-byte residual
// and a 4-byte count) on 25 x n_codes cells, which contend where many
// lanes sit in the same state: the initial states right after resets.
// The table is 48 KB on 5x4 and 599 KB on 11x7; the accumulators are
// 331 KB and 4.1 MB.  All of it stays in the 50 MB L2.
//
// What the design does about it: one thread per lane with the state and
// the pending retirement in registers and a loop over the steps (K1's
// shape); the table is indexed directly by compact code and read through
// the read-only path (__ldg), in place of the TPU's one-hot matmul
// gathers and scatters over packed rows; atomics go straight to L2.
// Shared-memory privatisation of hot cells, warp-aggregated atomics and
// latency hiding are left to later work.

#include "game.cuh"

using namespace gst;

namespace {

constexpr int kCols = 11;  // table row: pi_a[5], pi_b[5], v
constexpr int kColV = 10;
constexpr int kNJ = 25;    // joint actions
constexpr float kFix = 4294967296.0f;  // 2^32: residual fixed-point scale

// First exceedance of u * total over the running sums of five
// probabilities, summed in index order (learner_kernel.py `sample5`).
__device__ __forceinline__ int sample5(const float* __restrict__ pi,
                                       float u) {
  float c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) c[k] = __ldg(pi + k);
  float total = c[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) total = __fadd_rn(total, c[k]);
  const float target = __fmul_rn(u, total);
  int a = 0;
  float s = c[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    a += s <= target;
    s = __fadd_rn(s, c[k]);
  }
  return a;
}

// Add one visit's residual (r + cont * v_next) - v_prev to cell idx.
__device__ __forceinline__ void retire(long long* res, int* cnt, int idx,
                                       float r, float cont, float v_next,
                                       float v_prev) {
  const float delta = __fsub_rn(__fadd_rn(r, __fmul_rn(cont, v_next)),
                                v_prev);
  const long long fixed = __float2ll_rn(__fmul_rn(delta, kFix));
  atomicAdd(reinterpret_cast<unsigned long long*>(res + idx),
            (unsigned long long)fixed);
  atomicAdd(cnt + idx, 1);
}

__global__ void learner_kernel(Planes in, Planes out,
                               const float* __restrict__ table,
                               long long* res, int* cnt, long long* stats,
                               int B, int n_steps, uint32_t seed,
                               float gamma, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0;
  if (lane < B) {
    const int nc = n_cells(g);
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[5][lane]};
    const uint32_t ctr = (uint32_t)lane;
    // the pending retirement: cell index, reward, continuation, v(s)
    int p_idx = -1;
    float p_r = 0.0f, p_cont = 0.0f, p_v = 0.0f;
    for (int i = 0; i < n_steps; ++i) {
      const uint32_t bits0 = random_word(seed, (uint32_t)i, 0u, ctr);
      const uint32_t bits1 = random_word(seed, (uint32_t)i, 1u, ctr);
      const uint32_t bits2 = random_word(seed, (uint32_t)i, 2u, ctr);
      const int cp = cellpair_encode(s, g, nc);
      const float* row = table + (size_t)cp * kCols;
      const float v_here = __ldg(row + kColV);
      if (p_idx >= 0) retire(res, cnt, p_idx, p_r, p_cont, v_here, p_v);

      // u16 / 65536 is exact in float32
      const float ua = (float)u16(bits0, 0) * (1.0f / 65536.0f);
      const float ub = (float)u16(bits0, 1) * (1.0f / 65536.0f);
      const int aa = sample5(row, ua);
      const int ab = sample5(row + 5, ub);
      bool goal, trunc;
      int r;
      transition(s, aa, ab, bits1, bits2, g, goal, r);
      autoreset(s, goal, bits2, g, trunc);

      p_idx = cp * kNJ + aa * 5 + ab;
      p_r = (float)r;
      p_cont = (goal || trunc) ? 0.0f : gamma;
      p_v = v_here;
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    if (p_idx >= 0) {  // trailing retirement against the final state's v
      const int cp = cellpair_encode(s, g, nc);
      retire(res, cnt, p_idx, p_r, p_cont,
             __ldg(table + (size_t)cp * kCols + kColV), p_v);
    }
    out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
    out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
    out.f[4][lane] = s.p;  out.f[5][lane] = s.t;
  }
  block_sum(stats, rew, goals, truncs);
}

}  // namespace

extern "C" {

// K5.  device: the CUDA ordinal of every pointer and of the stream;
// in/out: host arrays of 6 device pointers to int32 [B];
// table: device float32 [n_codes, 11]; res: device int64 [n_codes, 25]
// and cnt: device int32 [n_codes, 25], both zeroed by the caller;
// stats: device int64 [3] (reward sum, goals, truncations).
int gst_packed_learner_chunk(int device, void* const* in, void* const* out,
                             const float* table, long long* res, int* cnt,
                             long long* stats, const int32_t* params, int B,
                             int n_steps, uint32_t seed, float gamma,
                             int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(device, params, B, threads, stats, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  learner_kernel<<<blocks, threads, 0, st>>>(
      make_planes(in), make_planes(out), table, res, cnt, stats, B, n_steps,
      seed, gamma, make_game(params));
  return (int)cudaGetLastError();
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
