// Alternating-turn Q learner chunks for Hopper (sm_90a): kernels K10 and
// K11.
//
// Replaces the Pallas TPU kernels `_altq_packed_kernel` (K10, wrapper
// `altq_packed_chunk`) and `_altq_kernel` (K11, wrapper `altq_chunk`) of
// gym_soccer_tpu/ops/altq_kernel.py.  One template, `altq_kernel<kPacked>`,
// computes both; they differ only in the baseline a visit carries.
//
// What it computes, for every lane (one independent game) and step i:
// three murmur3 counter words keyed on (chunk seed, i + step_offset, word,
// global lane); the compact cellpair code cp of the state, which does not
// hold the turn; the mover's five Q values at (cp, turn), where the table
// row cp holds A-to-move values in columns 0-4 and B-to-move values in
// 5-9, each the JAX package's double-bf16 hi + lo (the values its kernel
// acts on); V = max of them when A moves, min when B moves (the table is
// A-perspective); the retirement of the PREVIOUS step, whose target r +
// cont * V now has its bootstrap value; the mover's eps-greedy action
// (explore when the low 16 bits of word 0 are below eps_int, then take
// the high 16 bits mod 5; else greedy on sgn * q with sgn = +1 for A and
// -1 for B, a strict `>` scan from action 0, so the lowest index wins a
// tie for either player); game.cuh's `alt_transition` on word 1 and the
// autoreset on word 2; cont = 0 on a goal or a truncation, else gamma; the
// turn flips, or goes to A on a goal or a truncation.  After the last step
// a trailing retirement uses V of the final (post-autoreset) state.  Per
// (cp, turn, action) of the mover the kernel counts the visits and sums
// target - baseline, where the baseline is V(s) for K10 (the Bellman
// residual; the host completes the TD with cnt * (V - q) between chunks)
// and q(s, a) for K11 (the full TD).
//
// Exactness: the sums are int64 fixed point in units of 2^-32, added with
// integer atomics, so they are the same in any order: the kernels equal
// their plain PyTorch versions bit for bit for any block size, and a
// resumed training run equals an uninterrupted one.  They stay exact while
// every value lies within +-limit = 2^30 / (B * n_steps); each lane counts
// the values outside (or not finite) in a register and adds its count to
// stats[3] once.  Every float operation is written with an explicit
// rounding intrinsic so that nvcc forms no FMA the plain version lacks;
// max and min propagate NaN, as torch.maximum/minimum and JAX's do.
//
// What bounds it on this card: the integer work of K4 (the counter words,
// the one-mover transition and the autoreset), five table loads (20 B from
// L1/L2) and one five-way scan per lane-step, and two global atomics (one
// 8-byte sum, one count) on 10 x n_codes cells.  Only the mover learns, so
// a step adds half of K8's atomics.  The table is 44 KB on 5x4 and 545 KB
// on 11x7, the accumulators 133 KB and 1.6 MB: all L2-resident.
//
// What the design does about it: K8's shape.  One thread per lane, with the
// state and the pending retirement in registers and a loop over the steps;
// the table read through the read-only path (__ldg) by cp * 10 + turn * 5
// + a, in place of the TPU's one-hot matmul gathers and scatters over
// packed rows (no GP_T = 6 row packing, no bf16 hi/lo columns, no VMEM
// guard); atomics straight to L2.

#include "game.cuh"

using namespace gst;

namespace {

constexpr int kCols = 10;  // table and accumulator row: A-to-move 5, B 5
constexpr float kFix = 4294967296.0f;  // 2^32: fixed-point scale

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// The mover's five Q values at (cp, turn) and their V: max for A (turn 0),
// min for B.
__device__ __forceinline__ float mover_q(const float* __restrict__ table,
                                         int base, int turn, float* q) {
  q[0] = __ldg(table + base);
  float vmax = q[0], vmin = q[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    q[k] = __ldg(table + base + k);
    vmax = max_nan(vmax, q[k]);
    vmin = min_nan(vmin, q[k]);
  }
  return turn == 0 ? vmax : vmin;
}

// Add one visit's (r + cont * v_next) - base to cell idx; return 1 if it
// lies outside +-limit or is not finite, else 0.
__device__ __forceinline__ int retire(long long* sums, int* cnt, int idx,
                                      float r, float cont, float v_next,
                                      float base, float limit) {
  const float delta = __fsub_rn(__fadd_rn(r, __fmul_rn(cont, v_next)), base);
  const long long fixed = __float2ll_rn(__fmul_rn(delta, kFix));
  atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
            (unsigned long long)fixed);
  atomicAdd(cnt + idx, 1);
  return !(fabsf(delta) <= limit);
}

template <bool kPacked>
__global__ void altq_kernel(AltPlanes in, AltPlanes out,
                            const float* __restrict__ table, long long* sums,
                            int* cnt, long long* stats, int B, int n_steps,
                            uint32_t seed, int eps_int, int step_offset,
                            float gamma, float limit, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0, out_of_range = 0;
  if (lane < B) {
    const int nc = n_cells(g);
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[6][lane]};
    int turn = in.f[5][lane];
    const uint32_t ctr = (uint32_t)lane;
    float q[5];
    // the pending retirement: its cell, reward, continuation and baseline
    // (V(s) for K10, q(s, a) for K11)
    int p_idx = -1;
    float p_r = 0.0f, p_cont = 0.0f, p_base = 0.0f;
    for (int i = 0; i < n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + step_offset);
      const uint32_t bits0 = random_word(seed, step, 0u, ctr);
      const uint32_t bits1 = random_word(seed, step, 1u, ctr);
      const uint32_t bits2 = random_word(seed, step, 2u, ctr);
      const int base = cellpair_encode(s, g, nc) * kCols + turn * 5;
      const float v = mover_q(table, base, turn, q);
      if (p_idx >= 0)
        out_of_range +=
            retire(sums, cnt, p_idx, p_r, p_cont, v, p_base, limit);
      // greedy on sgn * q: A maximises, B minimises, lowest index on a tie
      const float sgn = turn == 0 ? 1.0f : -1.0f;
      int best = 0;
      float bestv = __fmul_rn(sgn, q[0]);
#pragma unroll
      for (int k = 1; k < 5; ++k) {
        const float sc = __fmul_rn(sgn, q[k]);
        if (sc > bestv) best = k;
        bestv = max_nan(bestv, sc);
      }
      const int a = u16(bits0, 0) < eps_int ? u16(bits0, 1) % 5 : best;
      bool goal, trunc;
      int r;
      alt_transition(s, turn, a, bits1, g, goal, r);
      autoreset(s, goal, bits2, g, trunc);
      const bool term = goal || trunc;

      p_idx = base + a;
      p_r = (float)r;
      p_cont = term ? 0.0f : gamma;
      p_base = kPacked ? v : q[a];
      turn = term ? 0 : 1 - turn;
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    if (p_idx >= 0) {  // trailing retirement against the final state's V
      const int base = cellpair_encode(s, g, nc) * kCols + turn * 5;
      const float v = mover_q(table, base, turn, q);
      out_of_range += retire(sums, cnt, p_idx, p_r, p_cont, v, p_base, limit);
    }
    if (out_of_range)
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + 3),
                (unsigned long long)out_of_range);
    out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
    out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
    out.f[4][lane] = s.p;  out.f[5][lane] = turn;
    out.f[6][lane] = s.t;
  }
  block_sum(stats, rew, goals, truncs);
}

}  // namespace

extern "C" {

// K10 (packed != 0: residual sums) or K11 (packed == 0: TD sums).
// device: the CUDA ordinal of every pointer and of the stream; in/out:
// host arrays of 7 device pointers to int32 [B] (ra, ca, rb, cb, p, turn,
// t); table: device float32 [n_codes, 10]; sums: device int64 [n_codes, 10]
// and cnt: device int32 [n_codes, 10], both zeroed by the caller; stats:
// device int64 [4] (reward sum, goals, truncations, values outside
// +-limit), the fourth zeroed by the caller.
int gst_altq_chunk(int device, void* const* in, void* const* out,
                   const float* table, long long* sums, int* cnt,
                   long long* stats, const int32_t* params, int B,
                   int n_steps, uint32_t seed, int eps_int, int step_offset,
                   float gamma, float limit, int packed, int threads,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(device, params, B, threads, stats, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  if (packed) {
    altq_kernel<true><<<blocks, threads, 0, st>>>(
        make_alt_planes(in), make_alt_planes(out), table, sums, cnt, stats,
        B, n_steps, seed, eps_int, step_offset, gamma, limit,
        make_game(params));
  } else {
    altq_kernel<false><<<blocks, threads, 0, st>>>(
        make_alt_planes(in), make_alt_planes(out), table, sums, cnt, stats,
        B, n_steps, seed, eps_int, step_offset, gamma, limit,
        make_game(params));
  }
  return (int)cudaGetLastError();
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
