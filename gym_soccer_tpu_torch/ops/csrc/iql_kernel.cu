// Independent-Q learner chunks for Hopper (sm_90a): kernels K8 and K9.
//
// Replaces the Pallas TPU kernels `_iql_packed_kernel` (K8, wrapper
// `iql_packed_chunk`) and `_iql_kernel` (K9, wrapper `iql_chunk`) of
// gym_soccer_tpu/ops/iql_kernel.py.  One template, `iql_kernel<kPacked>`,
// computes both; they differ only in the baseline a visit carries.
//
// What it computes, for every lane (one independent game) and step i:
// four murmur3 counter words keyed on (chunk seed, i + step_offset, word,
// global lane); the compact cellpair code cp of the state; both players'
// five Q values at cp (the table holds double-bf16 hi + lo, the values the
// JAX kernel acts on); each player's greedy action (a strict `>` scan from
// action 0, so the lowest index wins a tie) and max; the retirement of the
// PREVIOUS step, whose targets r + cont * max q_A(cp) and -r + cont *
// max q_B(cp) now have their bootstrap values; eps-greedy actions (A
// explores when the low 16 bits of word 0 are below eps_int and then takes
// the high 16 bits mod 5; B the same with word 3); the game transition and
// autoreset of K1 on words 1 and 2; cont = 0 on a goal or a truncation,
// else gamma.  After the last step a trailing retirement uses the maxes of
// the final (post-autoreset) state.  Per (cp, player, action) the kernel
// counts the visits and sums target - baseline, where the baseline is
// max q(s) for K8 (the Bellman residual; the host completes the TD with
// cnt * (max q - q) between chunks) and q(s, a) for K9 (the full TD).
//
// Exactness: the sums are int64 fixed point in units of 2^-32 (each value
// rounded once, to nearest), added with integer atomics, so they are the
// same in any order: the kernels equal their plain PyTorch versions bit
// for bit, for any block size, and a resumed training run equals an
// uninterrupted one.  They stay exact while every value lies within
// +-limit = 2^30 / (B * n_steps); each lane counts the values outside (or
// not finite) in a register and adds its count to stats[3] once, at the
// end, so the host need not read the table to know.  Every float operation is written with an explicit
// rounding intrinsic so that nvcc forms no FMA the plain version lacks.
//
// What bounds it on this card: the integer work of K1 (the transition and
// autoreset) plus a fourth counter word, ten table loads (40 B from L1/L2)
// and two five-way argmax scans per lane-step, and four global atomics
// (two 8-byte sums and two counts) on 10 x n_codes cells, which contend
// where many lanes sit in the same state.  The table is 44 KB on 5x4 and
// 545 KB on 11x7, the accumulators 133 KB and 1.6 MB: all L2-resident.
//
// What the design does about it: K5's shape.  One thread per lane, with
// the state and the pending retirement in registers and a loop over the
// steps; the table read through the read-only path (__ldg) by compact
// code, in place of the TPU's one-hot matmul gathers and scatters over
// packed rows (no GP_I = 6 row packing, no lane-block cap, no VMEM guard);
// atomics straight to L2.  Shared-memory privatisation, warp-aggregated
// atomics and latency hiding are left to later work.

#include "game.cuh"

using namespace gst;

namespace {

constexpr int kCols = 10;  // table and accumulator row: A's 5, then B's 5
constexpr float kFix = 4294967296.0f;  // 2^32: fixed-point scale

// Greedy action (strict > from action 0) and max of five Q values.
__device__ __forceinline__ int greedy(const float* q, float& best) {
  int a = 0;
  best = q[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    if (q[k] > best) {
      a = k;
      best = q[k];
    }
  }
  return a;
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

__device__ __forceinline__ void load_q(const float* __restrict__ table,
                                       int cp, float* qa, float* qb) {
  const float* row = table + (size_t)cp * kCols;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    qa[k] = __ldg(row + k);
    qb[k] = __ldg(row + 5 + k);
  }
}

template <bool kPacked>
__global__ void iql_kernel(Planes in, Planes out,
                           const float* __restrict__ table, long long* sums,
                           int* cnt, long long* stats, int B, int n_steps,
                           uint32_t seed, int eps_int, int step_offset,
                           float gamma, float limit, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0, out_of_range = 0;
  if (lane < B) {
    const int nc = n_cells(g);
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[5][lane]};
    const uint32_t ctr = (uint32_t)lane;
    float qa[5], qb[5];
    // the pending retirement: A's and B's cells, reward, continuation and
    // baselines (max q for K8, q(s, a) for K9)
    int p_a = -1, p_b = -1;
    float p_r = 0.0f, p_cont = 0.0f, p_base_a = 0.0f, p_base_b = 0.0f;
    for (int i = 0; i < n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + step_offset);
      const uint32_t bits0 = random_word(seed, step, 0u, ctr);
      const uint32_t bits1 = random_word(seed, step, 1u, ctr);
      const uint32_t bits2 = random_word(seed, step, 2u, ctr);
      const uint32_t bits3 = random_word(seed, step, 3u, ctr);
      const int cp = cellpair_encode(s, g, nc);
      load_q(table, cp, qa, qb);
      float va, vb;
      const int ga = greedy(qa, va);
      const int gb = greedy(qb, vb);
      if (p_a >= 0) {
        out_of_range +=
            retire(sums, cnt, p_a, p_r, p_cont, va, p_base_a, limit) +
            retire(sums, cnt, p_b, -p_r, p_cont, vb, p_base_b, limit);
      }
      const int aa = u16(bits0, 0) < eps_int ? u16(bits0, 1) % 5 : ga;
      const int ab = u16(bits3, 0) < eps_int ? u16(bits3, 1) % 5 : gb;
      bool goal, trunc;
      int r;
      transition(s, aa, ab, bits1, bits2, g, goal, r);
      autoreset(s, goal, bits2, g, trunc);

      p_a = cp * kCols + aa;
      p_b = cp * kCols + 5 + ab;
      p_r = (float)r;
      p_cont = (goal || trunc) ? 0.0f : gamma;
      p_base_a = kPacked ? va : qa[aa];
      p_base_b = kPacked ? vb : qb[ab];
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    if (p_a >= 0) {  // trailing retirement against the final state's maxes
      load_q(table, cellpair_encode(s, g, nc), qa, qb);
      float va, vb;
      greedy(qa, va);
      greedy(qb, vb);
      out_of_range +=
          retire(sums, cnt, p_a, p_r, p_cont, va, p_base_a, limit) +
          retire(sums, cnt, p_b, -p_r, p_cont, vb, p_base_b, limit);
    }
    if (out_of_range)
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + 3),
                (unsigned long long)out_of_range);
    out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
    out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
    out.f[4][lane] = s.p;  out.f[5][lane] = s.t;
  }
  block_sum(stats, rew, goals, truncs);
}

}  // namespace

extern "C" {

// K8 (packed != 0: residual sums) or K9 (packed == 0: TD sums).
// device: the CUDA ordinal of every pointer and of the stream; in/out:
// host arrays of 6 device pointers to int32 [B]; table: device float32
// [n_codes, 10]; sums: device int64 [n_codes, 10] and cnt: device int32
// [n_codes, 10], both zeroed by the caller; stats: device int64 [4]
// (reward sum, goals, truncations, values outside +-limit), the fourth
// zeroed by the caller.
int gst_iql_chunk(int device, void* const* in, void* const* out,
                  const float* table, long long* sums, int* cnt,
                  long long* stats, const int32_t* params, int B, int n_steps,
                  uint32_t seed, int eps_int, int step_offset, float gamma,
                  float limit, int packed, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(device, params, B, threads, stats, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  if (packed) {
    iql_kernel<true><<<blocks, threads, 0, st>>>(
        make_planes(in), make_planes(out), table, sums, cnt, stats, B,
        n_steps, seed, eps_int, step_offset, gamma, limit, make_game(params));
  } else {
    iql_kernel<false><<<blocks, threads, 0, st>>>(
        make_planes(in), make_planes(out), table, sums, cnt, stats, B,
        n_steps, seed, eps_int, step_offset, gamma, limit, make_game(params));
  }
  return (int)cudaGetLastError();
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
