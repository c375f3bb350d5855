// Minimax-Q learner chunks for Hopper (sm_90a): kernels K5, K6 and K7.
//
// Replaces four Pallas TPU call sites of gym_soccer_tpu/ops/
// learner_kernel.py, one body each side:
//   learner_kernel<true, false>   <- `_packed_kernel` (K5, wrapper
//                                    `packed_learner_chunk`)
//   learner_kernel<true, true>    <- `_mg_packed_kernel` (K6, wrapper
//                                    `multigrid_packed_learner_chunk`)
//   learner_kernel<false, false>  <- `_learner_kernel` (K7, wrapper
//                                    `learner_chunk`)
//   learner_kernel<false, true>   <- `_mg_learner_kernel` (K7, wrapper
//                                    `multigrid_learner_chunk`)
// The JAX package serves all four from `_packed_body` / `_learner_body`,
// whose only switches are the accumulation layout and `planes is None`;
// here they are the two template flags.
//
// What it computes, for every lane (one independent game) and step i:
// three murmur3 counter words keyed on (chunk seed, i, word, global lane);
// the compact cellpair code cp of the state, plus, with kMulti, the lane's
// row offset into the variants' concatenated tables; the lane's 10
// exploration-mixed policy values and v at cp; the retirement of the
// PREVIOUS step, whose target r + cont * v(cp) now has its bootstrap
// value; actions sampled by first exceedance over the five pi values of
// each player (A from the low 16 bits of word 0, B from the high 16);
// the game transition and autoreset of K1 (kMulti: of K3, on the lane's
// own board); cont = 0 on a goal or a truncation, else gamma.  After the
// last step a trailing retirement uses v of the final (post-autoreset)
// state.  Per (cp, joint action) the kernel counts the visits and sums
// target - baseline, where the baseline is v(s) for the packed layout
// (kPacked: the Bellman residual; the host completes the TD sums with
// cnt * (v - q) between chunks) and q(s, a) for the unpacked one (the full
// TD).  Both step the same trajectories for the same policy columns.
//
// Table rows: pi_a[5], pi_b[5], v (11 columns), and with !kPacked q[25]
// after them (36 columns), all float32, v and q exact.
//
// Exactness: the sums are int64 fixed point in units of 2^-32 (each value
// rounded once, to nearest), added with integer atomics, so the sums are
// the same in any order: the kernels equal their plain PyTorch versions
// bit for bit, for any block size, and a training run resumed from a
// checkpoint equals an uninterrupted one.  They stay exact while every
// table value read (v, and q(s, a) when unpacked) lies within +-limit =
// 2^29 / (B * n_steps) (ops/learner_kernel.py `value_limit`); each lane
// counts the values outside (or not finite) in a register and adds its
// count to stats[3] once, at the end.  Every float operation is written
// with an explicit rounding intrinsic so that nvcc cannot contract
// r + cont * v into an FMA, which the plain version does not do.
//
// What bounds it on this card: the integer work of K1 (about 200 SASS
// instructions per lane-step) plus, per lane-step, two table reads (pi
// rows and v, 44 B, and q(s, a) when unpacked, from L1/L2) and two global
// atomics (an 8-byte sum and a 4-byte count) on 25 x n_codes cells, which
// contend where many lanes sit in the same state: the initial states right
// after resets.  The 5x4 tables are 48 KB packed and 159 KB unpacked, the
// accumulators 331 KB; all of it stays in the 50 MB L2.
//
// What the design does about it: one thread per lane with the state, its
// board (kMulti) and the pending retirement in registers and a loop over
// the steps (K1's shape); the table is indexed directly by compact code
// and read through the read-only path (__ldg), in place of the TPU's
// one-hot matmul gathers and scatters over packed rows; atomics go straight
// to L2.  There is no VMEM budget to guard: any grid and any mixture runs.
// Shared-memory privatisation of hot cells, warp-aggregated atomics and
// latency hiding are left to later work.

#include "game.cuh"

using namespace gst;

namespace {

constexpr int kColV = 10;  // v after pi_a[5], pi_b[5]
constexpr int kColQ = 11;  // q[25] after v (unpacked rows only)
constexpr int kNJ = 25;    // joint actions
constexpr float kFix = 4294967296.0f;  // 2^32: fixed-point scale

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

// Add one visit's (r + cont * v_next) - base to cell idx.
__device__ __forceinline__ void retire(long long* sums, int* cnt, int idx,
                                       float r, float cont, float v_next,
                                       float base) {
  const float delta = __fsub_rn(__fadd_rn(r, __fmul_rn(cont, v_next)), base);
  const long long fixed = __float2ll_rn(__fmul_rn(delta, kFix));
  atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
            (unsigned long long)fixed);
  atomicAdd(cnt + idx, 1);
}

// 1 if a table value lies outside +-limit or is not finite, else 0.
__device__ __forceinline__ int out_of(float x, float limit) {
  return !(fabsf(x) <= limit);
}

// The step loop of one lane on board g, whose rows start at row cpo of the
// table.  Adds the lane's stats to rew, goals, truncs and its count of
// out-of-range table values to out_of_range.
template <bool kPacked, class G>
__device__ __forceinline__ void learn_lane(
    State& s, const G& g, int cpo, int lane, const float* __restrict__ table,
    long long* sums, int* cnt, int n_steps, uint32_t seed, float gamma,
    float limit, int& rew, int& goals, int& truncs, int& out_of_range) {
  constexpr int kCols = kPacked ? kColQ : kColQ + kNJ;
  const int nc = n_cells(g);
  const uint32_t ctr = (uint32_t)lane;
  // the pending retirement: cell index, reward, continuation, baseline
  // (v(s) packed, q(s, a) unpacked)
  int p_idx = -1;
  float p_r = 0.0f, p_cont = 0.0f, p_base = 0.0f;
  for (int i = 0; i < n_steps; ++i) {
    const uint32_t bits0 = random_word(seed, (uint32_t)i, 0u, ctr);
    const uint32_t bits1 = random_word(seed, (uint32_t)i, 1u, ctr);
    const uint32_t bits2 = random_word(seed, (uint32_t)i, 2u, ctr);
    const int cp = cellpair_encode(s, g, nc) + cpo;
    const float* row = table + (size_t)cp * kCols;
    const float v_here = __ldg(row + kColV);
    out_of_range += out_of(v_here, limit);
    if (p_idx >= 0) retire(sums, cnt, p_idx, p_r, p_cont, v_here, p_base);

    // u16 / 65536 is exact in float32
    const float ua = (float)u16(bits0, 0) * (1.0f / 65536.0f);
    const float ub = (float)u16(bits0, 1) * (1.0f / 65536.0f);
    const int aa = sample5(row, ua);
    const int ab = sample5(row + 5, ub);
    bool goal, trunc;
    int r;
    transition(s, aa, ab, bits1, bits2, g, goal, r);
    autoreset(s, goal, bits2, g, trunc);

    const int ja = aa * 5 + ab;
    p_idx = cp * kNJ + ja;
    p_r = (float)r;
    p_cont = (goal || trunc) ? 0.0f : gamma;
    if constexpr (kPacked) {
      p_base = v_here;
    } else {
      p_base = __ldg(row + kColQ + ja);
      out_of_range += out_of(p_base, limit);
    }
    rew += r;
    goals += goal;
    truncs += trunc;
  }
  if (p_idx >= 0) {  // trailing retirement against the final state's v
    const int cp = cellpair_encode(s, g, nc) + cpo;
    const float v_end = __ldg(table + (size_t)cp * kCols + kColV);
    out_of_range += out_of(v_end, limit);
    retire(sums, cnt, p_idx, p_r, p_cont, v_end, p_base);
  }
}

// geo (kMulti only): the planes H, W, glo, ghi, q_int and the lane's row
// offset; g: the shared board (!kMulti) or just max_steps (kMulti).
template <bool kPacked, bool kMulti>
__global__ void learner_kernel(Planes in, Planes out, Planes geo,
                               const float* __restrict__ table,
                               long long* sums, int* cnt, long long* stats,
                               int B, int n_steps, uint32_t seed,
                               float gamma, float limit, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0, out_of_range = 0;
  if (lane < B) {
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[5][lane]};
    if constexpr (kMulti) {
      learn_lane<kPacked>(s, lane_game(geo, lane, g.max_steps),
                          geo.f[5][lane], lane, table, sums, cnt, n_steps,
                          seed, gamma, limit, rew, goals, truncs,
                          out_of_range);
    } else {
      learn_lane<kPacked>(s, g, 0, lane, table, sums, cnt, n_steps, seed,
                          gamma, limit, rew, goals, truncs, out_of_range);
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

template <bool kPacked, bool kMulti>
int launch(int device, void* const* in, void* const* out, void* const* geo,
           const float* table, long long* sums, int* cnt, long long* stats,
           const int32_t* params, int B, int n_steps, uint32_t seed,
           float gamma, float limit, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Game g{};
  Planes gp{};
  cudaError_t e;
  if constexpr (kMulti) {
    e = check_launch(device, B, threads);
    g.max_steps = params[0];
    gp = make_planes(geo);
  } else {
    e = prepare(device, params, B, threads, stats, st);
    g = make_game(params);
  }
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  learner_kernel<kPacked, kMulti><<<blocks, threads, 0, st>>>(
      make_planes(in), make_planes(out), gp, table, sums, cnt, stats, B,
      n_steps, seed, gamma, limit, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: device: the CUDA ordinal of every pointer and of the
// stream; in/out: host arrays of 6 device pointers to int32 [B]; geo: host
// array of 6 device pointers to int32 [B] (H, W, glo, ghi, q_int, row
// offset; multigrid entries only, else ignored); table: device float32
// [n_codes, 11] (packed) or [n_codes, 36] (unpacked); sums: device int64
// [n_codes, 25] and cnt: device int32 [n_codes, 25], both zeroed by the
// caller; stats: device int64 [4] (reward sum, goals, truncations, table
// values outside +-limit), zeroed by the caller; params: the game
// description (make_game), or for the multigrid entries {max_steps}.
#define GST_LEARNER_ENTRY(name, kPacked, kMulti)                            \
  int name(int device, void* const* in, void* const* out, void* const* geo, \
           const float* table, long long* sums, int* cnt, long long* stats, \
           const int32_t* params, int B, int n_steps, uint32_t seed,        \
           float gamma, float limit, int threads, void* stream) {           \
    return launch<kPacked, kMulti>(device, in, out, geo, table, sums, cnt,  \
                                   stats, params, B, n_steps, seed, gamma,  \
                                   limit, threads, stream);                 \
  }

GST_LEARNER_ENTRY(gst_packed_learner_chunk, true, false)           // K5
GST_LEARNER_ENTRY(gst_multigrid_packed_learner_chunk, true, true)  // K6
GST_LEARNER_ENTRY(gst_learner_chunk, false, false)                 // K7
GST_LEARNER_ENTRY(gst_multigrid_learner_chunk, false, true)        // K7 mg

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
