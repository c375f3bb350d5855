// Fused random-vs-random rollout kernels for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of gym_soccer_tpu/ops/step_kernel.py:
//   rollout_kernel     <- `_rollout_kernel` (K1, wrapper `pallas_rollout`)
//   journal_kernel     <- `_journal_kernel` (K2, wrapper
//                         `pallas_journal_rollout`)
//   mg_rollout_kernel  <- `_mg_rollout_kernel` (K3, wrapper
//                         `pallas_multigrid_rollout`)
//   alt_rollout_kernel <- `_alt_rollout_kernel` (K4, wrapper
//                         `pallas_alt_rollout`)
//
// All compute, for every lane (one independent game) and every step:
// three murmur3 counter words keyed on (seed, absolute step, word index,
// global lane id), the random joint action, the slipped moves, the
// 4-priority collision chain, goal detection, truncation and the reset to
// an initial-state (ISD) entry, and the per-lane reward/goal/truncation
// sums.  journal_kernel also stores one packed int32 word per lane-step
// (bit layout in step_kernel.py's `_journal_word`).  mg_rollout_kernel
// steps a mixture of boards: each lane reads its own geometry (H, W, goal
// rows, slip) and variant id from planes, resets to its board's ISD
// computed arithmetically, and adds its sums into its variant's row of
// int64 [nV, 3] stats.  Every operation is
// integer arithmetic on uint32/int32, so the outputs are bit-identical to
// the JAX package and to the plain PyTorch versions in step_kernel.py.
//
// What bounds them on this card: integer ALU work, roughly 3 x murmur3
// (two 32-bit multiplies and six shift/xor each, twice per word) plus the
// collision chain, on the order of 200 integer instructions per
// lane-step, with no loads inside the step loop.  journal_kernel also
// writes 4 B per lane-step to device memory, which is two orders of
// magnitude below the card's bandwidth at any rate the ALUs reach.
//
// What the design does about it: one thread per lane with the whole state
// in registers and a loop over the steps, so nothing but the journal
// leaves the SM inside the loop; the journal store of step t goes to
// journal[t * B + lane], coalesced across the warp.  The per-lane sums are
// reduced with warp shuffles and one 64-bit atomicAdd per block (integer
// sums are exact in any order).  The counter keys on the global lane id,
// so any block size gives the same bits.  At 8192 lanes this launches only
// 64 blocks of 128 threads on 132 SMs; latency hiding and several lanes
// per thread are left to later work.  K3 keeps the lane's board in five
// more registers (game.cuh `LaneGame`, no ISD table) and sums its stats per
// variant in shared memory, then one atomicAdd per variant and counter per
// block, so nothing is added per step.
//
// K4 steps the alternating-turn game (envs/soccer_alternating_env): K1's
// shape and words, but one mover a tick (game.cuh `alt_transition`, about
// half of K1's transition work: no collision chain), its random action on
// the low 16 bits of word 0, and a seventh plane, the turn, which flips
// every tick and goes to A (0) on a goal or a truncation.

#include "game.cuh"

using namespace gst;

namespace {

// The step loop of one lane on board g; kJournal adds the journal store.
// Adds the lane's reward, goal and truncation sums to rew, goals, truncs.
template <bool kJournal, class G>
__device__ __forceinline__ void run_lane(State& s, int lane,
                                         int32_t* journal, int B,
                                         int n_steps, uint32_t seed,
                                         int step_offset, const G& g,
                                         int& rew, int& goals, int& truncs) {
  const uint32_t ctr = (uint32_t)lane;
  for (int i = 0; i < n_steps; ++i) {
    const uint32_t step = (uint32_t)(i + step_offset);
    const uint32_t bits0 = random_word(seed, step, 0u, ctr);
    const uint32_t bits1 = random_word(seed, step, 1u, ctr);
    const uint32_t bits2 = random_word(seed, step, 2u, ctr);
    const int aa = u16(bits0, 0) % 5;
    const int ab = u16(bits0, 1) % 5;
    bool goal, trunc;
    int r;
    transition(s, aa, ab, bits1, bits2, g, goal, r);
    // raw code of the pre-reset next state (rules.raw_encode)
    const int raw =
        (((s.ra * g.W + s.ca) * g.H + s.rb) * g.W + s.cb) * 2 + s.p;
    const int idx = autoreset(s, goal, bits2, g, trunc);
    if constexpr (kJournal) {
      journal[(size_t)i * (size_t)B + lane] =
          raw | ((aa * 5 + ab) << 16) | ((int)goal << 21) |
          ((int)trunc << 22) | ((int)(r == 1) << 23) | (idx << 24);
    }
    rew += r;
    goals += goal;
    truncs += trunc;
  }
}

__device__ __forceinline__ State load_state(const Planes& in, int lane) {
  return State{in.f[0][lane], in.f[1][lane], in.f[2][lane],
               in.f[3][lane], in.f[4][lane], in.f[5][lane]};
}

__device__ __forceinline__ void store_state(const Planes& out, int lane,
                                            const State& s) {
  out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
  out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
  out.f[4][lane] = s.p;  out.f[5][lane] = s.t;
}

template <bool kJournal>
__device__ __forceinline__ void run_static(const Planes& in, const Planes& out,
                                           long long* stats, int32_t* journal,
                                           int B, int n_steps, uint32_t seed,
                                           int step_offset, const Game& g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0;
  if (lane < B) {
    State s = load_state(in, lane);
    run_lane<kJournal>(s, lane, journal, B, n_steps, seed, step_offset, g,
                       rew, goals, truncs);
    store_state(out, lane, s);
  }
  block_sum(stats, rew, goals, truncs);
}

__global__ void rollout_kernel(Planes in, Planes out, long long* stats,
                               int B, int n_steps, uint32_t seed,
                               int step_offset, Game g) {
  run_static<false>(in, out, stats, nullptr, B, n_steps, seed, step_offset,
                    g);
}

__global__ void journal_kernel(Planes in, Planes out, long long* stats,
                               int32_t* journal, int B, int n_steps,
                               uint32_t seed, int step_offset, Game g) {
  run_static<true>(in, out, stats, journal, B, n_steps, seed, step_offset, g);
}

constexpr int kMaxVariants = 16;

// K3.  geo: the planes H, W, glo, ghi, q_int and the variant id;
// stats: int64 [n_variants, 3], zeroed by the caller.
__global__ void mg_rollout_kernel(Planes in, Planes out, Planes geo,
                                  long long* stats, int B, int n_steps,
                                  uint32_t seed, int step_offset,
                                  int max_steps, int n_variants) {
  __shared__ unsigned long long part[kMaxVariants * 3];
  for (int k = threadIdx.x; k < n_variants * 3; k += blockDim.x) part[k] = 0;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) {
    int rew = 0, goals = 0, truncs = 0;
    State s = load_state(in, lane);
    run_lane<false>(s, lane, nullptr, B, n_steps, seed, step_offset,
                    lane_game(geo, lane, max_steps), rew, goals, truncs);
    store_state(out, lane, s);
    unsigned long long* mine = part + 3 * geo.f[5][lane];
    atomicAdd(mine + 0, (unsigned long long)(long long)rew);
    atomicAdd(mine + 1, (unsigned long long)(long long)goals);
    atomicAdd(mine + 2, (unsigned long long)(long long)truncs);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_variants * 3; k += blockDim.x)
    if (part[k]) atomicAdd(reinterpret_cast<unsigned long long*>(stats + k),
                           part[k]);
}

// K4: random play of the alternating game (step_kernel._alt_step_once).
__global__ void alt_rollout_kernel(AltPlanes in, AltPlanes out,
                                   long long* stats, int B, int n_steps,
                                   uint32_t seed, int step_offset, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0;
  if (lane < B) {
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[6][lane]};
    int turn = in.f[5][lane];
    const uint32_t ctr = (uint32_t)lane;
    for (int i = 0; i < n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + step_offset);
      const uint32_t bits0 = random_word(seed, step, 0u, ctr);
      const uint32_t bits1 = random_word(seed, step, 1u, ctr);
      const uint32_t bits2 = random_word(seed, step, 2u, ctr);
      bool goal, trunc;
      int r;
      alt_transition(s, turn, u16(bits0, 0) % 5, bits1, g, goal, r);
      autoreset(s, goal, bits2, g, trunc);
      turn = (goal || trunc) ? 0 : 1 - turn;
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
    out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
    out.f[4][lane] = s.p;  out.f[5][lane] = turn;
    out.f[6][lane] = s.t;
  }
  block_sum(stats, rew, goals, truncs);
}

}  // namespace

extern "C" {

// K1.  device: the CUDA ordinal of every pointer and of the stream;
// in/out: host arrays of 6 device pointers to int32 [B];
// stats: device int64 [3] (reward sum, goals, truncations).
int gst_fused_rollout(int device, void* const* in, void* const* out,
                      long long* stats, const int32_t* params, int B,
                      int n_steps, uint32_t seed, int step_offset,
                      int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(device, params, B, threads, stats, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  rollout_kernel<<<blocks, threads, 0, st>>>(
      make_planes(in), make_planes(out), stats, B, n_steps, seed,
      step_offset, make_game(params));
  return (int)cudaGetLastError();
}

// K2.  As K1, plus journal: device int32 [n_steps, B].
int gst_fused_journal_rollout(int device, void* const* in, void* const* out,
                              long long* stats, int32_t* journal,
                              const int32_t* params, int B, int n_steps,
                              uint32_t seed, int step_offset, int threads,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(device, params, B, threads, stats, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  journal_kernel<<<blocks, threads, 0, st>>>(
      make_planes(in), make_planes(out), stats, journal, B, n_steps, seed,
      step_offset, make_game(params));
  return (int)cudaGetLastError();
}

// K3.  geo: host array of 6 device pointers to int32 [B] (H, W, glo, ghi,
// q_int, variant id); stats: device int64 [n_variants, 3] (reward sum,
// goals, truncations per variant), zeroed by the caller.
int gst_multigrid_rollout(int device, void* const* in, void* const* out,
                          void* const* geo, long long* stats, int B,
                          int n_steps, uint32_t seed, int step_offset,
                          int max_steps, int n_variants, int threads,
                          void* stream) {
  if (n_variants < 1 || n_variants > kMaxVariants)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = check_launch(device, B, threads);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  mg_rollout_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_planes(in), make_planes(out), make_planes(geo), stats, B, n_steps,
      seed, step_offset, max_steps, n_variants);
  return (int)cudaGetLastError();
}

// K4.  As K1, with in/out: host arrays of 7 device pointers to int32 [B]
// (ra, ca, rb, cb, p, turn, t).
int gst_alt_rollout(int device, void* const* in, void* const* out,
                    long long* stats, const int32_t* params, int B,
                    int n_steps, uint32_t seed, int step_offset, int threads,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(device, params, B, threads, stats, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  alt_rollout_kernel<<<blocks, threads, 0, st>>>(
      make_alt_planes(in), make_alt_planes(out), stats, B, n_steps, seed,
      step_offset, make_game(params));
  return (int)cudaGetLastError();
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
