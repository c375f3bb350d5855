// Fused random-vs-random rollout kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of gym_soccer_tpu/ops/step_kernel.py:
//   rollout_kernel  <- `_rollout_kernel` (K1, wrapper `pallas_rollout`)
//   journal_kernel  <- `_journal_kernel` (K2, wrapper `pallas_journal_rollout`)
//
// Both compute, for every lane (one independent game) and every step:
// three murmur3 counter words keyed on (seed, absolute step, word index,
// global lane id), the random joint action, the slipped moves, the
// 4-priority collision chain, goal detection, truncation and the reset to
// an initial-state (ISD) entry, and the per-lane reward/goal/truncation
// sums.  journal_kernel also stores one packed int32 word per lane-step
// (bit layout in step_kernel.py's `_journal_word`).  Every operation is
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
// per thread are left to later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxIsd = 4;

struct Game {
  int H, W, glo, ghi;  // board height, width incl. goal columns, goal rows
  int q_int;           // round(slip_prob * 65536)
  int max_steps;
  int nI;              // number of ISD entries (4 or 2)
  int isd[kMaxIsd][5]; // ISD entries as (ra, ca, rb, cb, p)
};

struct Planes {
  int32_t* f[6];  // ra, ca, rb, cb, p, t
};

struct State {
  int ra, ca, rb, cb, p, t;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t random_word(uint32_t seed, uint32_t step,
                                                uint32_t widx,
                                                uint32_t lane) {
  const uint32_t c = seed * 0x9E3779B9u + step * 0x85EBCA77u +
                     widx * 0xC2B2AE3Du;
  return fmix32(fmix32(lane ^ c) + c);
}

__device__ __forceinline__ int u16(uint32_t w, int hi) {
  return (int)((w >> (hi ? 16 : 0)) & 0xFFFFu);
}

__device__ __forceinline__ bool in_goal_rows(int x, const Game& g) {
  return x >= g.glo && x <= g.ghi;
}

// Keep the intended move with p = 1 - q, else one of the two orthogonals
// (q / 2 each): (-mr, mc) first, then (mr, -mc).
__device__ __forceinline__ void slipped_move(int a, int u, int q_int,
                                             int& mc, int& mr) {
  const int mc0 = (a == 3) - (a == 4);
  const int mr0 = (a == 2) - (a == 1);
  const bool keep = u < 65536 - q_int;
  const bool first = u < 65536 - q_int / 2;
  mc = keep ? mc0 : (first ? -mr0 : mr0);
  mr = keep ? mr0 : (first ? mc0 : -mc0);
}

__device__ __forceinline__ void next_cell(int x, int y, int mc, int mr,
                                          bool ball, const Game& g,
                                          int& nx, int& ny) {
  nx = min(max(x + mr, 0), g.H - 1);
  const int nyt = y + mc;
  const bool xoob = nyt == 0 || nyt == g.W - 1;
  const bool goal = xoob && in_goal_rows(nx, g) && ball;
  ny = (xoob && !goal) ? y : nyt;
}

// One game transition under chosen actions (step_kernel.transition_core).
__device__ __forceinline__ void transition(State& s, int aa, int ab,
                                           uint32_t bits1, uint32_t bits2,
                                           const Game& g, bool& goal,
                                           int& r) {
  int mca, mra, mcb, mrb;
  slipped_move(aa, u16(bits1, 0), g.q_int, mca, mra);
  slipped_move(ab, u16(bits1, 1), g.q_int, mcb, mrb);
  int nxa, nya, nxb, nyb;
  next_cell(s.ra, s.ca, mca, mra, s.p == 0, g, nxa, nya);
  next_cell(s.rb, s.cb, mcb, mrb, s.p == 1, g, nxb, nyb);

  const int ra = s.ra, ca = s.ca, rb = s.rb, cb = s.cb;
  const bool c1 =
      (ra == rb && abs(ca - cb) == 1 && nya == cb && nyb == ca) ||
      (ca == cb && abs(ra - rb) == 1 && nxa == rb && nxb == ra);
  const bool c2 = !c1 && ((nxa == rb && nya == cb && ab == 0) ||
                          (nxb == ra && nyb == ca && aa == 0));
  const bool c3 =
      !c1 && !c2 &&
      ((ra == nxa && ca == nya && aa != 0 && nxb == ra && nyb == ca) ||
       (rb == nxb && cb == nyb && ab != 0 && nxa == rb && nya == cb));
  const bool c4 = !c1 && !c2 && !c3 && nxa == nxb && nya == nyb;
  const bool c5 = !c1 && !c2 && !c3 && !c4;

  const int coin = u16(bits2, 0);
  const int coin_poss = coin & 1;
  const bool coin_who = ((coin >> 1) & 1) == 1;
  const bool a_moves = c5 || (c4 && coin_who);
  const bool b_moves = c5 || (c4 && !coin_who);
  if (a_moves) { s.ra = nxa; s.ca = nya; }
  if (b_moves) { s.rb = nxb; s.cb = nyb; }
  s.p = c2 ? 1 - s.p : ((c1 || c3 || c4) ? coin_poss : s.p);

  const bool a_ball = s.p == 0;
  const int ball_col = a_ball ? s.ca : s.cb;
  const bool gr = a_ball ? in_goal_rows(s.ra, g) : in_goal_rows(s.rb, g);
  goal = gr && (ball_col == 0 || ball_col == g.W - 1);
  r = goal ? (ball_col == g.W - 1 ? 1 : -1) : 0;
}

// Truncation and reset to ISD entry u16(bits2, 1) % nI
// (step_kernel.autoreset_core).  Returns the ISD index drawn.
__device__ __forceinline__ int autoreset(State& s, bool goal, uint32_t bits2,
                                         const Game& g, bool& trunc) {
  s.t += 1;
  trunc = s.t >= g.max_steps && !goal;
  const int idx = u16(bits2, 1) % g.nI;
  if (goal || trunc) {
#pragma unroll
    for (int k = 0; k < kMaxIsd; ++k) {
      if (k == idx) {
        s.ra = g.isd[k][0]; s.ca = g.isd[k][1];
        s.rb = g.isd[k][2]; s.cb = g.isd[k][3];
        s.p = g.isd[k][4];
      }
    }
    s.t = 0;
  }
  return idx;
}

// Sum three per-thread counters over the block; one atomicAdd per counter
// per block.  blockDim.x must be a multiple of 32 (checked by the launcher).
__device__ __forceinline__ void block_sum(long long* stats, long long a,
                                          long long b, long long c) {
  __shared__ long long part[32][3];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xFFFFFFFFu, a, off);
    b += __shfl_down_sync(0xFFFFFFFFu, b, off);
    c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { part[warp][0] = a; part[warp][1] = b; part[warp][2] = c; }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sa = 0, sb = 0, sc = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      sa += part[w][0]; sb += part[w][1]; sc += part[w][2];
    }
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 0),
              (unsigned long long)sa);
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 1),
              (unsigned long long)sb);
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 2),
              (unsigned long long)sc);
  }
}

// The step loop of one lane; kJournal adds the journal store.
template <bool kJournal>
__device__ __forceinline__ void run_lane(const Planes& in, const Planes& out,
                                         long long* stats, int32_t* journal,
                                         int B, int n_steps, uint32_t seed,
                                         int step_offset, const Game& g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0;
  if (lane < B) {
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[5][lane]};
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
    out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
    out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
    out.f[4][lane] = s.p;  out.f[5][lane] = s.t;
  }
  block_sum(stats, rew, goals, truncs);
}

__global__ void rollout_kernel(Planes in, Planes out, long long* stats,
                               int B, int n_steps, uint32_t seed,
                               int step_offset, Game g) {
  run_lane<false>(in, out, stats, nullptr, B, n_steps, seed, step_offset, g);
}

__global__ void journal_kernel(Planes in, Planes out, long long* stats,
                               int32_t* journal, int B, int n_steps,
                               uint32_t seed, int step_offset, Game g) {
  run_lane<true>(in, out, stats, journal, B, n_steps, seed, step_offset, g);
}

// params: H, W, glo, ghi, q_int, max_steps, nI, then nI x 5 ISD fields.
Game make_game(const int32_t* params) {
  Game g{};
  g.H = params[0]; g.W = params[1]; g.glo = params[2]; g.ghi = params[3];
  g.q_int = params[4]; g.max_steps = params[5]; g.nI = params[6];
  for (int k = 0; k < g.nI && k < kMaxIsd; ++k)
    for (int f = 0; f < 5; ++f) g.isd[k][f] = params[7 + 5 * k + f];
  return g;
}

Planes make_planes(void* const* ptrs) {
  Planes p;
  for (int i = 0; i < 6; ++i) p.f[i] = static_cast<int32_t*>(ptrs[i]);
  return p;
}

// Shared launch checks, the device the tensors live on, and the zeroing
// of the stats sums.
cudaError_t prepare(int device, const int32_t* params, int B, int threads,
                    long long* stats, cudaStream_t st) {
  if (B <= 0 || threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      params[6] < 1 || params[6] > kMaxIsd)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return cudaMemsetAsync(stats, 0, 3 * sizeof(long long), st);
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

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
