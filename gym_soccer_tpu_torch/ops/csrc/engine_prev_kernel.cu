// The batched engine's step for Hopper (sm_90a): the previous design of
// kernel S1, one thread a lane in blocks of 256 lanes, whose reset reads the
// ISD's thresholds and fields and a second observation from the card after
// its draws (engine_kernel.cu holds the kernel; ops/engine_variants.py
// builds this one beside it and times both).
//
// It has no Pallas counterpart: the JAX package computes
// `batch.step(cfg, state, aa, ab, autoreset, rng)` as XLA
// (gym_soccer_tpu/core/batch.py), and the port's plain version
// (core/batch.py `step_plain`) is a chain of ~350 PyTorch ops around two
// draws.  S1 is the whole step, its draws included, in one launch: the
// threefry engine's step (the HBM-table learners, `SoccerVectorEnv`, the
// policy-driven rollouts) and the counter engine's (the best-response
// gate's `greedy_win_share`).
//
// What it computes, one thread a lane i, everything in registers:
//   u0, u1, u2   the transition's uniforms at (key_i, n_i): threefry's
//                uniform(fold_in(key_i, n_i), (4,))[0..2] (its fourth is
//                never read, so its block is skipped), or the counter
//                hash's words 0..2
//   va, vb       slip variants: u < keep -> 0, u < first -> 1, else 2
//   the collision chain of rules.resolve_outcomes for the slipped moves
//   and the original actions, its four outcome slots kept as scalars; the
//   slot k = the count of the float32 prefix sums of the slots' weights
//   (0, 0.25, 0.5 or 1, so the sums are exact) that are <= u2, at most 3
//   goal states stay put; prob = (pv(va) * pv(vb)) * w_k (1 in a goal
//   state), each product rounded; the goal reward by the ball's column;
//   t + 1, truncation at max_steps; final_obs = raw_to_dense of the mid
//   state
//   AUTORESET: the reset's uniform at (key_i, n_i + 1), drawn on every
//   lane; the ISD entry = the count of isd_cum <= u, clamped; a lane that
//   scored or was truncated takes it with t = 0; n advances by 2 (else 1)
//   obs = raw_to_dense of the new state
// All integer arithmetic is on uint32/int32 with the plain version's
// wrap-around; every float is one rounded IEEE operation, so the outputs
// equal `step_plain`'s bit for bit.  The slip variant, the slipped move and
// the collision chain with its slot are game.cuh's `slip_variant`,
// `variant_move` and `resolve_step`, which kernel S2 (mixed_alt_kernel.cu)
// runs on each lane's own board.
//
// What bounds it: per lane it reads 52 B (seven int32 fields, the two key
// words as int64, two int32 actions; int64 actions add 8) and writes 46 B
// (nine int32, two float32, two bools); the work is 6 threefry blocks (or
// 10 murmur3 finalizers) and ~150 integer operations of rules.  At
// the callers' 256-8192 lanes both are far below a launch's floor, so S1's
// gain is the ~350 launches a step it replaces, not its body: a block of
// 256 lanes, the lookup tables read through L1 (raw_to_dense holds 1568
// entries on 5x4, 16562 on 11x7; the ISD at most 4).
#include <cstdint>
#include <cuda_runtime.h>

#include "game.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;   // lanes a block

// The board and the slip's float32 constants, from the host
// (ops/engine_kernel.EngineParams, field for field).
struct Params {
  int H, W, glo, ghi;   // height, width incl. goal columns, goal rows
  int max_steps;
  int n_raw;            // entries of raw_to_dense
  int nI;               // ISD entries
  float keep;           // f32(1 - q): the intended move's threshold and p
  float first;          // f32(1 - q / 2): the first orthogonal's threshold
  float slip;           // f32(q / 2): an orthogonal's p
};

struct Args {
  const int32_t* f[7];           // ra, ca, rb, cb, poss, t, n  [B]
  const int64_t* key;            // [B, 2] uint32 words
  const void* aa;                // int32 or int64 [B]
  const void* ab;
  const int32_t* raw_to_dense;   // [n_raw]
  const int32_t* isd_fields;     // [nI, 5]
  const float* isd_cum;          // [nI]
  int32_t* out_i;   // [9, B]: ra, ca, rb, cb, poss, t, n, obs, final_obs
  float* out_f;     // [2, B]: reward_a, prob
  bool* out_b;      // [2, B]: done, truncated
  Params g;
  int lanes;
};

enum Rng { kThreefry = 0, kCounter = 1 };

// u[0..COUNT) at draw counter n for the lane's key words (kw0, kw1):
// threefry's (threefry.cuh) or the counter hash's (batch.per_env_uniforms,
// salt 0).
template <int RNG, int COUNT>
__device__ __forceinline__ void draw(uint32_t kw0, uint32_t kw1, uint32_t n,
                                     float* u) {
  if (RNG == kThreefry) {
    gst::uniforms_at<COUNT>(kw0, kw1, n, u);
    return;
  }
  const uint32_t base2 = gst::fmix32(kw1 ^ 0x3C6EF372u);
#pragma unroll
  for (int w = 0; w < COUNT; ++w) {
    const uint32_t c = n * 0x85EBCA77u + (uint32_t)w * 0xC2B2AE3Du;
    const uint32_t bits = gst::fmix32(gst::fmix32(kw0 ^ c) + (c ^ base2));
    u[w] = __fmul_rn(__uint2float_rn(bits >> 8), 1.0f / 16777216.0f);
  }
}

__device__ __forceinline__ int dense(const Args& a, const gst::State& s) {
  int raw = (((s.ra * a.g.W + s.ca) * a.g.H + s.rb) * a.g.W + s.cb) * 2 + s.p;
  if (raw < 0) raw += a.g.n_raw;   // a negative index counts from the end
  return a.raw_to_dense[raw];
}

template <bool ACT64>
__device__ __forceinline__ int action(const void* acts, int i) {
  return ACT64 ? (int)(uint32_t)static_cast<const int64_t*>(acts)[i]
               : static_cast<const int32_t*>(acts)[i];
}

template <int RNG, bool AUTORESET, bool ACT64>
__global__ void __launch_bounds__(kThreads) engine_step_kernel(Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.lanes) return;
  const Params& g = a.g;
  const int B = a.lanes;
  const int xa = a.f[0][i], ya = a.f[1][i], xb = a.f[2][i], yb = a.f[3][i];
  const int p = a.f[4][i], t = a.f[5][i];
  const uint32_t n = (uint32_t)a.f[6][i];
  const uint32_t kw0 = (uint32_t)a.key[2 * i], kw1 = (uint32_t)a.key[2 * i + 1];
  const int aa = action<ACT64>(a.aa, i), ab = action<ACT64>(a.ab, i);

  float u[3];
  draw<RNG, 3>(kw0, kw1, n, u);
  const int va = gst::slip_variant(u[0], g.keep, g.first);
  const int vb = gst::slip_variant(u[1], g.keep, g.first);
  int mca, mra, mcb, mrb;
  gst::variant_move(aa, va, mca, mra);
  gst::variant_move(ab, vb, mcb, mrb);
  gst::State s{xa, ya, xb, yb, p, t};
  bool was_goal;
  const float wk = gst::resolve_step(s, aa, ab, mca, mra, mcb, mrb, u[2], g,
                                     was_goal);
  const bool now_goal = gst::is_goal_state(s, g);

  const float pa = va == 0 ? g.keep : g.slip, pb = vb == 0 ? g.keep : g.slip;
  const float prob = __fmul_rn(__fmul_rn(pa, pb), wk);
  const int ball_col = s.p == 0 ? s.ca : s.cb;
  const float reward =
      (now_goal && !was_goal) ? (ball_col == g.W - 1 ? 1.0f : -1.0f) : 0.0f;
  const int t1 = (int)((uint32_t)t + 1u);
  const bool truncated = t1 >= g.max_steps;
  const int final_obs = dense(a, s);

  int ot = t1;
  uint32_t on = n + 1u;
  if (AUTORESET) {
    float ur;
    draw<RNG, 1>(kw0, kw1, n + 1u, &ur);
    on = n + 2u;
    int idx = 0;
    for (int j = 0; j < g.nI; ++j) idx += a.isd_cum[j] <= ur;
    idx = max(min(idx, g.nI - 1), 0);
    if (now_goal || truncated) {
      const int32_t* e = a.isd_fields + 5 * idx;
      s = {e[0], e[1], e[2], e[3], e[4], 0};
      ot = 0;
    }
  }
  int32_t* o = a.out_i + i;
  o[0] = s.ra;
  o[B] = s.ca;
  o[2 * B] = s.rb;
  o[3 * B] = s.cb;
  o[4 * B] = s.p;
  o[5 * B] = ot;
  o[6 * B] = (int32_t)on;
  o[7 * B] = AUTORESET ? dense(a, s) : final_obs;
  o[8 * B] = final_obs;
  a.out_f[i] = reward;
  a.out_f[B + i] = prob;
  a.out_b[i] = now_goal;
  a.out_b[B + i] = truncated;
}

template <int RNG, bool AUTORESET>
void launch_act(bool act64, int blocks, cudaStream_t s, const Args& a) {
  if (act64)
    engine_step_kernel<RNG, AUTORESET, true><<<blocks, kThreads, 0, s>>>(a);
  else
    engine_step_kernel<RNG, AUTORESET, false><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

extern "C" {

// S1.  ptrs: 16 device pointers, each array contiguous: the seven int32
// [lanes] state fields (ra, ca, rb, cb, poss, t, n), the int64 [lanes, 2]
// key words, the two [lanes] action arrays (int64 if act64, else int32),
// raw_to_dense int32 [n_raw], isd_fields int32 [nI, 5], isd_cum float32
// [nI], then the outputs: int32 [9, lanes], float32 [2, lanes], bool
// [2, lanes].  params: the host's Params (a type of this file alone, so
// the C entry takes it as void*).  rng: 0 threefry, 1 counter.  Launches on
// `stream` and returns its cudaError_t (0 on success); lanes == 0 launches
// nothing.
int gst_engine_step(int device, void* const* ptrs, const void* params,
                    int lanes, int rng, int autoreset, int act64,
                    void* stream) {
  const Params& g = *static_cast<const Params*>(params);
  if (lanes < 0 || (rng != kThreefry && rng != kCounter) || g.nI < 1)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Args a;
  for (int f = 0; f < 7; ++f) a.f[f] = static_cast<const int32_t*>(ptrs[f]);
  a.key = static_cast<const int64_t*>(ptrs[7]);
  a.aa = ptrs[8];
  a.ab = ptrs[9];
  a.raw_to_dense = static_cast<const int32_t*>(ptrs[10]);
  a.isd_fields = static_cast<const int32_t*>(ptrs[11]);
  a.isd_cum = static_cast<const float*>(ptrs[12]);
  a.out_i = static_cast<int32_t*>(ptrs[13]);
  a.out_f = static_cast<float*>(ptrs[14]);
  a.out_b = static_cast<bool*>(ptrs[15]);
  a.g = g;
  a.lanes = lanes;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool act = act64 != 0;
  if (rng == kThreefry)
    autoreset ? launch_act<kThreefry, true>(act, blocks, s, a)
              : launch_act<kThreefry, false>(act, blocks, s, a);
  else
    autoreset ? launch_act<kCounter, true>(act, blocks, s, a)
              : launch_act<kCounter, false>(act, blocks, s, a);
  return (int)cudaGetLastError();
}

// Lanes a block and sizeof(Params), for the wrapper's checks.
void gst_engine_shape(int* shape) {
  shape[0] = kThreads;
  shape[1] = (int)sizeof(Params);
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
