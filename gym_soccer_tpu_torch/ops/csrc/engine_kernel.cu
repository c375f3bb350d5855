// The batched engine's step for Hopper (sm_90a): kernel S1.
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
// equal `step_plain`'s bit for bit.
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

// The uniform of word w at draw counter n: threefry's (under the lane's
// key folded with n, `k`) or the counter hash's (batch.per_env_uniforms,
// salt 0).
template <int RNG>
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t base2, uint32_t n,
                                            uint32_t w) {
  if (RNG == kThreefry) return gst::to_uniform(gst::random_bits(k0, k1, w));
  const uint32_t c = n * 0x85EBCA77u + w * 0xC2B2AE3Du;
  const uint32_t bits = gst::fmix32(gst::fmix32(k0 ^ c) + (c ^ base2));
  return __fmul_rn(__uint2float_rn(bits >> 8), 1.0f / 16777216.0f);
}

// u[0..count) at draw counter n for the lane's key words (kw0, kw1).
template <int RNG, int COUNT>
__device__ __forceinline__ void draw(uint32_t kw0, uint32_t kw1, uint32_t n,
                                     float* u) {
  uint32_t k0 = kw0, k1 = kw1, base2 = 0u;
  if (RNG == kThreefry) gst::fold_in(k0, k1, n);
  else base2 = gst::fmix32(kw1 ^ 0x3C6EF372u);
#pragma unroll
  for (int w = 0; w < COUNT; ++w) u[w] = uniform_at<RNG>(k0, k1, base2, n, w);
}

__device__ __forceinline__ int slip_variant(float u, const Params& g) {
  return u < g.keep ? 0 : (u < g.first ? 1 : 2);
}

// (dcol, drow) of action a under slip variant v (batch._slipped_move_arith).
__device__ __forceinline__ void slipped_move(int a, int v, int& mc, int& mr) {
  const int mc0 = (a == 3) - (a == 4);
  const int mr0 = (a == 2) - (a == 1);
  mc = v == 0 ? mc0 : (v == 1 ? -mr0 : mr0);
  mr = v == 0 ? mr0 : (v == 1 ? mc0 : -mc0);
}

__device__ __forceinline__ bool is_goal(int xa, int ya, int xb, int yb, int p,
                                        const Params& g) {
  return (p == 0 && gst::in_goal_rows(xa, g) && (ya == 0 || ya == g.W - 1)) ||
         (p == 1 && gst::in_goal_rows(xb, g) && (yb == 0 || yb == g.W - 1));
}

__device__ __forceinline__ int dense(const Args& a, int xa, int ya, int xb,
                                     int yb, int p) {
  int raw = (((xa * a.g.W + ya) * a.g.H + xb) * a.g.W + yb) * 2 + p;
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
  const int va = slip_variant(u[0], g), vb = slip_variant(u[1], g);
  int mca, mra, mcb, mrb;
  slipped_move(aa, va, mca, mra);
  slipped_move(ab, vb, mcb, mrb);

  // rules.resolve_outcomes, slot by slot.
  int nxa, nya, nxb, nyb;
  gst::next_cell(xa, ya, mca, mra, p == 0, g, nxa, nya);
  gst::next_cell(xb, yb, mcb, mrb, p == 1, g, nxb, nyb);
  const bool c1 = (xa == xb && abs(ya - yb) == 1 && nya == yb && nyb == ya) ||
                  (ya == yb && abs(xa - xb) == 1 && nxa == xb && nxb == xa);
  const bool c2 = !c1 && ((nxa == xb && nya == yb && ab == 0) ||
                          (nxb == xa && nyb == ya && aa == 0));
  const bool c3 =
      !c1 && !c2 &&
      ((xa == nxa && ya == nya && aa != 0 && nxb == xa && nyb == ya) ||
       (xb == nxb && yb == nyb && ab != 0 && nxa == xb && nya == yb));
  const bool c4 = !c1 && !c2 && !c3 && nxa == nxb && nya == nyb;
  const bool c5 = !c1 && !c2 && !c3 && !c4;
  const bool was_goal = is_goal(xa, ya, xb, yb, p, g);
  float w0 = (c1 || c3) ? 0.5f : (c4 ? 0.25f : 1.0f);
  float w1 = c4 ? 0.25f : ((c1 || c3) ? 0.5f : 0.0f);
  float w2 = c4 ? 0.25f : 0.0f;
  if (was_goal) w0 = 1.0f, w1 = 0.0f, w2 = 0.0f;
  const float s1 = __fadd_rn(w0, w1), s2 = __fadd_rn(s1, w2);
  const float s3 = __fadd_rn(s2, w2);
  const int k = min((w0 <= u[2]) + (s1 <= u[2]) + (s2 <= u[2]) + (s3 <= u[2]),
                    3);
  // slot 0: A moves on a clean move, B on a race or a clean move; slot 1:
  // both bounce (B moves on a race), B holds the ball; slots 2, 3: A moves,
  // B bounces, the ball with A, then with B.
  int rxa, rya, rxb, ryb, rp;
  if (k == 0) {
    rxa = c5 ? nxa : xa;
    rya = c5 ? nya : ya;
    rxb = (c4 || c5) ? nxb : xb;
    ryb = (c4 || c5) ? nyb : yb;
    rp = c2 ? 1 - p : (c5 ? p : 0);
  } else if (k == 1) {
    rxa = xa, rya = ya;
    rxb = c4 ? nxb : xb;
    ryb = c4 ? nyb : yb;
    rp = 1;
  } else {
    rxa = nxa, rya = nya, rxb = xb, ryb = yb;
    rp = k == 2 ? 0 : 1;
  }
  const float wk = k == 0 ? w0 : (k == 1 ? w1 : w2);
  if (was_goal) rxa = xa, rya = ya, rxb = xb, ryb = yb, rp = p;
  const bool now_goal = is_goal(rxa, rya, rxb, ryb, rp, g);

  const float pa = va == 0 ? g.keep : g.slip, pb = vb == 0 ? g.keep : g.slip;
  const float prob = __fmul_rn(__fmul_rn(pa, pb), was_goal ? 1.0f : wk);
  const int ball_col = rp == 0 ? rya : ryb;
  const float reward =
      (now_goal && !was_goal) ? (ball_col == g.W - 1 ? 1.0f : -1.0f) : 0.0f;
  const int t1 = (int)((uint32_t)t + 1u);
  const bool truncated = t1 >= g.max_steps;
  const int final_obs = dense(a, rxa, rya, rxb, ryb, rp);

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
      rxa = e[0], rya = e[1], rxb = e[2], ryb = e[3], rp = e[4];
      ot = 0;
    }
  }
  int32_t* o = a.out_i + i;
  o[0] = rxa;
  o[B] = rya;
  o[2 * B] = rxb;
  o[3 * B] = ryb;
  o[4 * B] = rp;
  o[5 * B] = ot;
  o[6 * B] = (int32_t)on;
  o[7 * B] = AUTORESET ? dense(a, rxa, rya, rxb, ryb, rp) : final_obs;
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
