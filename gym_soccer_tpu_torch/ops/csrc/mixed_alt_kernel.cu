// The mixed-geometry and alternating-turn engines' steps for Hopper
// (sm_90a): kernels S2 and S3.
//
// Neither has a Pallas counterpart: the JAX package computes
// `multigrid.step(state, aa, ab, autoreset)` (gym_soccer_tpu/core/
// multigrid.py) and `alt_step(cfg, state, action, autoreset)`
// (gym_soccer_tpu/envs/soccer_alternating_env.py) as XLA, and the port's
// plain versions (core/multigrid.py `step_plain`, envs/
// soccer_alternating_env.py `alt_step_plain`) are chains of ~300-400
// PyTorch ops around two draws.  Each kernel is the whole step, its draws
// and its autoreset included, in one launch, and can write the learners'
// observations of the state before and after the reset.  Both draw with
// threefry only (threefry.cuh), as both engines do.
//
// S2, one thread a lane i, on the lane's own board (H, W, goal rows, slip
// and variant from the LaneGeometry planes):
//   u0, u1, u2   uniform(fold_in(key_i, n_i), (4,))[0..2] (the fourth is
//                never read, so its block is skipped)
//   va, vb       slip variants against keep = 1 - q and first =
//                1 - q * 0.5, each one float32 operation on the lane's
//                float32 slip q, as the plain version computes them on a
//                float32 tensor (not the float64 value rounded once, as S1
//                takes its board's)
//   the collision chain and its slot (game.cuh `resolve_step`, S1's); goal
//   states stay put and pay 0; the goal reward by the ball's column; t + 1,
//   truncation at max_steps
//   AUTORESET: the reset's uniform at (key_i, n_i + 1), drawn on every
//   lane; the ISD entry min(int(u * nI), nI - 1), nI = 4 on even H and 2 on
//   odd H, rows the middle ones, columns 2 and W - 3 (multigrid._isd_fields);
//   a lane that scored or was truncated takes it with t = 0; n advances by
//   2 (else 1)
//   OBS: final_obs = offsets[vid] + raw_to_dense[vid, raw] of the state
//   before the reset, obs the same of the new state (multigrid.global_obs)
// S3, one thread a lane i, on the board shared by every lane:
//   u0           uniform(fold_in(key_i, n_i), (2,))[0] (the second is
//                never read)
//   v            slip variant against the board's f32(1 - q), f32(1 - q/2)
//   the mover's slipped move (A at turn 0, B otherwise), with the ball if
//   poss == turn; stepping into the opponent bounces back and hands the
//   ball to 1 - turn (alt_transition); turn becomes 1 - turn; no goal
//   state is absorbing: the reward is the goal's by the ball's column
//   wherever the new state is a goal; t + 1, truncation at max_steps
//   AUTORESET: the reset's uniform at (key_i, n_i + 1), the ISD entry the
//   count of isd_cum <= u, clamped; a lane that scored or was truncated
//   takes it with turn = 0 and t = 0; n advances by 2 (else 1)
//   final_obs, obs: the alternating tables' raw_to_dense[raw * 2 + turn]
//   of the state before and after the reset (alt_observe: the code
//   clamped to the table)
// All integer arithmetic is on int32/uint32 with the plain versions'
// wrap-around and every float one rounded IEEE operation, so the outputs
// equal the plain versions' bit for bit.
//
// What bounds them: per lane S2 reads 76 B (seven int32 fields, the key
// words as int64, two int32 actions, five int32 and one float32 geometry
// planes) and writes 46 B; S3 reads 52 B and writes 46 B; the work is 4
// (S3: 3) threefry blocks and ~150 integer operations.  At the callers'
// 256-8192 lanes both are far below a launch's floor, so the gain is the
// ~300-400 launches a step they replace: a block of 256 lanes, the lookup
// tables read through L1.
#include <cstdint>
#include <cuda_runtime.h>

#include "game.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;   // lanes a block

// A lane's board, the geometry game.cuh's step functions read.
struct Board {
  int H, W, glo, ghi;
};

struct MixedArgs {
  const int32_t* f[7];           // ra, ca, rb, cb, poss, t, n  [B]
  const int64_t* key;            // [B, 2] uint32 words
  const void* aa;                // int32 or int64 [B]
  const void* ab;
  const int32_t* geo[5];         // H, W, glo, ghi, vid  [B]
  const float* slip;             // [B]
  const int32_t* raw_to_dense;   // [V, max_raw] (OBS)
  const int32_t* offsets;        // [V] (OBS)
  int32_t* out_i;   // [7 (+2 OBS), B]: ra, ca, rb, cb, poss, t, n, obs,
                    // final_obs
  float* out_f;     // [B]: reward_a
  bool* out_b;      // [2, B]: goal, truncated
  int max_steps, max_raw, lanes;
};

// The board and the slip's float32 constants, from the host: S1's
// (engine_kernel.cu, ops/engine_kernel.EngineParams), field for field.
struct Params {
  int H, W, glo, ghi;   // height, width incl. goal columns, goal rows
  int max_steps;
  int n_raw;            // entries of the alternating raw_to_dense
  int nI;               // ISD entries
  float keep;           // f32(1 - q): the intended move's threshold
  float first;          // f32(1 - q / 2): the first orthogonal's threshold
  float slip;           // f32(q / 2) (not read here)
};

struct AltArgs {
  const int32_t* f[8];           // ra, ca, rb, cb, poss, turn, t, n  [B]
  const int64_t* key;            // [B, 2] uint32 words
  const void* a;                 // int32 or int64 [B]
  const int32_t* raw_to_dense;   // [n_raw]
  const int32_t* isd_fields;     // [nI, 5]
  const float* isd_cum;          // [nI]
  int32_t* out_i;   // [10, B]: ra, ca, rb, cb, poss, turn, t, n, obs,
                    // final_obs
  float* out_f;     // [B]: reward_a
  bool* out_b;      // [2, B]: goal, truncated
  Params g;
  int lanes;
};

template <bool ACT64>
__device__ __forceinline__ int action(const void* acts, int i) {
  return ACT64 ? (int)(uint32_t)static_cast<const int64_t*>(acts)[i]
               : static_cast<const int32_t*>(acts)[i];
}

template <class G>
__device__ __forceinline__ int raw_code(const gst::State& s, const G& g) {
  return (((s.ra * g.W + s.ca) * g.H + s.rb) * g.W + s.cb) * 2 + s.p;
}

// multigrid.global_obs of the lane's state on its board.
__device__ __forceinline__ int global_obs(const MixedArgs& a,
                                          const gst::State& s,
                                          const Board& g, int vid) {
  int raw = raw_code(s, g);
  if (raw < 0) raw += a.max_raw;   // a negative index counts from the end
  return a.offsets[vid] + a.raw_to_dense[vid * a.max_raw + raw];
}

template <bool AUTORESET, bool OBS, bool ACT64>
__global__ void __launch_bounds__(kThreads) multigrid_step_kernel(
    MixedArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.lanes) return;
  const int B = a.lanes;
  const Board g{a.geo[0][i], a.geo[1][i], a.geo[2][i], a.geo[3][i]};
  const int vid = a.geo[4][i];
  gst::State s{a.f[0][i], a.f[1][i], a.f[2][i], a.f[3][i], a.f[4][i],
               a.f[5][i]};
  const uint32_t n = (uint32_t)a.f[6][i];
  const uint32_t kw0 = (uint32_t)a.key[2 * i], kw1 = (uint32_t)a.key[2 * i + 1];
  const int aa = action<ACT64>(a.aa, i), ab = action<ACT64>(a.ab, i);

  float u[3];
  gst::uniforms_at<3>(kw0, kw1, n, u);
  const float q = a.slip[i];
  const float keep = __fsub_rn(1.0f, q);
  const float first = __fsub_rn(1.0f, __fmul_rn(q, 0.5f));
  int mca, mra, mcb, mrb;
  gst::variant_move(aa, gst::slip_variant(u[0], keep, first), mca, mra);
  gst::variant_move(ab, gst::slip_variant(u[1], keep, first), mcb, mrb);
  bool was_goal;
  gst::resolve_step(s, aa, ab, mca, mra, mcb, mrb, u[2], g, was_goal);
  const bool now_goal = gst::is_goal_state(s, g);
  const int ball_col = s.p == 0 ? s.ca : s.cb;
  const float reward =
      (now_goal && !was_goal) ? (ball_col == g.W - 1 ? 1.0f : -1.0f) : 0.0f;
  const int t1 = (int)((uint32_t)s.t + 1u);
  const bool truncated = t1 >= a.max_steps;
  s.t = t1;
  int final_obs = 0;
  if (OBS) final_obs = global_obs(a, s, g, vid);

  uint32_t on = n + 1u;
  if (AUTORESET) {
    float ur;
    gst::uniforms_at<1>(kw0, kw1, n + 1u, &ur);
    on = n + 2u;
    const bool even = g.H % 2 == 0;
    const int nI = even ? 4 : 2;
    const int idx = min((int)__fmul_rn(ur, (float)nI), nI - 1);
    if (now_goal || truncated) {
      const bool swap = even && idx / 2 == 1;
      const int mid_hi = g.H / 2, mid_lo = even ? (g.H - 1) / 2 : g.H / 2;
      s = {swap ? mid_hi : mid_lo, 2, swap ? mid_lo : mid_hi, g.W - 3,
           idx % 2, 0};
    }
  }
  int32_t* o = a.out_i + i;
  o[0] = s.ra;
  o[B] = s.ca;
  o[2 * B] = s.rb;
  o[3 * B] = s.cb;
  o[4 * B] = s.p;
  o[5 * B] = s.t;
  o[6 * B] = (int32_t)on;
  if (OBS) {
    o[7 * B] = AUTORESET ? global_obs(a, s, g, vid) : final_obs;
    o[8 * B] = final_obs;
  }
  a.out_f[i] = reward;
  a.out_b[i] = now_goal;
  a.out_b[B + i] = truncated;
}

// The alternating tables' raw_to_dense of the lane's state and turn
// (alt_observe): a negative code counts from the end, then the code is
// clamped to the table, as JAX's gather reads it (a lane that walked on
// from a goal without autoreset leaves the board).
__device__ __forceinline__ int alt_dense(const AltArgs& a,
                                         const gst::State& s, int turn) {
  int raw = raw_code(s, a.g) * 2 + turn;
  if (raw < 0) raw += a.g.n_raw;
  return a.raw_to_dense[min(max(raw, 0), a.g.n_raw - 1)];
}

template <bool AUTORESET, bool ACT64>
__global__ void __launch_bounds__(kThreads) alt_step_kernel(AltArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.lanes) return;
  const Params& g = a.g;
  const int B = a.lanes;
  gst::State s{a.f[0][i], a.f[1][i], a.f[2][i], a.f[3][i], a.f[4][i],
               a.f[6][i]};
  const int turn = a.f[5][i];
  const uint32_t n = (uint32_t)a.f[7][i];
  const uint32_t kw0 = (uint32_t)a.key[2 * i], kw1 = (uint32_t)a.key[2 * i + 1];
  const int act = action<ACT64>(a.a, i);

  float u0;
  gst::uniforms_at<1>(kw0, kw1, n, &u0);
  int mc, mr;
  gst::variant_move(act, gst::slip_variant(u0, g.keep, g.first), mc, mr);
  // alt_transition: the mover steps; into the opponent it bounces back and
  // the opponent takes the ball.
  const bool a_moves = turn == 0;
  const int mx = a_moves ? s.ra : s.rb, my = a_moves ? s.ca : s.cb;
  const int ox = a_moves ? s.rb : s.ra, oy = a_moves ? s.cb : s.ca;
  int nx, ny;
  gst::next_cell(mx, my, mc, mr, s.p == turn, g, nx, ny);
  if (nx == ox && ny == oy) {
    nx = mx;
    ny = my;
    s.p = 1 - turn;
  }
  if (a_moves) { s.ra = nx; s.ca = ny; } else { s.rb = nx; s.cb = ny; }
  int nturn = 1 - turn;
  const bool now_goal = gst::is_goal_state(s, g);
  const int ball_col = s.p == 0 ? s.ca : s.cb;
  const float reward =
      now_goal ? (ball_col == g.W - 1 ? 1.0f : -1.0f) : 0.0f;
  const int t1 = (int)((uint32_t)s.t + 1u);
  const bool truncated = t1 >= g.max_steps;
  s.t = t1;
  const int final_obs = alt_dense(a, s, nturn);

  uint32_t on = n + 1u;
  if (AUTORESET) {
    float ur;
    gst::uniforms_at<1>(kw0, kw1, n + 1u, &ur);
    on = n + 2u;
    int idx = 0;
    for (int j = 0; j < g.nI; ++j) idx += a.isd_cum[j] <= ur;
    idx = max(min(idx, g.nI - 1), 0);
    if (now_goal || truncated) {
      const int32_t* e = a.isd_fields + 5 * idx;
      s = {e[0], e[1], e[2], e[3], e[4], 0};
      nturn = 0;
    }
  }
  int32_t* o = a.out_i + i;
  o[0] = s.ra;
  o[B] = s.ca;
  o[2 * B] = s.rb;
  o[3 * B] = s.cb;
  o[4 * B] = s.p;
  o[5 * B] = nturn;
  o[6 * B] = s.t;
  o[7 * B] = (int32_t)on;
  o[8 * B] = AUTORESET ? alt_dense(a, s, nturn) : final_obs;
  o[9 * B] = final_obs;
  a.out_f[i] = reward;
  a.out_b[i] = now_goal;
  a.out_b[B + i] = truncated;
}

template <bool AUTORESET, bool OBS>
void launch_mixed(bool act64, int blocks, cudaStream_t st,
                  const MixedArgs& a) {
  if (act64)
    multigrid_step_kernel<AUTORESET, OBS, true><<<blocks, kThreads, 0, st>>>(a);
  else
    multigrid_step_kernel<AUTORESET, OBS, false><<<blocks, kThreads, 0, st>>>(
        a);
}

template <bool AUTORESET>
void launch_alt(bool act64, int blocks, cudaStream_t st, const AltArgs& a) {
  if (act64)
    alt_step_kernel<AUTORESET, true><<<blocks, kThreads, 0, st>>>(a);
  else
    alt_step_kernel<AUTORESET, false><<<blocks, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// S2.  ptrs: 21 device pointers, each array contiguous: the seven int32
// [lanes] state fields (ra, ca, rb, cb, poss, t, n), the int64 [lanes, 2]
// key words, the two [lanes] action arrays (int64 if act64, else int32),
// the int32 [lanes] geometry planes H, W, glo, ghi, vid, the float32
// [lanes] slip, the codec's raw_to_dense int32 [V, max_raw] and offsets
// int32 [V] (read only if obs), then the outputs: int32 [obs ? 9 : 7,
// lanes], float32 [lanes], bool [2, lanes].  Launches on `stream` and
// returns its cudaError_t (0 on success); lanes == 0 launches nothing.
int gst_multigrid_step(int device, void* const* ptrs, int lanes,
                       int max_steps, int max_raw, int autoreset, int obs,
                       int act64, void* stream) {
  if (lanes < 0 || (obs && max_raw < 1)) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  MixedArgs a;
  for (int f = 0; f < 7; ++f) a.f[f] = static_cast<const int32_t*>(ptrs[f]);
  a.key = static_cast<const int64_t*>(ptrs[7]);
  a.aa = ptrs[8];
  a.ab = ptrs[9];
  for (int f = 0; f < 5; ++f)
    a.geo[f] = static_cast<const int32_t*>(ptrs[10 + f]);
  a.slip = static_cast<const float*>(ptrs[15]);
  a.raw_to_dense = static_cast<const int32_t*>(ptrs[16]);
  a.offsets = static_cast<const int32_t*>(ptrs[17]);
  a.out_i = static_cast<int32_t*>(ptrs[18]);
  a.out_f = static_cast<float*>(ptrs[19]);
  a.out_b = static_cast<bool*>(ptrs[20]);
  a.max_steps = max_steps;
  a.max_raw = max_raw;
  a.lanes = lanes;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool act = act64 != 0;
  if (autoreset)
    obs ? launch_mixed<true, true>(act, blocks, st, a)
        : launch_mixed<true, false>(act, blocks, st, a);
  else
    obs ? launch_mixed<false, true>(act, blocks, st, a)
        : launch_mixed<false, false>(act, blocks, st, a);
  return (int)cudaGetLastError();
}

// S3.  ptrs: 16 device pointers, each array contiguous: the eight int32
// [lanes] state fields (ra, ca, rb, cb, poss, turn, t, n), the int64
// [lanes, 2] key words, the [lanes] action array (int64 if act64, else
// int32), the alternating tables' raw_to_dense int32 [n_raw], isd_fields
// int32 [nI, 5], isd_cum float32 [nI], then the outputs: int32 [10, lanes],
// float32 [lanes], bool [2, lanes].  params: the host's Params (a type
// of this file alone, so the C entry takes it as void*).  Launches on
// `stream` and returns its cudaError_t (0 on success); lanes == 0 launches
// nothing.
int gst_alt_step(int device, void* const* ptrs, const void* params,
                 int lanes, int autoreset, int act64, void* stream) {
  const Params& g = *static_cast<const Params*>(params);
  if (lanes < 0 || g.nI < 1) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  AltArgs a;
  for (int f = 0; f < 8; ++f) a.f[f] = static_cast<const int32_t*>(ptrs[f]);
  a.key = static_cast<const int64_t*>(ptrs[8]);
  a.a = ptrs[9];
  a.raw_to_dense = static_cast<const int32_t*>(ptrs[10]);
  a.isd_fields = static_cast<const int32_t*>(ptrs[11]);
  a.isd_cum = static_cast<const float*>(ptrs[12]);
  a.out_i = static_cast<int32_t*>(ptrs[13]);
  a.out_f = static_cast<float*>(ptrs[14]);
  a.out_b = static_cast<bool*>(ptrs[15]);
  a.g = g;
  a.lanes = lanes;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  autoreset ? launch_alt<true>(act64 != 0, blocks, st, a)
            : launch_alt<false>(act64 != 0, blocks, st, a);
  return (int)cudaGetLastError();
}

// Lanes a block and sizeof(Params), for the wrapper's checks.
void gst_mixed_alt_shape(int* shape) {
  shape[0] = kThreads;
  shape[1] = (int)sizeof(Params);
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
