// Batched 5x5 zero-sum matrix-game solve by Regret Matching+ for Hopper
// (sm_90a): kernel R1.
//
// It has no Pallas counterpart: the JAX package computes RM+ with XLA ops
// (gym_soccer_tpu/agents/learners.py `solve_matrix_games`), and the port's
// plain version (agents/learners.py `solve_matrix_games_plain`) follows
// those ops one by one.  The minimax trainers re-solve every state's game
// between chunks (761 games on 5x4, 11705 on 11x7) and `shapley_iteration`
// once a sweep; the plain version issues ~38 PyTorch ops an iteration,
// ~15,000 launches a 400-iteration solve, which would also be the nodes of
// a CUDA graph of the trainers' work between chunks.  R1 runs all the
// iterations of a game in one launch.
//
// What it computes, for each game M[g] (float32, row-major 5x5), with
// x, y the row maximizer's and the column minimizer's strategies, R the
// cumulative regrets (rx, ry) and S the weighted strategy sums (sx, sy),
// all zero at the start, for t = 0 .. iters-1:
//   s = sum_i R[i] in index order; X = s > 0 ? R / max(s, 1e-30) : 0.2
//   pay_x = M y, pay_y = x M, each a chain of float32 FMAs over j
//   vx = sum_i x[i] * pay_x[i] (rounded products, sums in index order)
//   rx = max(rx + (pay_x - vx), 0); ry = max(ry - (pay_y - vx), 0)
//   S = float32(double(X) * (t + 1) + double(S))
// then x = sx / sum(sx), y = sy / sum(sy) and value = sum_i (x M)_i y[i].
// iters == 0 gives 0 / 0: NaN strategies, as the plain version gives.
//
// Design: a game runs on a group of kLanes lanes of one warp.  Only the
// sums over actions (s, vx, the final sum(S) and the value) couple the
// actions; everything else is ten independent values.  At kLanes = 10
// lane (p, i) owns player p's action i: its regret, its strategy sum and
// the row i of M (p = 0, for (M y)[i]) or its column i (p = 1, for
// (x M)[i]), converted to float64 once, before the loop.  An iteration is
// three rounds of shuffles: the player's regrets for its sum, the shares
// for the other player's FMA chains (each owner converts its share to
// float64 once, and the readers shuffle that), and the products
// x[i] * (M y)[i] for vx.  Three games fill 30 lanes of a warp; the two
// spare lanes shadow the warp's last game, as a game past the last
// shadows the last game, so that every lane takes part in the full-mask
// shuffles, and write nothing.  kLanes = 5 (lane i owns action i of both
// players, six games a warp, two interleaved chains a lane) is a variant:
// on an H100 80GB HBM3 at 700 W it took 1.33x as long at the 5x4
// contract's 761 games x 400 iterations and was 2 % faster at the 11x7
// contract's 11705 x 600 (ops/rmplus_variants.py), far from the 1.2x that
// would pay for a switch by game count.  Three choices each cut the time
// at 761 x 400 there: every lane divides (`share`), 0.101 -> 0.089 ms; the
// owners convert the shares to float64, 0.094 -> 0.089 ms (0.419 -> 0.359
// at 11705 x 600); the weight is counted in float64 rather than converted
// from t, within 2 %.
//
// Exactness: the plain version's arithmetic is fixed operation by
// operation, so R1 equals it bit for bit.  Every sum over actions is
// computed by every lane of the group from the five values read through
// __shfl_sync, added in index order as the plain version adds them (no
// tree, no __reduce_*), so all the lanes hold the same bits.  An FMA-chain
// step (`_fma_dot`) is the product of two float32, exact in float64, added
// to the float32 accumulator in float64 and rounded to float32: one
// float64 FMA (the product is exact, so fusing it rounds nothing) and a
// conversion; the chain's first step is the rounded float32 product.  The
// averaging step is likewise one float64 FMA (a float32 times t + 1 <
// 2^24 is exact).  Every float32 product, sum and quotient is written with
// an explicit rounding intrinsic, so that nvcc's default -fmad=true cannot
// contract s + a * b into an FMA; the clamp keeps a NaN as torch's
// clamp_min does.
//
// What bounds it on this card: at the contract's 761 games (254 warps,
// about two an SM) the latency of an iteration's dependent chain, which
// the split cuts from one thread's ~2,700 cycles (ten divisions and ten
// FMA chains a game: the previous design, csrc/rmplus_thread_kernel.cu) to
// three shuffle rounds, a 4-add sum, one division, one 4-step float64
// chain (each step a conversion, an FMA and a conversion back), vx and the
// update: ~440 cycles an iteration, of which the chain's conversions
// take ~100; at 11705 games (~7 warps a scheduler) the issue of the
// float32 <-> float64 conversions (11 a lane-iteration, at a quarter of
// the float64 FMA rate) and of the shuffles.  The games' 100 B each are
// read once; there is nothing else to move.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kA = 5;                  // actions a player
constexpr int kLanes = 10;             // lanes a game: 10 or 5
constexpr int kGames = 32 / kLanes;    // games a warp
constexpr int kOwn = 2 * kA / kLanes;  // (player, action) pairs a lane owns
constexpr int kWarps = 1;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kWarp = 0xffffffffu;

// The lane of the game's group starting at lane `base` that owns player
// p's action j.
__device__ __forceinline__ int owner(int base, int p, int j) {
  return base + (kLanes == kA ? j : kA * p + j);
}

// The slot of a lane's values that holds player p's: at kLanes = 10 a lane
// holds its one player's in slot 0.
__device__ __forceinline__ int slot(int p) { return kLanes == kA ? p : 0; }

// sum_j v(p, j) over player p's actions in index order, `v` the lane's
// value of player p: every lane reads the five values from their owners
// and adds them as the plain version's index-order sum does.
__device__ __forceinline__ float group_sum(float v, int base, int p) {
  float s = __shfl_sync(kWarp, v, owner(base, p, 0));
#pragma unroll
  for (int j = 1; j < kA; ++j)
    s = __fadd_rn(s, __shfl_sync(kWarp, v, owner(base, p, j)));
  return s;
}

// One step of `_fma_dot`'s chain: float32(p * double(z) + acc), p and z
// float32 values held in float64.
__device__ __forceinline__ float chain(float acc, double p, double z) {
  return __double2float_rn(__fma_rn(p, z, (double)acc));
}

// The RM+ share of regret r, s the sum of its player's regrets: r / s, or
// uniform if the sum is not positive, as IEEE division rounds it.  A zero
// regret's share is the regret itself (0 / d for d > 0, with its sign).
// Every lane divides, a zero regret d by d: RM+ clamps many regrets to
// zero, and a branch around their division split the group's lanes, while
// __fdiv_rn of a zero takes its slow path.
__device__ __forceinline__ float share(float r, float s) {
  const float d = fmaxf(s, 1e-30f);
  const float q = __fdiv_rn(r == 0.0f ? d : r, d);
  return s > 0.0f ? (r == 0.0f ? r : q) : 0.2f;
}

// torch.clamp_min(v, 0) on the card: a NaN stays NaN.
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// A payoff against player q's shares, read from their owners: the FMA
// chain over j from j = 0 of the lane's row or column of M (m0 its first
// entry, md the others in float64), its first step the float32 product
// with the share z, the others with the share in float64, zd, which its
// owner converted once.
__device__ __forceinline__ float payoff(float m0, const double (&md)[kA - 1],
                                        float z, double zd, int base, int q) {
  float acc = __fmul_rn(m0, __shfl_sync(kWarp, z, owner(base, q, 0)));
#pragma unroll
  for (int j = 1; j < kA; ++j)
    acc = chain(acc, md[j - 1], __shfl_sync(kWarp, zd, owner(base, q, j)));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    rmplus_kernel(const float* __restrict__ games, int n_games, int iters,
                  float* __restrict__ value, float* __restrict__ xs,
                  float* __restrict__ ys) {
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const bool spare = lane >= kGames * kLanes;
  const int group = spare ? kGames - 1 : lane / kLanes;
  const int sub = spare ? lane - kGames * kLanes : lane % kLanes;
  const int base = group * kLanes;
  const int action = sub % kA;
  const int me = sub / kA;               // the lane's player at kLanes = 10
  const int first = warp * kGames + group;
  const bool writes = !spare && first < n_games;
  const size_t g = min(first, n_games - 1);
  // slot k's player: k at kLanes = 5, the lane's at kLanes = 10
  int player[kOwn];
  float m0[kOwn], r[kOwn], s[kOwn], z[kOwn], pay[kOwn];
  double md[kOwn][kA - 1], zd[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    player[k] = kLanes == kA ? k : me;
    const float* m = games + g * kA * kA;
    // player 0's payoff for action i is row i of M, player 1's column i
    const int at = player[k] == 0 ? action * kA : action;
    const int step = player[k] == 0 ? 1 : kA;
    m0[k] = m[at];
#pragma unroll
    for (int j = 1; j < kA; ++j) md[k][j - 1] = (double)m[at + j * step];
    r[k] = s[k] = 0.0f;
  }
  double w = 0.0;   // the averaging weight t + 1, counted in float64
#pragma unroll 1
  for (int t = 0; t < iters; ++t) {
    w = __dadd_rn(w, 1.0);
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      z[k] = share(r[k], group_sum(r[k], base, player[k]));
      zd[k] = (double)z[k];
    }
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int q = 1 - player[k];
      pay[k] = payoff(m0[k], md[k], z[slot(q)], zd[slot(q)], base, q);
    }
    // vx = sum_i x[i] * (M y)[i]: player 0's owners round the products
    const float vx = group_sum(__fmul_rn(z[0], pay[0]), base, 0);
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const float d = __fsub_rn(pay[k], vx);
      r[k] = clamp0(__fadd_rn(r[k], player[k] == 0 ? d : -d));
      s[k] = __double2float_rn(__fma_rn(zd[k], w, (double)s[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    z[k] = __fdiv_rn(s[k], group_sum(s[k], base, player[k]));
    zd[k] = (double)z[k];
  }
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int q = 1 - player[k];
    pay[k] = payoff(m0[k], md[k], z[slot(q)], zd[slot(q)], base, q);
  }
  // value = sum_i (x M)[i] * y[i], from player 1's owners
  const float v = group_sum(__fmul_rn(pay[slot(1)], z[slot(1)]), base, 1);
  if (!writes) return;
#pragma unroll
  for (int k = 0; k < kOwn; ++k)
    (player[k] == 0 ? xs : ys)[g * kA + action] = z[k];
  if (sub == 0) value[g] = v;
}

}  // namespace

extern "C" {

// R1.  games: device float32 [n_games, 5, 5], contiguous; out: device
// float32 [11 * n_games]: the values [n_games], then x [n_games, 5], then
// y [n_games, 5]; iters >= 0.  Launches on `stream` and returns its
// cudaError_t (0 on success); n_games == 0 launches nothing.
int gst_rmplus_solve(int device, const float* games, int n_games, int iters,
                     float* out, void* stream) {
  if (n_games < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (n_games == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_games + kGames * kWarps - 1) / (kGames * kWarps);
  rmplus_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      games, n_games, iters, out, out + n_games, out + 6 * (size_t)n_games);
  return (int)cudaGetLastError();
}

// The launch's shape: lanes a game, games a warp, warps a block.
void gst_rmplus_shape(int* shape) {
  shape[0] = kLanes;
  shape[1] = kGames;
  shape[2] = kWarps;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
