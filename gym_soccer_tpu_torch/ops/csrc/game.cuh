// Device code of the soccer game shared by the port's CUDA kernels
// (step_kernel.cu: K1, K2, K3, K4; learner_kernel.cu: K5, K6, K7;
// iql_kernel.cu: K8, K9; altq_kernel.cu: K10, K11; the batched engines'
// steps, engine_kernel.cu: S1 and mixed_alt_kernel.cu: S2, S3), and the
// host helpers that describe a game to them.  The parity kernels K12/K13
// (parity_kernel.cu) step by table lookup and include none of it.
//
// Every function here but the engines' step section is integer arithmetic
// on uint32/int32, written to give the same bits as
// gym_soccer_tpu/ops/step_kernel.py's `_random_word`, `transition_core`,
// `alt_transition_core` and `autoreset_core` and as the plain PyTorch
// versions in ops/step_kernel.py; that section compares float32 uniforms
// and sums exact float32 weights as core/batch.step_plain does.
//
// The game functions take any geometry G with the fields H, W, glo, ghi,
// q_int, max_steps and nI: a `Game`, one board shared by every lane (its ISD
// entries listed in `build_isd` order), or a `LaneGame`, a lane's own board
// read from per-lane geometry planes (K6, and the previous designs of K3
// and K7-multigrid that ops/*_variants.py time; its ISD entries computed
// arithmetically, as step_kernel._isd_fields_arith does).  Only the ISD
// pick differs.  The split mixed-geometry kernels (K3, K7-multigrid) walk
// pipeline.cuh's LaneBoard instead.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gst {

constexpr int kMaxIsd = 4;

struct Game {
  int H, W, glo, ghi;  // board height, width incl. goal columns, goal rows
  int q_int;           // round(slip_prob * 65536)
  int max_steps;
  int nI;              // number of ISD entries (4 or 2)
  int isd[kMaxIsd][5]; // ISD entries as (ra, ca, rb, cb, p)
};

// A lane's own board (step_kernel.GeoPlanes): no ISD table, whose 20
// registers a thread would carry through its whole step loop.
struct LaneGame {
  int H, W, glo, ghi, q_int, max_steps;
  int nI;  // 4 for even H, 2 for odd H
};

struct Planes {
  int32_t* f[6];  // ra, ca, rb, cb, p, t
};

// The alternating game's state planes (K4, K10, K11).
struct AltPlanes {
  int32_t* f[7];  // ra, ca, rb, cb, p, turn, t
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

template <class G>
__device__ __forceinline__ bool in_goal_rows(int x, const G& g) {
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

template <class G>
__device__ __forceinline__ void next_cell(int x, int y, int mc, int mr,
                                          bool ball, const G& g,
                                          int& nx, int& ny) {
  nx = min(max(x + mr, 0), g.H - 1);
  const int nyt = y + mc;
  const bool xoob = nyt == 0 || nyt == g.W - 1;
  const bool goal = xoob && in_goal_rows(nx, g) && ball;
  ny = (xoob && !goal) ? y : nyt;
}

// One game transition under chosen actions (step_kernel.transition_core).
template <class G>
__device__ __forceinline__ void transition(State& s, int aa, int ab,
                                           uint32_t bits1, uint32_t bits2,
                                           const G& g, bool& goal,
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

// One tick of the alternating game under the mover's chosen action a
// (step_kernel.alt_transition_core): the mover (A at turn 0) takes its
// slipped move on the low 16 bits of bits1; stepping into the opponent
// bounces it back and hands the opponent the ball; then the goal check on
// the carrier's cell.  The caller flips the turn.
template <class G>
__device__ __forceinline__ void alt_transition(State& s, int turn, int a,
                                               uint32_t bits1, const G& g,
                                               bool& goal, int& r) {
  int mc, mr;
  slipped_move(a, u16(bits1, 0), g.q_int, mc, mr);
  const bool a_moves = turn == 0;
  const int mx = a_moves ? s.ra : s.rb, my = a_moves ? s.ca : s.cb;
  const int ox = a_moves ? s.rb : s.ra, oy = a_moves ? s.cb : s.ca;
  int nx, ny;
  next_cell(mx, my, mc, mr, s.p == turn, g, nx, ny);
  if (nx == ox && ny == oy) {
    nx = mx;
    ny = my;
    s.p = 1 - turn;
  }
  if (a_moves) { s.ra = nx; s.ca = ny; } else { s.rb = nx; s.cb = ny; }

  const bool a_ball = s.p == 0;
  const int ball_col = a_ball ? s.ca : s.cb;
  const bool gr = a_ball ? in_goal_rows(s.ra, g) : in_goal_rows(s.rb, g);
  goal = gr && (ball_col == 0 || ball_col == g.W - 1);
  r = goal ? (ball_col == g.W - 1 ? 1 : -1) : 0;
}

// ---- The batched engines' step (engine_kernel.cu: S1; mixed_alt_kernel.cu:
// S2, S3), on float32 uniforms and thresholds as core/batch.step_plain ----

// Slip variant of a uniform u (batch._slip_variant): 0 (the intended move)
// if u < keep = f32(1 - q), 1 (the first orthogonal) if u < first =
// f32(1 - q / 2), else 2.
__device__ __forceinline__ int slip_variant(float u, float keep,
                                            float first) {
  return u < keep ? 0 : (u < first ? 1 : 2);
}

// (dcol, drow) of action a under slip variant v (batch._slipped_move_arith).
__device__ __forceinline__ void variant_move(int a, int v, int& mc,
                                             int& mr) {
  const int mc0 = (a == 3) - (a == 4);
  const int mr0 = (a == 2) - (a == 1);
  mc = v == 0 ? mc0 : (v == 1 ? -mr0 : mr0);
  mr = v == 0 ? mr0 : (v == 1 ? mc0 : -mc0);
}

// rules.is_goal_state: the ball's carrier on a goal row in a goal column.
template <class G>
__device__ __forceinline__ bool is_goal_state(const State& s, const G& g) {
  return (s.p == 0 && in_goal_rows(s.ra, g) && (s.ca == 0 || s.ca == g.W - 1))
      || (s.p == 1 && in_goal_rows(s.rb, g) && (s.cb == 0 || s.cb == g.W - 1));
}

// One simultaneous step of rules.resolve_outcomes under the slipped moves
// (mca, mra), (mcb, mrb) and the original actions aa, ab, the outcome slot
// k drawn by u2: k = the count of the float32 prefix sums of the slots'
// weights (0, 0.25, 0.5 or 1, so the sums are exact) that are <= u2, at
// most 3.  Slot 0: A moves on a clean move, B on a race or a clean move;
// slot 1: both bounce (B moves on a race), B holds the ball; slots 2, 3: A
// moves, B bounces, the ball with A, then with B.  A goal state stays put
// (was_goal).  Writes the new cells and possession into s and returns the
// slot's weight (1 in a goal state).
template <class G>
__device__ __forceinline__ float resolve_step(State& s, int aa, int ab,
                                              int mca, int mra, int mcb,
                                              int mrb, float u2, const G& g,
                                              bool& was_goal) {
  const int xa = s.ra, ya = s.ca, xb = s.rb, yb = s.cb, p = s.p;
  int nxa, nya, nxb, nyb;
  next_cell(xa, ya, mca, mra, p == 0, g, nxa, nya);
  next_cell(xb, yb, mcb, mrb, p == 1, g, nxb, nyb);
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
  was_goal = is_goal_state(s, g);
  float w0 = (c1 || c3) ? 0.5f : (c4 ? 0.25f : 1.0f);
  float w1 = c4 ? 0.25f : ((c1 || c3) ? 0.5f : 0.0f);
  float w2 = c4 ? 0.25f : 0.0f;
  if (was_goal) w0 = 1.0f, w1 = 0.0f, w2 = 0.0f;
  const float s1 = __fadd_rn(w0, w1), s2 = __fadd_rn(s1, w2);
  const float s3 = __fadd_rn(s2, w2);
  const int k = min((w0 <= u2) + (s1 <= u2) + (s2 <= u2) + (s3 <= u2), 3);
  if (was_goal) return 1.0f;
  if (k == 0) {
    s.ra = c5 ? nxa : xa;
    s.ca = c5 ? nya : ya;
    s.rb = (c4 || c5) ? nxb : xb;
    s.cb = (c4 || c5) ? nyb : yb;
    s.p = c2 ? 1 - p : (c5 ? p : 0);
    return w0;
  }
  if (k == 1) {
    s.rb = c4 ? nxb : xb;
    s.cb = c4 ? nyb : yb;
    s.p = 1;
    return w1;
  }
  s.ra = nxa, s.ca = nya;
  s.p = k == 2 ? 0 : 1;
  return w2;
}

// ISD entry idx of a shared board: the listed entries.
__device__ __forceinline__ void isd_entry(State& s, int idx, const Game& g) {
#pragma unroll
  for (int k = 0; k < kMaxIsd; ++k) {
    if (k == idx) {
      s.ra = g.isd[k][0]; s.ca = g.isd[k][1];
      s.rb = g.isd[k][2]; s.cb = g.isd[k][3];
      s.p = g.isd[k][4];
    }
  }
}

// ISD entry idx of a lane's own board, arithmetically
// (step_kernel._isd_fields_arith): players in columns 2 and W - 3 on the
// middle rows (even H: entries 2 and 3 swap the two rows), possession
// idx % 2.
__device__ __forceinline__ void isd_entry(State& s, int idx,
                                          const LaneGame& g) {
  const bool swap = (g.H % 2) == 0 && idx / 2 == 1;
  const int mid_hi = g.H / 2, mid_lo = (g.H - 1) / 2;
  s.ra = swap ? mid_hi : mid_lo;
  s.rb = swap ? mid_lo : mid_hi;
  s.ca = 2;
  s.cb = g.W - 3;
  s.p = idx % 2;
}

// Truncation and reset to ISD entry u16(bits2, 1) % nI
// (step_kernel.autoreset_core).  Returns the ISD index drawn.
template <class G>
__device__ __forceinline__ int autoreset(State& s, bool goal, uint32_t bits2,
                                         const G& g, bool& trunc) {
  s.t += 1;
  trunc = s.t >= g.max_steps && !goal;
  const int idx = u16(bits2, 1) % g.nI;
  if (goal || trunc) {
    isd_entry(s, idx, g);
    s.t = 0;
  }
  return idx;
}

// Number of valid board cells (rules.n_cells).
template <class G>
__device__ __forceinline__ int n_cells(const G& g) {
  return (g.W - 2) * g.H + 2 * (g.ghi - g.glo + 1);
}

// Closed-form rank of a valid cell (rules.cell_encode).
template <class G>
__device__ __forceinline__ int cell_encode(int r, int c, const G& g) {
  const int ni = (g.W - 2) * g.H;
  if (c == 0) return ni + r - g.glo;
  if (c == g.W - 1) return ni + r - g.glo + (g.ghi - g.glo + 1);
  return (c - 1) * g.H + r;
}

// Compact state code (rules.cellpair_encode).
template <class G>
__device__ __forceinline__ int cellpair_encode(const State& s, const G& g,
                                               int nc) {
  const int a = cell_encode(s.ra, s.ca, g);
  const int b = cell_encode(s.rb, s.cb, g);
  return (a * (nc - 1) + (b > a ? b - 1 : b)) * 2 + s.p;
}

// Sum three per-thread counters over the block; one atomicAdd per counter
// per block.  blockDim.x must be a multiple of 32 (checked by `prepare`).
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

// Lane `lane`'s board from the geometry planes H, W, glo, ghi, q_int (the
// sixth plane is the caller's: a variant id or a table row offset).
__device__ __forceinline__ LaneGame lane_game(const Planes& geo, int lane,
                                              int max_steps) {
  LaneGame g;
  g.H = geo.f[0][lane]; g.W = geo.f[1][lane];
  g.glo = geo.f[2][lane]; g.ghi = geo.f[3][lane];
  g.q_int = geo.f[4][lane];
  g.max_steps = max_steps;
  g.nI = g.H % 2 == 0 ? 4 : 2;
  return g;
}

// params: H, W, glo, ghi, q_int, max_steps, nI, then nI x 5 ISD fields.
inline Game make_game(const int32_t* params) {
  Game g{};
  g.H = params[0]; g.W = params[1]; g.glo = params[2]; g.ghi = params[3];
  g.q_int = params[4]; g.max_steps = params[5]; g.nI = params[6];
  for (int k = 0; k < g.nI && k < kMaxIsd; ++k)
    for (int f = 0; f < 5; ++f) g.isd[k][f] = params[7 + 5 * k + f];
  return g;
}

inline Planes make_planes(void* const* ptrs) {
  Planes p;
  for (int i = 0; i < 6; ++i) p.f[i] = static_cast<int32_t*>(ptrs[i]);
  return p;
}

inline AltPlanes make_alt_planes(void* const* ptrs) {
  AltPlanes p;
  for (int i = 0; i < 7; ++i) p.f[i] = static_cast<int32_t*>(ptrs[i]);
  return p;
}

// Shared launch checks of the kernels whose block is `threads` threads,
// one a lane (K3-K11; K1/K2 check their lanes per block in
// step_kernel.cu), and the device the tensors live on.
inline cudaError_t check_launch(int device, int B, int threads) {
  if (B <= 0 || threads <= 0 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

// check_launch, a check of the game description, and the zeroing of the
// stats sums.
inline cudaError_t prepare(int device, const int32_t* params, int B,
                           int threads, long long* stats, cudaStream_t st) {
  if (params[6] < 1 || params[6] > kMaxIsd) return cudaErrorInvalidValue;
  cudaError_t e = check_launch(device, B, threads);
  if (e != cudaSuccess) return e;
  return cudaMemsetAsync(stats, 0, 3 * sizeof(long long), st);
}

}  // namespace gst
