// Device code shared by the split rollout and learner kernels (step_kernel.cu:
// K1, K2, K3, K4; learner_kernel.cu: K5, K6, K7; iql_kernel.cu: K8, K9;
// altq_kernel.cu: K10, K11): the pieces of a lane-step that follow from
// (seed, step, lane) alone, the named barriers and bulk copies (TMA) of the
// producer/consumer pipeline, the branch-free transitions under effective
// moves, and a lane's own board as the mixed-geometry kernels (K3, K6, K7
// multigrid) walk it.
//
// A kernel that includes it splits each lane-step in two: producer warps
// hash the counter words into a small step code and hand tiles of codes
// over through a ring in shared memory on named barriers; one consumer
// thread per lane walks its state through the codes, by a table in shared
// memory (copied in by bulk copies while the producers start) or by
// arithmetic.  Every function here is integer arithmetic, bit-equal to
// ops/step_kernel.py and ops/rollout_codes.py.

#pragma once

#include "game.cuh"

namespace gst {

// u16 % nI without a division (rollout_codes.isd_pick): u & (nI - 1) for
// nI 1, 2 and 4 (mask), a multiply-high for 3 (kMod3).
template <bool kMod3>
__device__ __forceinline__ int isd_pick(int u, int mask) {
  return kMod3 ? u - 3 * (int)(((uint32_t)u * 43691u) >> 17) : (u & mask);
}

// The action whose move slipped_move(a, u, q) makes: a, or its first or
// second orthogonal, one nibble per action (rollout_codes.effective_move).
__device__ __forceinline__ int effective_move(int a, int u, int t_keep,
                                              int t_half) {
  const int orth = ((u < t_half ? 0x12430 : 0x21340) >> (4 * a)) & 7;
  return u < t_keep ? a : orth;
}

// random_word's key of word 0 at `step`: the words' keys are c0, c0 + K
// and c0 + 2K.
__device__ __forceinline__ uint32_t step_key(uint32_t seed, uint32_t step) {
  return seed * 0x9E3779B9u + step * 0x85EBCA77u;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0: the mbarrier at `bar` (initialised for one arrival) expects
// `bytes` of bulk copies.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Thread 0: `bytes` (a multiple of 16) from global to shared memory by
// bulk copies (TMA) that complete on the mbarrier at `bar`; the producers
// start meanwhile.
__device__ __forceinline__ void bulk_copy(uint64_t* bar, void* dst,
                                          const void* src, int bytes) {
  const uint32_t b = smem_addr(bar);
  constexpr int kChunk = 1 << 15;
  for (int off = 0; off < bytes; off += kChunk)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr((char*)dst + off)),
        "l"((const char*)src + off), "r"(min(kChunk, bytes - off)), "r"(b)
        : "memory");
}

__device__ __forceinline__ void wait_table(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

// A shared-memory load issued where it stands (not sunk under the
// predicate of its use).
__device__ __forceinline__ int lds(const int* p) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}

// One transition of the arithmetic walk under effective moves ea, eb
// (actions after the slip; a move is (0, 0) exactly when its action is 0)
// and the coin bits: game.cuh's `transition` after its slips, written
// without short-circuits, so that it compiles to selects.  G: any geometry
// with the fields H, W, glo, ghi (a Game, a LaneBoard).
template <class G>
__device__ __forceinline__ void step_moves(State& s, int ea, int eb, int coin,
                                           const G& g, bool& goal, int& r) {
  const int ra = s.ra, ca = s.ca, rb = s.rb, cb = s.cb, p = s.p;
  const int nxa = min(max(ra + (ea == 2) - (ea == 1), 0), g.H - 1);
  const int nxb = min(max(rb + (eb == 2) - (eb == 1), 0), g.H - 1);
  const int ya = ca + (ea == 3) - (ea == 4), yb = cb + (eb == 3) - (eb == 4);
  const bool oa = (ya == 0) | (ya == g.W - 1), ob = (yb == 0) | (yb == g.W - 1);
  const bool ina = (oa & (nxa >= g.glo) & (nxa <= g.ghi) & (p == 0)) | !oa;
  const bool inb = (ob & (nxb >= g.glo) & (nxb <= g.ghi) & (p == 1)) | !ob;
  const int nya = ina ? ya : ca, nyb = inb ? yb : cb;
  const bool a_onto_b = (nxa == rb) & (nya == cb);
  const bool b_onto_a = (nxb == ra) & (nyb == ca);
  const bool c1 = ((ra == rb) & (abs(ca - cb) == 1) & (nya == cb) & (nyb == ca)) |
                  ((ca == cb) & (abs(ra - rb) == 1) & (nxa == rb) & (nxb == ra));
  const bool c2 = !c1 & ((a_onto_b & (eb == 0)) | (b_onto_a & (ea == 0)));
  const bool c3 = !c1 & !c2 &
                  (((ra == nxa) & (ca == nya) & (ea != 0) & b_onto_a) |
                   ((rb == nxb) & (cb == nyb) & (eb != 0) & a_onto_b));
  const bool c4 = !c1 & !c2 & !c3 & (nxa == nxb) & (nya == nyb);
  const bool c5 = !(c1 | c2 | c3 | c4);
  const bool who = (coin >> 1) & 1;
  const bool a_moves = c5 | (c4 & who), b_moves = c5 | (c4 & !who);
  s.ra = a_moves ? nxa : ra;
  s.ca = a_moves ? nya : ca;
  s.rb = b_moves ? nxb : rb;
  s.cb = b_moves ? nyb : cb;
  s.p = c2 ? 1 - p : ((c1 | c3 | c4) ? (coin & 1) : p);
  const bool a_ball = s.p == 0;
  const int ball_row = a_ball ? s.ra : s.rb, ball_col = a_ball ? s.ca : s.cb;
  goal = (ball_row >= g.glo) & (ball_row <= g.ghi) &
         ((ball_col == 0) | (ball_col == g.W - 1));
  r = goal ? (ball_col == g.W - 1 ? 1 : -1) : 0;
}

// One tick of the alternating game under the mover's effective move e
// (K4, K10, K11): game.cuh's `alt_transition` after its slip, without
// branches.
__device__ __forceinline__ void alt_moves(State& s, int turn, int e,
                                          const Game& g, bool& goal, int& r) {
  const int mc = (e == 3) - (e == 4), mr = (e == 2) - (e == 1);
  const bool a_moves = turn == 0;
  const int mx = a_moves ? s.ra : s.rb, my = a_moves ? s.ca : s.cb;
  const int ox = a_moves ? s.rb : s.ra, oy = a_moves ? s.cb : s.ca;
  const int nx0 = min(max(mx + mr, 0), g.H - 1), nyt = my + mc;
  const bool xoob = (nyt == 0) | (nyt == g.W - 1);
  const bool in_goal = xoob & (nx0 >= g.glo) & (nx0 <= g.ghi) & (s.p == turn);
  const int ny0 = (xoob & !in_goal) ? my : nyt;
  const bool collide = (nx0 == ox) & (ny0 == oy);
  const int nx = collide ? mx : nx0, ny = collide ? my : ny0;
  s.p = collide ? 1 - turn : s.p;
  s.ra = a_moves ? nx : s.ra;
  s.ca = a_moves ? ny : s.ca;
  s.rb = a_moves ? s.rb : nx;
  s.cb = a_moves ? s.cb : ny;
  const bool a_ball = s.p == 0;
  const int ball_row = a_ball ? s.ra : s.rb, ball_col = a_ball ? s.ca : s.cb;
  goal = (ball_row >= g.glo) & (ball_row <= g.ghi) &
         ((ball_col == 0) | (ball_col == g.W - 1));
  r = goal ? (ball_col == g.W - 1 ? 1 : -1) : 0;
}

// The table walk starts from, and stays among, these states (the
// reachable non-goal ones; rollout_codes.walkable).
__device__ __forceinline__ bool walkable(const State& s, const Game& g) {
  const bool a = s.ra >= 0 && s.ra < g.H && s.ca >= 1 && s.ca <= g.W - 2;
  const bool b = s.rb >= 0 && s.rb < g.H && s.cb >= 1 && s.cb <= g.W - 2;
  return a && b && (s.ra != s.rb || s.ca != s.cb) && (s.p == 0 || s.p == 1);
}

__device__ __forceinline__ State isd_state(const Game& g, int k) {
  return State{g.isd[k][0], g.isd[k][1], g.isd[k][2], g.isd[k][3],
               g.isd[k][4], 0};
}

// A consumer warp's three sums, one 64-bit atomicAdd each.
__device__ __forceinline__ void warp_sum(long long* stats, int a, int b,
                                         int c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xFFFFFFFFu, a, off);
    b += __shfl_down_sync(0xFFFFFFFFu, b, off);
    c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 0),
              (unsigned long long)(long long)a);
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 1),
              (unsigned long long)(long long)b);
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 2),
              (unsigned long long)(long long)c);
  }
}


// The block's mbarrier, thread 0: initialised for one arrival and made
// visible to the bulk copies.
__device__ __forceinline__ void init_bar(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// A lane's own board as the split mixed-geometry kernels (K3, K7
// multigrid) walk it, in registers: the geometry step_moves and
// cellpair_encode read, the truncation length, and the rows of its ISD
// entries.  An entry's fields are computed, as game.cuh's isd_entry on a
// LaneGame computes them, without its parity test: A at (row idx < 2 ?
// mid_lo : mid_hi, column 2), B on the other middle row at column W - 3,
// possession idx % 2 (an odd board's two rows are one, and its ISD index,
// masked to 1 bit by the producers, is 0 or 1).
struct LaneBoard {
  int H, W, glo, ghi, max_steps;
  int mid_lo, mid_hi;  // (H - 1) / 2, H / 2

  __device__ __forceinline__ void isd(int idx, int (&f)[5]) const {
    const bool swap = (idx >> 1) != 0;
    f[0] = swap ? mid_hi : mid_lo;
    f[1] = 2;
    f[2] = swap ? mid_lo : mid_hi;
    f[3] = W - 3;
    f[4] = idx & 1;
  }
};

// Lane `lane`'s board from the geometry planes (lane_game's).
__device__ __forceinline__ LaneBoard lane_board(const Planes& geo, int lane,
                                                int max_steps) {
  const int H = geo.f[0][lane];
  return LaneBoard{H, geo.f[1][lane], geo.f[2][lane], geo.f[3][lane],
                   max_steps, (H - 1) / 2, H / 2};
}

// What a producer needs of a lane's own board, kept a lane in shared
// memory: the slip thresholds 65536 - q and 65536 - q / 2 of its q_int and
// the ISD mask nI - 1 (nI 4 on an even board, 2 on an odd one).
__device__ __forceinline__ int4 lane_slip(int q_int, int H) {
  return make_int4(65536 - q_int, 65536 - q_int / 2, H % 2 == 0 ? 3 : 1, 0);
}

// Inverse of cell_encode (rules.cell_decode): row r and column c of a
// valid cell's rank.
template <class G>
__device__ __forceinline__ void cell_decode(int k, const G& g, int& r,
                                            int& c) {
  const int ni = (g.W - 2) * g.H, ng = g.ghi - g.glo + 1;
  const bool in = k < ni, left = k - ni < ng;
  r = in ? k % g.H : g.glo + (left ? k - ni : k - ni - ng);
  c = in ? k / g.H + 1 : (left ? 0 : g.W - 1);
}

// Inverse of cellpair_encode: the state fields of a compact code (t 0).
template <class G>
__device__ __forceinline__ State cellpair_decode(int code, const G& g,
                                                 int nc) {
  const int pair = code >> 1, a = pair / (nc - 1), rank = pair % (nc - 1);
  State s{0, 0, 0, 0, code & 1, 0};
  cell_decode(a, g, s.ra, s.ca);
  cell_decode(rank >= a ? rank + 1 : rank, g, s.rb, s.cb);
  return s;
}

}  // namespace gst
