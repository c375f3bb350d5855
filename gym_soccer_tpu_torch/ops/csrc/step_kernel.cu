// Fused random-vs-random rollout kernels for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of gym_soccer_tpu/ops/step_kernel.py:
//   rollout_kernel<false, *> <- `_rollout_kernel` (K1, wrapper
//                               `pallas_rollout`)
//   rollout_kernel<true, *>  <- `_journal_kernel` (K2, wrapper
//                               `pallas_journal_rollout`)
//   mg_rollout_kernel        <- `_mg_rollout_kernel` (K3, wrapper
//                               `pallas_multigrid_rollout`)
//   alt_rollout_kernel<*>    <- `_alt_rollout_kernel` (K4, wrapper
//                               `pallas_alt_rollout`)
//
// All compute, for every lane (one independent game) and every step:
// three murmur3 counter words keyed on (seed, absolute step, word index,
// global lane id), the random joint action, the slipped moves, the
// 4-priority collision chain, goal detection, truncation and the reset to
// an initial-state (ISD) entry, and the per-lane reward/goal/truncation
// sums.  K2 also stores one packed int32 word per lane-step (bit layout in
// step_kernel.py's `_journal_word`).  mg_rollout_kernel steps a mixture of
// boards: each lane reads its own geometry (H, W, goal rows, slip) and
// variant id from planes, resets to its board's ISD computed
// arithmetically, and adds its sums into its variant's row of int64 [nV, 3]
// stats.  Every operation is integer arithmetic on uint32/int32, so the
// outputs are bit-identical to the JAX package and to the plain PyTorch
// versions in step_kernel.py.
//
// K1/K2.  What bounds them on this card: latency, not bandwidth.  8192
// lanes are 256 warps for 528 schedulers, and each lane's 1024 steps are
// one dependent chain.  In the previous design (one thread a lane hashing
// and stepping, 64 blocks of 128) a step took ~1,230 cycles of one warp's
// chain: 0.62 ms on 5x4, 0.57 ms on 11x7.  Most of a step does not depend
// on the state: the three words, the actions, the slips, the coin bits and
// the ISD pick follow from (seed, step, lane) alone.
//
// What the design does about it: it splits a lane-step in two.  Producer
// warps (kProducerWarps a block) hash each (lane, step) into a 16-bit step
// code (rollout_codes.py: the table input (effective move a, effective
// move b, coin bits), the ISD index, the joint action) and hand tiles of
// kTileSteps steps over through a ring of kStages tiles in shared memory,
// on named barriers (kFull, kEmpty).  A producer thread keeps one step
// slot, so its words' keys are made once a tile; the ISD pick is a mask or
// a multiply-high, never a division.  One consumer thread per lane walks
// its state through the codes, tile k + 1 loaded into registers before
// tile k's steps.  On a board whose step table fits one block's shared
// memory (5x4: 1104 compact codes x 100 inputs, 220,800 B, copied in by
// TMA bulk copies while the producers start) a step is one shared load of
// the next code (doubled into a byte offset, so the address is one add)
// with its goal and reward bits, and a select against the reset code; the
// arithmetic walk (boards whose table does not fit, 11x7, and any warp
// holding a lane the table cannot start from) runs the collision chain
// under the decoded moves, without branches, reset fields loaded ahead.
// K2's journal word takes the raw code from shared memory and is stored
// coalesced across the warp, predicated, not branched around.  64 lanes a
// block (threads) gives 128 blocks of 320 threads, one wave on 132 SMs;
// two consumer warps per SM leave the schedulers' spare issue slots to
// the producers.  The bound is now both stages' instruction issue: the
// producers' hashing (~100 SASS a code, on the integer pipes) and the
// consumers' chain.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py)
// an 8192 x 1024 call takes 0.084 ms for K1 on 5x4 (73 us of it the
// kernel; the hashing alone 0.05-0.06 ms, the table walk alone about as
// much), 0.086 ms for K2, and 0.21 / 0.23 ms on 11x7, where the arithmetic
// walk (~240 SASS a lane-step with the hashing) is the longer stage: 7.6-8.3x
// and 2.9x faster than the previous design, at 38-41 % (5x4) and 29 %
// (11x7) of the bound that counts both stages' SASS at the issue rate.
//
// K4 steps the alternating-turn game (envs/soccer_alternating_env): one
// mover a tick (game.cuh `alt_transition`), its random action on the low
// 16 bits of word 0, and a seventh plane, the turn, which flips every tick
// and goes to A (0) on a goal or a truncation.  What bounded it on this
// card was K1/K2's latency: in the previous design (one thread a lane,
// 64 blocks of 128, 68 SMs idle at 8192 lanes) a tick took ~790 cycles of
// one warp's chain for ~133 SASS, 0.39-0.41 ms per 8192 x 1024 call.  Its
// design is now K1/K2's split, with a code and a step of its own.  The
// producers make a 5-bit tick code (AltCode: the mover's effective move
// after the slip, which does not depend on which player moves, and the
// ISD index).  The consumers walk a tick table on 5x4 (1104 codes x 2
// turns x 5 moves, int16 entries holding 2 x (2 x the next code + the next
// turn) with the goal and reward bits, 22,080 B, copied in by bulk copies:
// rollout_codes.build_alt_table), so a tick is one shared load and a
// select against the reset code, the turn carried in the state's index;
// boards whose codes do not fit the entry (11x7) and warps holding a lane
// the table cannot start from walk by a branch-free `alt_moves`.  `threads`
// is lanes per block (64 by default: 128 blocks, one wave).  On an NVIDIA
// H100 80GB HBM3 at 700 W (ops/rollout_variants.py, device time of one
// 8192 x 1024 call) K4 takes 0.0669 ms on 5x4 and 0.1188 ms on 11x7,
// against the previous design's 0.3831 and 0.3657 (5.7x and 3.1x); the
// arithmetic walk on 5x4 takes 0.1189 ms, so the table is worth 1.8x there.  The bound
// is both stages' instruction issue, as for K1/K2.
//
// K3 steps a mixture of boards, lane i on variant i % nV (three boards in
// every warp on the 3-board mixture).  What bounded it was K1/K2's latency:
// in the previous design (one thread a lane hashing and stepping on its
// LaneGame, 64 blocks of 128 at 8192 lanes, 68 SMs idle) an 8192 x 1024
// call took 0.47 ms at 201 SASS per lane-step, 11 % of that bound.  Its
// design is now K1's split with the lane's board.  The producers make K1's
// step code without the joint action (the table input and the ISD index,
// MgCode): the slip thresholds and the ISD mask are the lane's, read from
// a 16-B entry a lane in shared memory that the lane's consumer fills from
// the geometry planes once a block.  One consumer thread per lane walks by
// K1's branch-free arithmetic on its board in registers (LaneBoard: H, W,
// glo, ghi, the ISD rows; there is no step table: 5x4's alone is 220,800
// B), so the mixture costs no divergence; the ISD reset is computed, not
// loaded.  The per-variant sums go to shared memory, then once a block to
// the int64 [nV, 3] stats.  `threads` is lanes per block (64 by default:
// 128 blocks of 320 threads, one wave).  On an NVIDIA H100 80GB HBM3 at
// 700 W (ops/rollout_variants.py, device time of one 8192 x 1024 call on
// the 3-board mixture) K3 takes 0.207 ms against the previous design's
// 0.461 (2.2x), at 239 SASS per lane-step both stages, 27 % of the bound
// that counts them at the issue rate: the walk's dependent chain bounds it,
// as it bounds K1 on 11x7.

#include "pipeline.cuh"

using namespace gst;

namespace {

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

// ---------------------------------------------------------------------
// K1 / K2: producer warps make step codes, consumer threads walk them
// ---------------------------------------------------------------------

constexpr int kTileSteps = 8;       // steps of step codes a ring tile holds
constexpr int kStages = 3;          // tiles in the ring
constexpr int kProducerWarps = 8;   // beside the lanes' (consumer) warps
constexpr int kMaxLanes = 512;      // lanes per block: 768 threads at most
constexpr int kInputs = 100;        // (effective move a, move b, coin)
constexpr int kCodeMask = (1 << 13) - 1;  // table entry: 2 x the next code,
constexpr int kRewardBit = 1 << 13;       // reward +1,
constexpr int kGoalBit = 1 << 15;         // goal
static_assert((32 * kProducerWarps) % kTileSteps == 0,
              "a producer thread keeps one step slot of every tile");
constexpr int kSmemBudget = 232448;
constexpr int kFull = 1;            // named barriers: a tile is written
constexpr int kEmpty = 1 + kStages; // ... and read

struct RolloutArgs {
  Planes in, out;
  long long* stats;
  int32_t* journal;         // [n_steps, B] (K2)
  const int16_t* table;     // [kInputs * n_codes] step table (table path)
  const uint16_t* code_raw; // [n_codes, padded to 8] raw code of each code
  int n_codes, lanes, B, n_steps, step_offset;
  uint32_t seed;
  Game g;
};

// Dynamic shared memory of a block: the table's mbarrier (16 B), the ISD
// entries (kIsdInts ints: their compact codes, then their fields), the step
// table and the raw code of each compact code (n_codes 0: neither; the raw
// codes padded to 16 B) and the ring of step codes
// (ops/rollout_codes.py smem_bytes).
constexpr int kIsdInts = kMaxIsd * 6;
constexpr int kHead = 16 + 4 * kIsdInts;
__host__ __device__ constexpr int raw_bytes(int n_codes) {
  return (2 * n_codes + 15) / 16 * 16;
}
__host__ __device__ constexpr int smem_bytes(int lanes, int n_codes) {
  return kHead + kInputs * 2 * n_codes + raw_bytes(n_codes) +
         kStages * kTileSteps * 2 * lanes;
}

// The step code of the lane at the step keyed c0: table input (ea * 5 + eb)
// * 4 + coin in bits 0-6, the ISD index in bits 7-8, the joint action in
// bits 9-13 (kJoint; K3 keeps no journal and leaves it out).
template <bool kMod3, bool kJoint = true>
__device__ __forceinline__ uint32_t step_code(uint32_t c0, uint32_t lane,
                                              int t_keep, int t_half,
                                              int isd_mask) {
  const uint32_t c1 = c0 + 0xC2B2AE3Du, c2 = c0 + 2u * 0xC2B2AE3Du;
  const uint32_t b0 = fmix32(fmix32(lane ^ c0) + c0);
  const uint32_t b1 = fmix32(fmix32(lane ^ c1) + c1);
  const uint32_t b2 = fmix32(fmix32(lane ^ c2) + c2);
  const int aa = u16(b0, 0) % 5, ab = u16(b0, 1) % 5;
  const int ea = effective_move(aa, u16(b1, 0), t_keep, t_half);
  const int eb = effective_move(ab, u16(b1, 1), t_keep, t_half);
  const int in = (ea * 5 + eb) * 4 + (int)(b2 & 3u);
  const int idx = isd_pick<kMod3>(u16(b2, 1), isd_mask);
  const uint32_t code = (uint32_t)(in | (idx << 7));
  return kJoint ? code | (uint32_t)((aa * 5 + ab) << 9) : code;
}

// The slip thresholds and the ISD mask of the launch's one board, which
// K1/K2's and K4's codes take.
struct BoardSlip {
  int t_keep, t_half, isd_mask;
};

__host__ __device__ inline BoardSlip board_slip(const Game& g) {
  return BoardSlip{65536 - g.q_int, 65536 - g.q_int / 2, g.nI - 1};
}

template <bool kMod3>
struct SimCode {
  BoardSlip b;
  __device__ __forceinline__ uint32_t operator()(uint32_t c0, uint32_t lane,
                                                 int) const {
    return step_code<kMod3>(c0, lane, b.t_keep, b.t_half, b.isd_mask);
  }
};

// Producer thread pt: the step codes of every tile, [lane][step] in the
// tile, each tile handed over on its kFull barrier once its ring slot is
// free again (its kEmpty barrier).  The thread keeps one step slot, pt %
// kTileSteps, so its words' keys are made once a tile.  code(c0, lane, l)
// is the kernel's step code of lane lane0 + l (K1/K2: SimCode, K3: MgCode,
// K4: AltCode).
template <class Args, class Code>
__device__ __forceinline__ void produce(const Args& a, uint16_t* ring,
                                       int pt, int lane0, int n_tiles,
                                       int nthreads, Code code) {
  constexpr int kThreads = 32 * kProducerWarps;
  const int per_tile = a.lanes * kTileSteps;
  const uint32_t slot = (uint32_t)(a.step_offset + pt % kTileSteps);
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kStages;
    if (k >= kStages) bar_sync(kEmpty + st, nthreads);
    uint16_t* tile = ring + st * per_tile;
    const uint32_t c0 = step_key(a.seed, slot + (uint32_t)(k * kTileSteps));
    int l = pt / kTileSteps;
#pragma unroll 1
    for (int j = pt; j < per_tile; j += kThreads) {
      tile[j] = (uint16_t)code(c0, (uint32_t)(lane0 + l), l);
      l += kThreads / kTileSteps;
    }
    bar_arrive(kFull + st, nthreads);
  }
}

__device__ __forceinline__ void load_codes(const uint16_t* p,
                                           uint32_t (&w)[kTileSteps / 2]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int v = 0; v < kTileSteps / 8; ++v) {
    const uint4 x = q[v];
    w[4 * v] = x.x; w[4 * v + 1] = x.y; w[4 * v + 2] = x.z; w[4 * v + 3] = x.w;
  }
}

// A consumer's walk over the ring: tile k + 1's codes are waited for and
// loaded into registers before tile k's steps, and its slot is released
// after them (when a producer will wait for it); the last, partial tile
// is read from its slot, which nothing overwrites.  step(code) takes the
// lane's next step.
template <class Args, class Step>
__device__ __forceinline__ void walk(const Args& a,
                                     const uint16_t* ring, int l, int n_tiles,
                                     int nthreads, Step& step) {
  const int per_tile = a.lanes * kTileSteps;
  const int n_full = a.n_steps / kTileSteps;
  const uint16_t* mine = ring + l * kTileSteps;
  uint32_t cur[kTileSteps / 2], nxt[kTileSteps / 2];
  if (n_tiles > 0) {
    bar_sync(kFull, nthreads);
    load_codes(mine, cur);
    if (kStages < n_tiles) bar_arrive(kEmpty, nthreads);
  }
  for (int k = 0; k < n_full; ++k) {
    const int k1 = k + 1, st1 = k1 % kStages;
    if (k1 < n_tiles) {
      bar_sync(kFull + st1, nthreads);
      load_codes(mine + st1 * per_tile, nxt);
    }
#pragma unroll
    for (int s = 0; s < kTileSteps; ++s)
      step((cur[s / 2] >> (16 * (s & 1))) & 0xFFFFu);
    if (k1 + kStages < n_tiles) bar_arrive(kEmpty + st1, nthreads);
#pragma unroll
    for (int v = 0; v < kTileSteps / 2; ++v) cur[v] = nxt[v];
  }
  const uint16_t* last = mine + (n_full % kStages) * per_tile;
#pragma unroll 1
  for (int s = 0; s < a.n_steps - n_full * kTileSteps; ++s)
    step((uint32_t)last[s]);
}

// A lane's step from a step code by the table: one shared-memory load of
// the pre-reset next code with its goal (sign) and reward bits, then the
// reset to the ISD entry's code.  The state is its compact code; the
// table row, the reset code and the truncation test come off the chain.
template <bool kJournal>
struct TableStep {
  const char* table;         // shared
  const char* code_raw;      // shared, uint16 a code
  int32_t* journal;          // this lane's word of the next step
  int row_bytes, max_steps, B;
  bool active;
  uint32_t isd01, isd23;     // the ISD entries' codes x 2, two a register
  int cs2, t, rew, goals, truncs;  // cs2: 2 x the state's compact code

  __device__ __forceinline__ void operator()(uint32_t code) {
    const int row = (int)(code & 127u) * row_bytes;
    const int idx = (code >> 7) & 3;
    const int reset = ((idx & 2 ? isd23 : isd01) >> (16 * (idx & 1))) & 0xFFFF;
    const bool late = t + 1 >= max_steps;
    const int e = *reinterpret_cast<const uint16_t*>(table + row + cs2);
    const bool goal = (e & kGoalBit) != 0;
    const bool trunc = late & !goal;
    const int nxt2 = e & kCodeMask;
    cs2 = (goal | late) ? reset : nxt2;
    t = (goal | late) ? 0 : t + 1;
    if constexpr (kJournal) {
      const int w = (int)*reinterpret_cast<const uint16_t*>(code_raw + nxt2) |
                    (int)((code >> 9) << 16) |
                    ((int)goal << 21) | ((int)trunc << 22) |
                    ((e & kRewardBit) << 10) | (idx << 24);
      if (active) *journal = w;
      journal += B;
    }
    rew += goal ? ((e & kRewardBit) ? 1 : -1) : 0;
    goals += goal;
    truncs += trunc;
  }
};

// A lane's step from a step code by arithmetic: the transition under the
// decoded effective moves, then the reset to the ISD entry's fields.
template <bool kJournal>
struct ArithStep {
  const Game* g;
  const int* isd_fields;    // shared: [kMaxIsd][5]
  int32_t* journal;         // this lane's word of the next step
  int B;
  bool active;
  State s;
  int rew, goals, truncs;

  __device__ __forceinline__ void operator()(uint32_t code) {
    const int in = (int)(code & 127u);
    const int idx = (code >> 7) & 3;
    const int* fp = isd_fields + 5 * idx;
    const int f[5] = {lds(fp), lds(fp + 1), lds(fp + 2), lds(fp + 3),
                      lds(fp + 4)};
    const bool late = s.t + 1 >= g->max_steps;
    bool goal;
    int r;
    step_moves(s, in / 20, (in >> 2) % 5, in & 3, *g, goal, r);
    const int raw = (((s.ra * g->W + s.ca) * g->H + s.rb) * g->W + s.cb) * 2 +
                    s.p;
    const bool term = goal | late;
    const bool trunc = late & !goal;
    s.ra = term ? f[0] : s.ra;
    s.ca = term ? f[1] : s.ca;
    s.rb = term ? f[2] : s.rb;
    s.cb = term ? f[3] : s.cb;
    s.p = term ? f[4] : s.p;
    s.t = term ? 0 : s.t + 1;
    if constexpr (kJournal) {
      const int w = raw | (int)((code >> 9) << 16) | ((int)goal << 21) |
                    ((int)trunc << 22) | ((int)(r == 1) << 23) | (idx << 24);
      if (active) *journal = w;
      journal += B;
    }
    rew += r;
    goals += goal;
    truncs += trunc;
  }
};

// Consumer thread l: lane lane0 + l.  With the table (kTable) a warp whose
// lanes are all walkable walks it, any other warp by arithmetic.
template <bool kJournal, bool kTable>
__device__ __forceinline__ void consume(const RolloutArgs& a,
                                        const int16_t* table,
                                        const uint16_t* code_raw,
                                        uint64_t* bar, const int* isd,
                                        const uint16_t* ring, int l,
                                        int lane0, int n_tiles,
                                        int nthreads) {
  const int lane = lane0 + l;
  const bool active = lane < a.B;
  // no start planes: lane i starts on ISD entry i % nI with t = 0
  State s = !active ? isd_state(a.g, 0)
            : a.in.f[0] != nullptr ? load_state(a.in, lane)
                                   : isd_state(a.g, lane % a.g.nI);
  int rew, goals, truncs;
  bool by_table = false;
  if constexpr (kTable) {
    wait_table(bar);  // every consumer: no block leaves before the copy ends
    by_table = __all_sync(0xFFFFFFFFu, walkable(s, a.g));
  }
  if (by_table) {
    TableStep<kJournal> step{reinterpret_cast<const char*>(table),
                             reinterpret_cast<const char*>(code_raw),
                             a.journal + lane, 2 * a.n_codes, a.g.max_steps,
                             a.B, active};
    step.isd01 = (uint32_t)(2 * isd[0]) | (uint32_t)(2 * isd[1]) << 16;
    step.isd23 = (uint32_t)(2 * isd[2]) | (uint32_t)(2 * isd[3]) << 16;
    step.cs2 = 2 * cellpair_encode(s, a.g, n_cells(a.g));
    step.t = s.t;
    step.rew = step.goals = step.truncs = 0;
    walk(a, ring, l, n_tiles, nthreads, step);
    int raw = code_raw[step.cs2 / 2];
    s.p = raw & 1; raw >>= 1;
    s.cb = raw % a.g.W; raw /= a.g.W;
    s.rb = raw % a.g.H; raw /= a.g.H;
    s.ca = raw % a.g.W;
    s.ra = raw / a.g.W;
    s.t = step.t;
    rew = step.rew; goals = step.goals; truncs = step.truncs;
  } else {
    ArithStep<kJournal> step{&a.g, isd + kMaxIsd, a.journal + lane, a.B,
                             active, s, 0, 0, 0};
    walk(a, ring, l, n_tiles, nthreads, step);
    s = step.s;
    rew = step.rew; goals = step.goals; truncs = step.truncs;
  }
  if (!active) rew = goals = truncs = 0;  // a ragged block's spare lanes
  else store_state(a.out, lane, s);
  warp_sum(a.stats, rew, goals, truncs);
}

// K1 (kJournal false) and K2: blocks of a.lanes consumer threads, one a
// lane, then kProducerWarps producer warps.
template <bool kJournal, bool kTable>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducerWarps)
    rollout_kernel(RolloutArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* isd = reinterpret_cast<int*>(smem + 16);
  const int table_bytes = kTable ? kInputs * 2 * a.n_codes : 0;
  const int16_t* table = reinterpret_cast<const int16_t*>(smem + kHead);
  const uint16_t* code_raw =
      reinterpret_cast<const uint16_t*>(smem + kHead + table_bytes);
  uint16_t* ring = reinterpret_cast<uint16_t*>(
      smem + kHead + table_bytes + (kTable ? raw_bytes(a.n_codes) : 0));
  const int nthreads = a.lanes + 32 * kProducerWarps;
  const int lane0 = blockIdx.x * a.lanes;
  const int n_tiles = a.n_steps / kTileSteps + (a.n_steps % kTileSteps != 0);
  if (threadIdx.x < kMaxIsd) {
    const int k = min((int)threadIdx.x, a.g.nI - 1);
    const State e = isd_state(a.g, k);
    isd[threadIdx.x] = kTable ? cellpair_encode(e, a.g, n_cells(a.g)) : 0;
    int* f = isd + kMaxIsd + 5 * threadIdx.x;
    f[0] = e.ra; f[1] = e.ca; f[2] = e.rb; f[3] = e.cb; f[4] = e.p;
  }
  if constexpr (kTable) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_addr(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  if constexpr (kTable) {
    if (threadIdx.x == 0) {
      expect_bytes(bar, table_bytes + raw_bytes(a.n_codes));
      bulk_copy(bar, smem + kHead, a.table, table_bytes);
      bulk_copy(bar, smem + kHead + table_bytes, a.code_raw,
                raw_bytes(a.n_codes));
    }
  }
  if ((int)threadIdx.x >= a.lanes) {
    if (a.g.nI == 3)
      produce(a, ring, threadIdx.x - a.lanes, lane0, n_tiles, nthreads,
              SimCode<true>{board_slip(a.g)});
    else
      produce(a, ring, threadIdx.x - a.lanes, lane0, n_tiles, nthreads,
              SimCode<false>{board_slip(a.g)});
  } else
    consume<kJournal, kTable>(a, table, code_raw, bar, isd, ring,
                              threadIdx.x, lane0, n_tiles, nthreads);
}

constexpr int kMaxDevices = 64;

// The launch; the kernel's shared-memory limit is raised once per device
// and size, not on every call.
template <bool kJournal, bool kTable>
cudaError_t launch_rollout(const RolloutArgs& a, int device, int smem,
                           cudaStream_t st) {
  auto kernel = rollout_kernel<kJournal, kTable>;
  static int allowed[kMaxDevices] = {};
  if (device >= kMaxDevices || smem > allowed[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  kernel<<<blocks, a.lanes + 32 * kProducerWarps, smem, st>>>(a);
  return cudaGetLastError();
}

// K1/K2's launch: checks, the stats zeroed, the table path when the
// wrapper passes a step table.
template <bool kJournal>
int rollout(int device, void* const* in, void* const* out, long long* stats,
            int32_t* journal, const int32_t* params, const int16_t* table,
            const uint16_t* code_raw, int n_codes, int B, int n_steps,
            uint32_t seed, int step_offset, int lanes, void* stream) {
  if (params[6] < 1 || params[6] > kMaxIsd || B <= 0 || n_steps < 0 ||
      lanes < 32 || lanes > kMaxLanes || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (table != nullptr &&
      (n_codes < 1 || 2 * n_codes > kCodeMask + 1 || code_raw == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(lanes, table != nullptr ? n_codes : 0);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(stats, 0, 3 * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  RolloutArgs a{in != nullptr ? make_planes(in) : Planes{}, make_planes(out),
                stats, journal, table,
                code_raw, n_codes, lanes, B, n_steps, step_offset, seed,
                make_game(params)};
  return (int)(table != nullptr
                   ? launch_rollout<kJournal, true>(a, device, smem, st)
                   : launch_rollout<kJournal, false>(a, device, smem, st));
}

// ---------------------------------------------------------------------
// K3: K1's split on each lane's own board
// ---------------------------------------------------------------------

constexpr int kMaxVariants = 16;
constexpr int kPartBytes = 8 * 3 * kMaxVariants;  // per-variant sums

struct MgArgs {
  Planes in, out, geo;  // geo: H, W, glo, ghi, q_int, variant id
  long long* stats;     // int64 [n_variants, 3]
  int lanes, B, n_steps, step_offset, max_steps, n_variants;
  uint32_t seed;
};

// K3's dynamic shared memory: the per-variant sums, each lane's slip entry
// (lane_slip) and the ring (rollout_codes.mg_smem_bytes); 33,152 B at 512
// lanes, under the 48 KB a launch takes without an attribute.
__host__ __device__ constexpr int mg_smem_bytes(int lanes) {
  return kPartBytes + 16 * lanes + kStages * kTileSteps * 2 * lanes;
}

// K3's step code of lane lane0 + l: step_code without the joint action, on
// the slip thresholds and ISD mask of the lane's board.
struct MgCode {
  const int4* slip;  // shared, lane_slip a lane
  __device__ __forceinline__ uint32_t operator()(uint32_t c0, uint32_t lane,
                                                 int l) const {
    const int4 b = slip[l];
    return step_code<false, false>(c0, lane, b.x, b.y, b.z);
  }
};

// A lane's step on its own board from a step code: the transition under
// the decoded effective moves, then the reset to the computed ISD entry.
struct MgStep {
  LaneBoard g;
  State s;
  int rew, goals, truncs;

  __device__ __forceinline__ void operator()(uint32_t code) {
    const int in = (int)(code & 127u);
    int f[5];
    g.isd((code >> 7) & 3, f);
    const bool late = s.t + 1 >= g.max_steps;
    bool goal;
    int r;
    step_moves(s, in / 20, (in >> 2) % 5, in & 3, g, goal, r);
    const bool term = goal | late;
    s.ra = term ? f[0] : s.ra;
    s.ca = term ? f[1] : s.ca;
    s.rb = term ? f[2] : s.rb;
    s.cb = term ? f[3] : s.cb;
    s.p = term ? f[4] : s.p;
    s.t = term ? 0 : s.t + 1;
    rew += r;
    goals += goal;
    truncs += late & !goal;
  }
};

// K3: blocks of a.lanes consumer threads, one a lane, then kProducerWarps
// producer warps, as K1's.  A ragged block's spare lanes step lane B - 1's
// board and keep nothing.
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducerWarps)
    mg_rollout_kernel(MgArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* part = reinterpret_cast<unsigned long long*>(smem);
  int4* slip = reinterpret_cast<int4*>(smem + kPartBytes);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kPartBytes +
                                               16 * a.lanes);
  const int nthreads = a.lanes + 32 * kProducerWarps;
  const int lane0 = blockIdx.x * a.lanes;
  const int n_tiles = a.n_steps / kTileSteps + (a.n_steps % kTileSteps != 0);
  const int l = threadIdx.x, lane = lane0 + l, src = min(lane, a.B - 1);
  MgStep step{};
  if (l < a.lanes) {
    step.g = lane_board(a.geo, src, a.max_steps);
    step.s = load_state(a.in, src);
    slip[l] = lane_slip(a.geo.f[4][src], step.g.H);
  }
  if (threadIdx.x < 3 * kMaxVariants) part[threadIdx.x] = 0;
  __syncthreads();
  if (l >= a.lanes) {
    produce(a, ring, l - a.lanes, lane0, n_tiles, nthreads, MgCode{slip});
  } else {
    walk(a, ring, l, n_tiles, nthreads, step);
    if (lane < a.B) {
      store_state(a.out, lane, step.s);
      unsigned long long* mine = part + 3 * a.geo.f[5][lane];
      atomicAdd(mine + 0, (unsigned long long)(long long)step.rew);
      atomicAdd(mine + 1, (unsigned long long)(long long)step.goals);
      atomicAdd(mine + 2, (unsigned long long)(long long)step.truncs);
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < 3 * a.n_variants && part[threadIdx.x])
    atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + threadIdx.x),
              part[threadIdx.x]);
}

// ---------------------------------------------------------------------
// K4: the alternating game's ticks, split as K1/K2's steps
// ---------------------------------------------------------------------

constexpr int kAltInputs = 5;   // the mover's effective move

struct AltArgs {
  AltPlanes in, out;
  long long* stats;
  const int16_t* table;     // [kAltInputs][2 * n_codes] tick table (table
                            // path), entries keyed code * 2 + turn
  const uint16_t* code_raw; // [n_codes, padded to 8] raw code of each code
  int n_codes, lanes, B, n_steps, step_offset;
  uint32_t seed;
  Game g;
};

// K4's dynamic shared memory: K1/K2's head, the tick table, the raw codes
// (n_codes 0: neither) and the ring (rollout_codes.alt_smem_bytes).
__host__ __device__ constexpr int alt_smem_bytes(int lanes, int n_codes) {
  return kHead + kAltInputs * 4 * n_codes + raw_bytes(n_codes) +
         kStages * kTileSteps * 2 * lanes;
}

// The tick code of the lane at the tick keyed c0: the mover's effective
// move (its action u16(word 0) % 5 after the slip on u16(word 1)) in bits
// 0-2, the ISD index of a reset in bits 3-4.  Which player moves does not
// change it.
template <bool kMod3>
struct AltCode {
  BoardSlip b;
  __device__ __forceinline__ uint32_t operator()(uint32_t c0, uint32_t lane,
                                                 int) const {
    const uint32_t c1 = c0 + 0xC2B2AE3Du, c2 = c0 + 2u * 0xC2B2AE3Du;
    const uint32_t b0 = fmix32(fmix32(lane ^ c0) + c0);
    const uint32_t b1 = fmix32(fmix32(lane ^ c1) + c1);
    const uint32_t b2 = fmix32(fmix32(lane ^ c2) + c2);
    const int e = effective_move(u16(b0, 0) % 5, u16(b1, 0), b.t_keep,
                                 b.t_half);
    return (uint32_t)(e | (isd_pick<kMod3>(u16(b2, 1), b.isd_mask) << 3));
  }
};

// A lane's tick from a tick code by the table: one shared-memory load of
// the pre-reset next (code, turn) with its goal and reward bits, then the
// reset to the ISD entry's code with A to move.  The state is 2 x (2 x its
// compact code + turn), a byte offset into a row; the row, the reset code
// and the truncation test come off the chain.
struct AltTableStep {
  const char* table;         // shared
  int row_bytes, max_steps;
  uint32_t isd01, isd23;     // the ISD entries' states, two a register
  int cs2, t, rew, goals, truncs;

  __device__ __forceinline__ void operator()(uint32_t code) {
    const int row = (int)(code & 7u) * row_bytes;
    const int idx = (code >> 3) & 3;
    const int reset = ((idx & 2 ? isd23 : isd01) >> (16 * (idx & 1))) & 0xFFFF;
    const bool late = t + 1 >= max_steps;
    const int e = *reinterpret_cast<const uint16_t*>(table + row + cs2);
    const bool goal = (e & kGoalBit) != 0;
    cs2 = (goal | late) ? reset : e & kCodeMask;
    t = (goal | late) ? 0 : t + 1;
    rew += goal ? ((e & kRewardBit) ? 1 : -1) : 0;
    goals += goal;
    truncs += late & !goal;
  }
};

// A lane's tick from a tick code by arithmetic: alt_moves, then the reset
// to the ISD entry's fields with A to move.
struct AltArithStep {
  const Game* g;
  const int* isd_fields;    // shared: [kMaxIsd][5]
  State s;
  int turn, rew, goals, truncs;

  __device__ __forceinline__ void operator()(uint32_t code) {
    const int* fp = isd_fields + 5 * ((code >> 3) & 3);
    const int f[5] = {lds(fp), lds(fp + 1), lds(fp + 2), lds(fp + 3),
                      lds(fp + 4)};
    const bool late = s.t + 1 >= g->max_steps;
    bool goal;
    int r;
    alt_moves(s, turn, (int)(code & 7u), *g, goal, r);
    const bool term = goal | late;
    s.ra = term ? f[0] : s.ra;
    s.ca = term ? f[1] : s.ca;
    s.rb = term ? f[2] : s.rb;
    s.cb = term ? f[3] : s.cb;
    s.p = term ? f[4] : s.p;
    s.t = term ? 0 : s.t + 1;
    turn = term ? 0 : 1 - turn;
    rew += r;
    goals += goal;
    truncs += late & !goal;
  }
};

// K4's consumer thread l: lane lane0 + l.  With the table (kTable) a warp
// whose lanes are all walkable, with turn 0 or 1, walks it, any other warp
// by arithmetic.
template <bool kTable>
__device__ __forceinline__ void alt_consume(const AltArgs& a,
                                            const int16_t* table,
                                            const uint16_t* code_raw,
                                            uint64_t* bar, const int* isd,
                                            const uint16_t* ring, int l,
                                            int lane0, int n_tiles,
                                            int nthreads) {
  const int lane = lane0 + l;
  const bool active = lane < a.B;
  // no start planes: lane i starts on ISD entry i % nI, A to move, t = 0
  const bool given = active && a.in.f[0] != nullptr;
  State s = given ? State{a.in.f[0][lane], a.in.f[1][lane], a.in.f[2][lane],
                          a.in.f[3][lane], a.in.f[4][lane], a.in.f[6][lane]}
                  : isd_state(a.g, active ? lane % a.g.nI : 0);
  int turn = given ? a.in.f[5][lane] : 0;
  int rew, goals, truncs;
  bool by_table = false;
  if constexpr (kTable) {
    wait_table(bar);  // every consumer: no block leaves before the copy ends
    by_table = __all_sync(0xFFFFFFFFu,
                          walkable(s, a.g) && (turn == 0 || turn == 1));
  }
  if (by_table) {
    AltTableStep step{reinterpret_cast<const char*>(table), 4 * a.n_codes,
                      a.g.max_steps};
    step.isd01 = (uint32_t)(4 * isd[0]) | (uint32_t)(4 * isd[1]) << 16;
    step.isd23 = (uint32_t)(4 * isd[2]) | (uint32_t)(4 * isd[3]) << 16;
    step.cs2 = 2 * (2 * cellpair_encode(s, a.g, n_cells(a.g)) + turn);
    step.t = s.t;
    step.rew = step.goals = step.truncs = 0;
    walk(a, ring, l, n_tiles, nthreads, step);
    turn = (step.cs2 >> 1) & 1;
    int raw = code_raw[step.cs2 >> 2];
    s.p = raw & 1; raw >>= 1;
    s.cb = raw % a.g.W; raw /= a.g.W;
    s.rb = raw % a.g.H; raw /= a.g.H;
    s.ca = raw % a.g.W;
    s.ra = raw / a.g.W;
    s.t = step.t;
    rew = step.rew; goals = step.goals; truncs = step.truncs;
  } else {
    AltArithStep step{&a.g, isd + kMaxIsd, s, turn, 0, 0, 0};
    walk(a, ring, l, n_tiles, nthreads, step);
    s = step.s;
    turn = step.turn;
    rew = step.rew; goals = step.goals; truncs = step.truncs;
  }
  if (!active) {
    rew = goals = truncs = 0;  // a ragged block's spare lanes
  } else {
    a.out.f[0][lane] = s.ra; a.out.f[1][lane] = s.ca;
    a.out.f[2][lane] = s.rb; a.out.f[3][lane] = s.cb;
    a.out.f[4][lane] = s.p;  a.out.f[5][lane] = turn;
    a.out.f[6][lane] = s.t;
  }
  warp_sum(a.stats, rew, goals, truncs);
}

// K4: blocks of a.lanes consumer threads, one a lane, then
// kProducerWarps producer warps, as K1/K2's.
template <bool kTable>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducerWarps)
    alt_rollout_kernel(AltArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* isd = reinterpret_cast<int*>(smem + 16);
  const int table_bytes = kTable ? kAltInputs * 4 * a.n_codes : 0;
  const int16_t* table = reinterpret_cast<const int16_t*>(smem + kHead);
  const uint16_t* code_raw =
      reinterpret_cast<const uint16_t*>(smem + kHead + table_bytes);
  uint16_t* ring = reinterpret_cast<uint16_t*>(
      smem + kHead + table_bytes + (kTable ? raw_bytes(a.n_codes) : 0));
  const int nthreads = a.lanes + 32 * kProducerWarps;
  const int lane0 = blockIdx.x * a.lanes;
  const int n_tiles = a.n_steps / kTileSteps + (a.n_steps % kTileSteps != 0);
  if (threadIdx.x < kMaxIsd) {
    const int k = min((int)threadIdx.x, a.g.nI - 1);
    const State e = isd_state(a.g, k);
    isd[threadIdx.x] = kTable ? cellpair_encode(e, a.g, n_cells(a.g)) : 0;
    int* f = isd + kMaxIsd + 5 * threadIdx.x;
    f[0] = e.ra; f[1] = e.ca; f[2] = e.rb; f[3] = e.cb; f[4] = e.p;
  }
  if (kTable && threadIdx.x == 0) init_bar(bar);
  __syncthreads();
  if (kTable && threadIdx.x == 0) {
    expect_bytes(bar, table_bytes + raw_bytes(a.n_codes));
    bulk_copy(bar, smem + kHead, a.table, table_bytes);
    bulk_copy(bar, smem + kHead + table_bytes, a.code_raw,
              raw_bytes(a.n_codes));
  }
  if ((int)threadIdx.x >= a.lanes) {
    if (a.g.nI == 3)
      produce(a, ring, threadIdx.x - a.lanes, lane0, n_tiles, nthreads,
              AltCode<true>{board_slip(a.g)});
    else
      produce(a, ring, threadIdx.x - a.lanes, lane0, n_tiles, nthreads,
              AltCode<false>{board_slip(a.g)});
  } else {
    alt_consume<kTable>(a, table, code_raw, bar, isd, ring, threadIdx.x,
                        lane0, n_tiles, nthreads);
  }
}

template <bool kTable>
cudaError_t launch_alt(const AltArgs& a, int device, int smem,
                       cudaStream_t st) {
  auto kernel = alt_rollout_kernel<kTable>;
  static int allowed[kMaxDevices] = {};
  if (device >= kMaxDevices || smem > allowed[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  kernel<<<blocks, a.lanes + 32 * kProducerWarps, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  device: the CUDA ordinal of every pointer and of the stream;
// in/out: host arrays of 6 device pointers to int32 [B] (in null: lane i
// starts on ISD entry i % nI with t = 0); stats: device
// int64 [3] (reward sum, goals, truncations); params: the game
// (step_kernel._game_params); table: device int16 [100 * n_codes], the
// step table (rollout_codes.build_step_table), or null for the arithmetic
// path; code_raw: device uint16 [n_codes, padded to a multiple of 8], the
// raw code of each compact code (the table path's); lanes: lanes
// per block, a multiple of 32 in [32, 512] whose shared memory
// (gst_rollout_smem_bytes) fits 232,448 bytes.
int gst_fused_rollout(int device, void* const* in, void* const* out,
                      long long* stats, const int32_t* params,
                      const int16_t* table, const uint16_t* code_raw,
                      int n_codes, int B, int n_steps, uint32_t seed,
                      int step_offset, int lanes, void* stream) {
  return rollout<false>(device, in, out, stats, nullptr, params, table,
                        code_raw, n_codes, B, n_steps, seed, step_offset,
                        lanes, stream);
}

// K2.  As K1, plus journal: device int32 [n_steps, B].
int gst_fused_journal_rollout(int device, void* const* in, void* const* out,
                              long long* stats, int32_t* journal,
                              const int32_t* params, const int16_t* table,
                              const uint16_t* code_raw, int n_codes, int B,
                              int n_steps, uint32_t seed, int step_offset,
                              int lanes, void* stream) {
  return rollout<true>(device, in, out, stats, journal, params, table,
                       code_raw, n_codes, B, n_steps, seed, step_offset,
                       lanes, stream);
}

// K1/K2's dynamic shared memory per block (rollout_codes.smem_bytes).
int gst_rollout_smem_bytes(int lanes, int n_codes) {
  return smem_bytes(lanes, n_codes);
}

// K1/K2's pipeline: steps a tile, tiles in the ring, producer warps.
void gst_rollout_shape(int32_t* out) {
  out[0] = kTileSteps;
  out[1] = kStages;
  out[2] = kProducerWarps;
}

// K3.  in/out: host arrays of 6 device pointers to int32 [B]; geo: host
// array of 6 device pointers to int32 [B] (H, W, glo, ghi, q_int, variant
// id); stats: device int64 [n_variants, 3] (reward sum, goals, truncations
// per variant), zeroed here; lanes: lanes per block, a multiple of 32 in
// [32, 512].
int gst_multigrid_rollout(int device, void* const* in, void* const* out,
                          void* const* geo, long long* stats, int B,
                          int n_steps, uint32_t seed, int step_offset,
                          int max_steps, int n_variants, int lanes,
                          void* stream) {
  if (n_variants < 1 || n_variants > kMaxVariants || B <= 0 || n_steps < 0 ||
      lanes < 32 || lanes > kMaxLanes || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(stats, 0, 3 * sizeof(long long) * n_variants, st);
  if (e != cudaSuccess) return (int)e;
  const MgArgs a{make_planes(in), make_planes(out), make_planes(geo), stats,
                 lanes, B, n_steps, step_offset, max_steps, n_variants, seed};
  mg_rollout_kernel<<<(B + lanes - 1) / lanes, lanes + 32 * kProducerWarps,
                      mg_smem_bytes(lanes), st>>>(a);
  return (int)cudaGetLastError();
}

// K3's dynamic shared memory per block (rollout_codes.mg_smem_bytes).
int gst_mg_rollout_smem_bytes(int lanes) { return mg_smem_bytes(lanes); }

// K4.  As K1, with in/out: host arrays of 7 device pointers to int32 [B]
// (ra, ca, rb, cb, p, turn, t; in null: lane i starts on ISD entry i % nI,
// A to move, t = 0); table: device int16 [5 * 2 * n_codes], the tick table
// (rollout_codes.build_alt_table), or null for the arithmetic path;
// lanes: lanes per block, a multiple of 32 in [32, 512] whose shared
// memory (gst_alt_rollout_smem_bytes) fits 232,448 bytes.
int gst_alt_rollout(int device, void* const* in, void* const* out,
                    long long* stats, const int32_t* params,
                    const int16_t* table, const uint16_t* code_raw,
                    int n_codes, int B, int n_steps, uint32_t seed,
                    int step_offset, int lanes, void* stream) {
  if (params[6] < 1 || params[6] > kMaxIsd || B <= 0 || n_steps < 0 ||
      lanes < 32 || lanes > kMaxLanes || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (table != nullptr &&
      (n_codes < 1 || 4 * n_codes > kCodeMask + 1 || code_raw == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = alt_smem_bytes(lanes, table != nullptr ? n_codes : 0);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(stats, 0, 3 * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  AltArgs a{in != nullptr ? make_alt_planes(in) : AltPlanes{},
            make_alt_planes(out), stats, table, code_raw, n_codes, lanes, B,
            n_steps, step_offset, seed, make_game(params)};
  return (int)(table != nullptr ? launch_alt<true>(a, device, smem, st)
                                : launch_alt<false>(a, device, smem, st));
}

// K4's dynamic shared memory per block (rollout_codes.alt_smem_bytes).
int gst_alt_rollout_smem_bytes(int lanes, int n_codes) {
  return alt_smem_bytes(lanes, n_codes);
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
