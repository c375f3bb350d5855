// Alternating-turn Q learner chunks for Hopper (sm_90a): kernels K10 and
// K11.
//
// Replaces the Pallas TPU kernels `_altq_packed_kernel` (K10, wrapper
// `altq_packed_chunk`) and `_altq_kernel` (K11, wrapper `altq_chunk`) of
// gym_soccer_tpu/ops/altq_kernel.py.  One template,
// `altq_chunk_kernel<kPacked, kTable, kSharedRows, kSharedAcc>`, computes
// both after its prep pass `altq_prep_kernel`; they differ only in the
// baseline a visit carries.  `altq_graph_chunk_kernel` is the same body
// reading the chunk's seed, eps_int and step offset from device memory:
// the calls the trainer's grouped mode captures in a CUDA graph
// (ops/dispatch.py).
//
// What it computes, for every lane (one independent game) and step i:
// three murmur3 counter words keyed on (chunk seed, i + step_offset, word,
// global lane); the compact cellpair code cp of the state, which does not
// hold the turn; the mover's five Q values at (cp, turn), where the table
// row cp holds A-to-move values in columns 0-4 and B-to-move values in
// 5-9, each the JAX package's double-bf16 hi + lo (the values its kernel
// acts on); V = max of them when A moves, min when B moves (the table is
// A-perspective); the retirement of the PREVIOUS step, whose target r +
// cont * V now has its bootstrap value; the mover's eps-greedy action
// (explore when the low 16 bits of word 0 are below eps_int, then take
// the high 16 bits mod 5; else greedy on sgn * q with sgn = +1 for A and
// -1 for B, a strict `>` scan from action 0, so the lowest index wins a
// tie for either player); game.cuh's `alt_transition` on word 1 and the
// autoreset on word 2; cont = 0 on a goal or a truncation, else gamma; the
// turn flips, or goes to A on a goal or a truncation.  After the last step
// a trailing retirement uses V of the final (post-autoreset) state.  Per
// (cp, turn, action) of the mover the kernel counts the visits and sums
// target - baseline, where the baseline is V(s) for K10 (the Bellman
// residual; the host completes the TD with cnt * (V - q) between chunks)
// and q(s, a) for K11 (the full TD).
//
// Exactness: the sums are int64 fixed point in units of 2^-32, added with
// integer atomics, so they are the same in any order: the kernels equal
// their plain PyTorch versions bit for bit for any block size, and a
// resumed training run equals an uninterrupted one.  They stay exact while
// every value lies within +-limit = 2^30 / (B * n_steps); each lane counts
// the values outside (or not finite) in a register and adds its count to
// stats[3] once.  Every float operation is written with an explicit
// rounding intrinsic so that nvcc forms no FMA the plain version lacks;
// max and min propagate NaN, as torch.maximum/minimum and JAX's do, and
// so does the greedy scan's running best (max_nan), so that a NaN at
// column k keeps every later column from being chosen.
//
// What bounded the previous design on this card (`altq_kernel<kPacked>`
// below, no longer dispatched; ops/altq_variants.py times it): one thread
// a lane at 128-thread blocks, 64 blocks at 8192 lanes, so 68 of 132 SMs
// idle and one warp a scheduler; each step one dependent chain of three
// hashes, the state's code, five table loads, the V max/min, the five-way
// sgn * q scan, two device-memory atomics and the branchy transition and
// autoreset: 236 SASS a lane-step and ~60 us of kernel per 8192 x 64
// chunk on an NVIDIA H100 80GB HBM3 at 700 W, ~6 % of its bound.  Most of
// that chain does not depend on the state: the words, the explore-or-
// greedy choice, the explored action, the slip and the ISD index follow
// from (seed, step, lane) and eps_int alone, and the table is frozen for
// the chunk, so the V and greedy action of a (code, turn) are the same for
// every lane visiting it.
//
// What the design does about it: K8/K9's split (iql_kernel.cu).  Producer
// warps (kProducers a block) hash each (lane, step) into a 7-bit code
// (ops/altq_codes.py: the mover's choice, an explored action or kGreedy;
// its slip class; the ISD index) handed over in tiles of kTile steps
// through a ring of kRingStages tiles on named barriers.  A prep pass turns
// each table row into both movers' V (a float2: A's max, B's min) and both
// greedy actions (a byte): 9 B a code, 9,936 B on 5x4 and 122,512 B on
// 11x7, copied into shared memory by bulk copies while the producers start
// (a board whose rows do not fit reads them from L2).  One consumer thread
// per lane reads its state's prepared V and greedy action at (code, turn),
// retires the pending visit against that V (one a lane-step: only the
// mover learns), selects its action (the code's, or the row's greedy one:
// a select, not a branch), maps action and slip class to the effective
// move (a nibble table) and steps.  On 5x4 it steps by K4's tick table
// (kTable: 1104 codes x 2 turns x 5 moves, int16 entries holding 2 x (2 x
// the next code + the next turn) with the goal and reward bits, 22,080 B,
// rollout_codes.build_alt_table), its state held as that byte offset, so
// the prepared row, the accumulator cell (code x 10 + turn x 5 + a) and
// the next state come from the entry and the state's code leaves the
// chain; a warp holding a lane the table cannot start from (a goal state,
// arbitrary fields) and boards whose codes do not fit the entry (11x7)
// step by the branch-free `alt_moves` and the ISD reset; a warp holding a
// lane whose turn is neither 0 nor 1 reads the table itself, as the
// previous design did.  K11 loads q(s, a) from the table right after the
// action is known and first reads it at the next step's retirement, off
// the chain.  On 5x4 each block adds its visits to its own cells in shared
// memory (kSharedAcc: 1104 x 10 cells of 16 B, four native 32-bit shared
// atomics a visit, as K8's `retire_shared`), exact while a block adds at
// most kAccMaxVisits values to a cell, and adds its visited cells to
// device memory once, at the end; 11x7's 2.2 MB of cells do not fit, and
// its visits go to device memory.  `threads` is lanes per block, by
// default the fewest that keep the grid to one wave (64 at 8192 lanes, 512
// at 65536).  The call is one allocation (outputs, sums, counts, stats,
// the prep pass's rows), zeroed where it sums by one memset.
//
// What bounds it then: each lane's chain.  On an NVIDIA H100 80GB HBM3 at
// 700 W (ops/altq_variants.py, device time with the memset and the prep
// pass) an 8192 x 64 chunk takes 20.8 us on 5x4 (K11 28.4) against the
// previous design's 57.7, 41.4 on 11x7 (K11 47.8) against 67.2, and a
// 65536 x 32 chunk on 5x4 31.1 us against 160.1: 157.5 SASS a lane-step
// on 5x4 (204 on 11x7), 12 % of the bound that counts them at the issue
// rate.  At 8192 lanes two consumer warps share an SM, and each lane's 64
// steps are one serial chain (17.8 us of kernel on 5x4).  The tick table
// beats the arithmetic walk by 1.28x on 5x4 (26.6 us) and the private
// accumulators beat device-memory atomics by 1.8x (37.3 us; 5.2x at
// 65536 x 32); on 11x7 the device-memory atomics are 16 of 41 us.  K11's
// q(s, a) comes from L2 (the 44 KB table does not fit the L1 left beside
// 213 KB of shared memory): 8 us on 5x4.  Retiring a visit after the step
// in place of before it gains 2-5 %.

#include "pipeline.cuh"

using namespace gst;

namespace {

constexpr int kCols = 10;  // table and accumulator row: A-to-move 5, B 5
constexpr float kFix = 4294967296.0f;  // 2^32: fixed-point scale
constexpr int kTile = 8;          // steps a ring tile holds
constexpr int kRingStages = 2;    // tiles in the ring
constexpr int kProducers = 8;     // producer warps a block
constexpr int kMaxLanes = 512;    // lanes per block: 768 threads at most
constexpr int kSmemBudget = 232448;
constexpr int kHead = 16 + 4 * kMaxIsd * 5;  // mbarrier, ISD fields
constexpr int kFull = 1;          // named barriers: a tile is written
constexpr int kEmpty = 1 + kRingStages;  // ... and read
constexpr int kGreedy = 7;        // a code's choice: the greedy action
constexpr int kMoves = 5;         // tick table: the mover's effective move
constexpr int kCodeMask = (1 << 13) - 1;  // tick entry: 2 x (2 x code + turn),
constexpr int kRewardBit = 1 << 13;       // reward +1,
constexpr int kGoalBit = 1 << 15;         // goal
// A block adds at most this many values to one private accumulator cell
// (lanes x steps), so that its 16-bit parts' 32-bit sums stay exact.
constexpr int kAccMaxVisits = 1 << 16;
// (slip class, action) -> the action whose move is made, a nibble each
// (learner_codes.EFFECT).
constexpr unsigned long long kEffect =
    0x43210ull | 0x12430ull << 20 | 0x21340ull << 40;
static_assert((32 * kProducers) % kTile == 0,
              "a producer thread keeps one step slot of every tile");

// The prep pass's rows of n codes (altq_codes.row_bytes): a float2 of
// the two movers' V each, then a byte of greedy actions each, padded to
// 16 B.
__host__ __device__ constexpr int row_bytes(int n) {
  return (9 * n + 15) / 16 * 16;
}

// K4's tick table of n codes and the raw code of each code, padded to 16 B
// (rollout_codes.alt_table_bytes, raw_bytes).
__host__ __device__ constexpr int tick_bytes(int n) { return kMoves * 4 * n; }
__host__ __device__ constexpr int raw_bytes(int n) {
  return (2 * n + 15) / 16 * 16;
}

// Dynamic shared memory of a block (altq_codes.smem_bytes): the head, the
// prepared rows of n_rows codes (0: in device memory), the tick table and
// raw codes of n_table codes (0: none), the ring and the private
// accumulators of n_acc codes (0: none), 16 B a cell.
__host__ __device__ constexpr int smem_bytes(int lanes, int n_rows,
                                             int n_table, int n_acc) {
  return kHead + row_bytes(n_rows) + tick_bytes(n_table) +
         raw_bytes(n_table) + kRingStages * kTile * 2 * lanes +
         16 * kCols * n_acc;
}

__host__ __device__ constexpr bool fits(int n_rows, int n_table, int n_acc) {
  return smem_bytes(kMaxLanes, n_rows, n_table, n_acc) <= kSmemBudget;
}

// Byte offsets in a call's one allocation (altq_codes.layout).
struct AltqLayout {
  long long sums, stats, cnt, zero, fields, rows, total;
};

inline AltqLayout altq_layout(int n_codes, int B) {
  AltqLayout l;
  l.sums = 0;
  l.stats = 8LL * kCols * n_codes;
  l.cnt = l.stats + 32;
  l.zero = l.cnt + 4LL * kCols * n_codes;
  l.fields = (l.zero + 15) / 16 * 16;
  l.rows = (l.fields + 28LL * B + 15) / 16 * 16;
  l.total = l.rows + row_bytes(n_codes);
  return l;
}

struct AltqArgs {
  AltPlanes in, out;
  const float* table;       // [n_codes, 10]: K11's q(s, a)
  const float2* vals;       // the prep pass's V pairs; its greedy bytes follow
  const int16_t* tick;      // [kMoves][2 * n_codes] tick table (kTable)
  const uint16_t* code_raw; // [n_codes, padded to 8] raw code of each code
  long long* sums;
  int* cnt;
  long long* stats;
  int n_codes, lanes, B, n_steps, step_offset, eps_int;
  uint32_t seed;
  float gamma, limit;
  Game g;
  // altq_graph_chunk_kernel: (seed, eps_int, step_offset) in device memory,
  // scalars[0..2]; last, so that the other fields keep their places
  const int32_t* scalars;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// The mover's greedy action on sgn * q: a strict `>` scan from action 0
// whose running best propagates NaN (the plain version's).
__device__ __forceinline__ int mover_greedy(const float* q, float sgn) {
  int best = 0;
  float bestv = __fmul_rn(sgn, q[0]);
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    const float sc = __fmul_rn(sgn, q[k]);
    if (sc > bestv) best = k;
    bestv = max_nan(bestv, sc);
  }
  return best;
}

// The mover's five Q values at (cp, turn) and their V: max for A (turn 0),
// min for B.
__device__ __forceinline__ float mover_q(const float* __restrict__ table,
                                         int base, int turn, float* q) {
  q[0] = __ldg(table + base);
  float vmax = q[0], vmin = q[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    q[k] = __ldg(table + base + k);
    vmax = max_nan(vmax, q[k]);
    vmin = min_nan(vmin, q[k]);
  }
  return turn == 0 ? vmax : vmin;
}

// One visit's target r + cont * v_next.
__device__ __forceinline__ float target(float r, float cont, float v_next) {
  return __fadd_rn(r, __fmul_rn(cont, v_next));
}

// Add one visit's target - base to cell idx; return 1 if it lies outside
// +-limit or is not finite, else 0.
__device__ __forceinline__ int retire(long long* sums, int* cnt, int idx,
                                      float tgt, float base, float limit) {
  const float delta = __fsub_rn(tgt, base);
  const long long fixed = __float2ll_rn(__fmul_rn(delta, kFix));
  atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
            (unsigned long long)fixed);
  atomicAdd(cnt + idx, 1);
  return !(fabsf(delta) <= limit);
}

// retire into a block's private cell idx in shared memory: four 32-bit
// words, the sums of the fixed-point value's bits 0-15, 16-31 and 32-63
// and the count, each added by a native shared-memory atomic (a 64-bit
// shared add is a compare-and-swap loop).  The whole is the sum modulo
// 2^64, exact while the cell takes at most kAccMaxVisits values.
__device__ __forceinline__ int retire_shared(unsigned* acc, int idx,
                                             float tgt, float base,
                                             float limit) {
  const float delta = __fsub_rn(tgt, base);
  const unsigned long long u =
      (unsigned long long)__float2ll_rn(__fmul_rn(delta, kFix));
  unsigned* c = acc + 4 * idx;
  atomicAdd(c, (unsigned)u & 0xFFFFu);
  atomicAdd(c + 1, (unsigned)(u >> 16) & 0xFFFFu);
  atomicAdd(c + 2, (unsigned)(u >> 32));
  atomicAdd(c + 3, 1u);
  return !(fabsf(delta) <= limit);
}

// The prep pass: code k's V pair (max of A's columns, min of B's, NaN-
// propagating) and greedy actions, g_A | g_B << 3.
__global__ void altq_prep_kernel(const float* __restrict__ table,
                                 int n_codes, float2* vals) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_codes) return;
  float q[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) q[j] = table[(size_t)k * kCols + j];
  float va = q[0], vb = q[5];
#pragma unroll
  for (int j = 1; j < 5; ++j) {
    va = max_nan(va, q[j]);
    vb = min_nan(vb, q[5 + j]);
  }
  vals[k] = make_float2(va, vb);
  reinterpret_cast<uint8_t*>(vals + n_codes)[k] =
      (uint8_t)(mover_greedy(q, 1.0f) | mover_greedy(q + 5, -1.0f) << 3);
}

// Producer thread pt: the step codes of every tile, [lane][step] in the
// tile, each tile handed over on its kFull barrier once its ring slot is
// free again (its kEmpty barrier).  The thread keeps one step slot, so its
// words' keys are made once a tile.
template <bool kMod3, bool kScalars>
__device__ __forceinline__ void altq_produce(const AltqArgs& a,
                                             uint16_t* ring, int pt,
                                             int lane0, int n_tiles,
                                             int nthreads) {
  constexpr int kThreads = 32 * kProducers;
  constexpr uint32_t kW = 0xC2B2AE3Du;
  const int t_keep = 65536 - a.g.q_int, t_half = 65536 - a.g.q_int / 2;
  const int mask = a.g.nI - 1;
  const int per_tile = a.lanes * kTile;
  // kScalars: (seed, eps_int, step_offset) read from device memory when
  // the kernel runs (a call captured in a CUDA graph)
  const uint32_t seed_dev = kScalars ? (uint32_t)__ldg(a.scalars) : 0u;
  const int eps_dev = kScalars ? __ldg(a.scalars + 1) : 0;
  const int off_dev = kScalars ? __ldg(a.scalars + 2) : 0;
  const uint32_t slot = (uint32_t)(kScalars ? off_dev : a.step_offset) +
                        (uint32_t)(pt % kTile);
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kRingStages;
    if (k >= kRingStages) bar_sync(kEmpty + st, nthreads);
    uint16_t* tile = ring + st * per_tile;
    const uint32_t c0 =
        step_key(kScalars ? seed_dev : a.seed, slot + (uint32_t)(k * kTile));
    const uint32_t c1 = c0 + kW, c2 = c0 + 2u * kW;
    int l = pt / kTile;
#pragma unroll 1
    for (int j = pt; j < per_tile; j += kThreads) {
      const uint32_t lane = (uint32_t)(lane0 + l);
      const uint32_t b0 = fmix32(fmix32(lane ^ c0) + c0);
      const uint32_t b1 = fmix32(fmix32(lane ^ c1) + c1);
      const uint32_t b2 = fmix32(fmix32(lane ^ c2) + c2);
      const int x = u16(b0, 0) < (kScalars ? eps_dev : a.eps_int)
                        ? u16(b0, 1) % 5
                        : kGreedy;
      const int u = u16(b1, 0);
      tile[j] = (uint16_t)(x | ((u >= t_keep) + (u >= t_half)) << 3 |
                           isd_pick<kMod3>(u16(b2, 1), mask) << 5);
      l += kThreads / kTile;
    }
    bar_arrive(kFull + st, nthreads);
  }
}

// A consumer's walk over the ring, as K8/K9's `iql_walk`: tile k + 1
// loaded into registers before tile k's steps, its slot released after
// them; the last, partial tile read from its slot.  step(code) takes one
// step.
template <class Step>
__device__ __forceinline__ void altq_walk(const AltqArgs& a,
                                          const uint16_t* ring, int l,
                                          int n_tiles, int nthreads,
                                          Step& step) {
  const int per_tile = a.lanes * kTile;
  const int n_full = a.n_steps / kTile;
  const uint16_t* mine = ring + l * kTile;
  uint4 cur = make_uint4(0, 0, 0, 0), nxt = cur;
  if (n_tiles > 0) {
    bar_sync(kFull, nthreads);
    cur = *reinterpret_cast<const uint4*>(mine);
    if (kRingStages < n_tiles) bar_arrive(kEmpty, nthreads);
  }
  for (int k = 0; k < n_full; ++k) {
    const int k1 = k + 1, st1 = k1 % kRingStages;
    if (k1 < n_tiles) {
      bar_sync(kFull + st1, nthreads);
      nxt = *reinterpret_cast<const uint4*>(mine + st1 * per_tile);
    }
    const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int s = 0; s < kTile; ++s)
      step((w[s / 2] >> (16 * (s & 1))) & 0xFFFFu);
    if (k1 + kRingStages < n_tiles) bar_arrive(kEmpty + st1, nthreads);
    cur = nxt;
  }
  const uint16_t* last = mine + (n_full % kRingStages) * per_tile;
#pragma unroll 1
  for (int s = 0; s < a.n_steps - n_full * kTile; ++s)
    step((uint32_t)last[s]);
}

__device__ __forceinline__ int class_move(uint32_t cls, int a) {
  return (int)(kEffect >> (4 * ((int)cls * 5 + a))) & 7;
}

// What every walk keeps: the accumulators, the pending visit (its cell, -1
// for none, reward, continuation and baseline: V(s) for K10, q(s, a) for
// K11) and the lane's sums.
template <bool kSharedAcc>
struct Visits {
  long long* sums;   // device memory
  int* cnt;
  unsigned* acc;     // shared (kSharedAcc): the block's own cells
  float gamma, limit;
  bool active;
  int p_cell = -1;
  float p_r = 0.0f, p_cont = 0.0f, p_base = 0.0f;
  int rew = 0, goals = 0, truncs = 0, oor = 0;

  // The pending visit's retirement against the next state's V.
  __device__ __forceinline__ void settle(float v) {
    if (p_cell < 0) return;
    const float tgt = target(p_r, p_cont, v);
    if constexpr (kSharedAcc)
      oor += retire_shared(acc, p_cell, tgt, p_base, limit);
    else
      oor += retire(sums, cnt, p_cell, tgt, p_base, limit);
  }

  // The step's visit, pending until the next state's V, and its sums.
  __device__ __forceinline__ void visit(int cell, int r, bool goal,
                                        bool late, float base) {
    const bool term = goal | late;
    p_cell = active ? cell : -1;
    p_r = (float)r;
    p_cont = term ? 0.0f : gamma;
    p_base = base;
    rew += r;
    goals += goal;
    truncs += late & !goal;
  }
};

// A lane-step by the tick table: the state is cs2 = 2 x (2 x code + turn),
// a byte offset into a table row, and t.  The prepared V at float index
// cs2 / 2 and the greedy byte at cs2 / 4 are the state's; the next state
// is one shared load of the entry at (effective move, cs2) and a select
// against the reset code (the ISD entry's, A to move).  The pending visit
// is retired against V after the next state is known: a warp issues in
// order, so its accumulation (and K11's baseline, loaded a step earlier)
// waits behind the walk, not the walk behind it.
template <bool kPacked, bool kSharedAcc>
struct TableStep : Visits<kSharedAcc> {
  const char* tick;        // shared
  const float* vals;       // shared: V at 2 x code + turn
  const uint8_t* greedy;   // shared
  const float* table;
  int row_bytes, max_steps;
  uint32_t isd01, isd23;   // the ISD entries' cs2, two a register
  int cs2, t;

  __device__ __forceinline__ float value() const { return vals[cs2 >> 1]; }

  __device__ __forceinline__ void operator()(uint32_t code) {
    const int ct = cs2 >> 1;
    const float v = vals[ct];
    const int gr = (greedy[cs2 >> 2] >> (3 * (ct & 1))) & 7;
    const int x = code & 7u;
    const int act = x == kGreedy ? gr : x;
    const int cell = ct * 5 + act;
    float base = v;
    if constexpr (!kPacked) base = __ldg(table + cell);
    const int idx = (code >> 5) & 3;
    const int reset = ((idx & 2 ? isd23 : isd01) >> (16 * (idx & 1))) & 0xFFFF;
    const bool late = t + 1 >= max_steps;
    const int e = *reinterpret_cast<const uint16_t*>(
        tick + class_move((code >> 3) & 3u, act) * row_bytes + cs2);
    const bool goal = (e & kGoalBit) != 0;
    cs2 = (goal | late) ? reset : e & kCodeMask;
    t = (goal | late) ? 0 : t + 1;
    this->settle(v);
    this->visit(cell, goal ? ((e & kRewardBit) ? 1 : -1) : 0, goal, late,
                base);
  }
};

// A lane-step by arithmetic: the state's code, its prepared V and greedy
// action at (code, turn) (kAnyTurn: the mover's V and scan from the table,
// for a turn that is neither 0 nor 1), `alt_moves` under the effective
// move, the reset to the ISD entry's fields with A to move; then, as in
// TableStep, the pending visit's retirement.
template <bool kPacked, bool kSharedRows, bool kSharedAcc, bool kAnyTurn>
struct ArithStep : Visits<kSharedAcc> {
  const Game* g;
  const int* isd;          // shared: [kMaxIsd][5]
  const float* vals;       // V at 2 x code + turn: shared (kSharedRows) or
  const uint8_t* greedy;   // device memory
  const float* table;
  int nc;
  State s;
  int turn;

  // The V and greedy action at the state; ct = 2 x code + turn.
  __device__ __forceinline__ float look(int& ct, int& gr) const {
    const int k = cellpair_encode(s, *g, nc);
    ct = 2 * k + turn;
    if constexpr (kAnyTurn) {
      float q[5];
      const float v = mover_q(table, 5 * ct, turn, q);
      gr = mover_greedy(q, turn == 0 ? 1.0f : -1.0f);
      return v;
    } else if constexpr (kSharedRows) {
      gr = (greedy[k] >> (3 * turn)) & 7;
      return vals[ct];
    } else {
      gr = (__ldg(greedy + k) >> (3 * turn)) & 7;
      return __ldg(vals + ct);
    }
  }

  __device__ __forceinline__ float value() const {
    int ct, gr;
    return look(ct, gr);
  }

  __device__ __forceinline__ void operator()(uint32_t code) {
    int ct, gr;
    const float v = look(ct, gr);
    const int x = code & 7u;
    const int act = x == kGreedy ? gr : x;
    const int cell = ct * 5 + act;
    float base = v;
    if constexpr (!kPacked) base = __ldg(table + cell);
    const int* fp = isd + 5 * (int)((code >> 5) & 3u);
    const int f[5] = {lds(fp), lds(fp + 1), lds(fp + 2), lds(fp + 3),
                      lds(fp + 4)};
    const bool late = s.t + 1 >= g->max_steps;
    bool goal;
    int r;
    alt_moves(s, turn, class_move((code >> 3) & 3u, act), *g, goal, r);
    const bool term = goal | late;
    s.ra = term ? f[0] : s.ra;
    s.ca = term ? f[1] : s.ca;
    s.rb = term ? f[2] : s.rb;
    s.cb = term ? f[3] : s.cb;
    s.p = term ? f[4] : s.p;
    s.t = term ? 0 : s.t + 1;
    turn = term ? 0 : 1 - turn;
    this->settle(v);
    this->visit(cell, r, goal, late, base);
  }
};

// Walk lane l's steps with `step`, then retire its last visit against the
// final state's V.
template <class Step>
__device__ __forceinline__ void walk_all(const AltqArgs& a,
                                         const uint16_t* ring, int l,
                                         int n_tiles, int nthreads,
                                         Step& step) {
  altq_walk(a, ring, l, n_tiles, nthreads, step);
  step.settle(step.value());
}

template <bool kSharedAcc>
__device__ __forceinline__ Visits<kSharedAcc> visits(const AltqArgs& a,
                                                     unsigned* acc,
                                                     bool active) {
  Visits<kSharedAcc> v;
  v.sums = a.sums;
  v.cnt = a.cnt;
  v.acc = acc;
  v.gamma = a.gamma;
  v.limit = a.limit;
  v.active = active;
  return v;
}

// Consumer thread l: lane lane0 + l.  With the tick table (kTable) a warp
// whose lanes are all walkable, with turn 0 or 1, walks it; any other warp
// whose turns are all 0 or 1 steps by arithmetic on the prepared rows, and
// the rest by arithmetic on the table.  A ragged block's spare lanes step
// lane B - 1's state and keep nothing.
template <bool kPacked, bool kTable, bool kSharedRows, bool kSharedAcc>
__device__ __forceinline__ void altq_consume(
    const AltqArgs& a, const int* isd, const float2* vals,
    const uint8_t* greedy, const char* tick, const uint16_t* code_raw,
    unsigned* acc, uint64_t* bar, const uint16_t* ring, int l, int lane0,
    int n_tiles, int nthreads) {
  const int lane = lane0 + l, src = min(lane, a.B - 1);
  const bool active = lane < a.B;
  State s{a.in.f[0][src], a.in.f[1][src], a.in.f[2][src],
          a.in.f[3][src], a.in.f[4][src], a.in.f[6][src]};
  int turn = a.in.f[5][src];
  const float* v1 = reinterpret_cast<const float*>(vals);
  if constexpr (kSharedRows) wait_table(bar);  // no block leaves before it
  const bool turns = __all_sync(0xFFFFFFFFu, turn == 0 || turn == 1);
  bool by_table = false;
  if constexpr (kTable)
    by_table = turns && __all_sync(0xFFFFFFFFu, walkable(s, a.g));
  const Visits<kSharedAcc> init = visits<kSharedAcc>(a, acc, active);
  Visits<kSharedAcc> out;
  if (by_table) {
    TableStep<kPacked, kSharedAcc> step{init};
    const int nc = n_cells(a.g);
    int reset[kMaxIsd];
#pragma unroll
    for (int k = 0; k < kMaxIsd; ++k)
      reset[k] = 4 * cellpair_encode(isd_state(a.g, min(k, a.g.nI - 1)),
                                     a.g, nc);
    step.tick = tick;
    step.vals = v1;
    step.greedy = greedy;
    step.table = a.table;
    step.row_bytes = 4 * a.n_codes;
    step.max_steps = a.g.max_steps;
    step.isd01 = (uint32_t)reset[0] | (uint32_t)reset[1] << 16;
    step.isd23 = (uint32_t)reset[2] | (uint32_t)reset[3] << 16;
    step.cs2 = 2 * (2 * cellpair_encode(s, a.g, nc) + turn);
    step.t = s.t;
    walk_all(a, ring, l, n_tiles, nthreads, step);
    turn = (step.cs2 >> 1) & 1;
    int raw = code_raw[step.cs2 >> 2];
    s.p = raw & 1; raw >>= 1;
    s.cb = raw % a.g.W; raw /= a.g.W;
    s.rb = raw % a.g.H; raw /= a.g.H;
    s.ca = raw % a.g.W;
    s.ra = raw / a.g.W;
    s.t = step.t;
    out = step;
  } else {
    auto arith = [&](auto step) {
      step.g = &a.g;
      step.isd = isd;
      step.vals = v1;
      step.greedy = greedy;
      step.table = a.table;
      step.nc = n_cells(a.g);
      step.s = s;
      step.turn = turn;
      walk_all(a, ring, l, n_tiles, nthreads, step);
      s = step.s;
      turn = step.turn;
      out = step;
    };
    if (turns)
      arith(ArithStep<kPacked, kSharedRows, kSharedAcc, false>{init});
    else
      arith(ArithStep<kPacked, kSharedRows, kSharedAcc, true>{init});
  }
  if (!active) {
    out.rew = out.goals = out.truncs = 0;
  } else {
    a.out.f[0][lane] = s.ra; a.out.f[1][lane] = s.ca;
    a.out.f[2][lane] = s.rb; a.out.f[3][lane] = s.cb;
    a.out.f[4][lane] = s.p;  a.out.f[5][lane] = turn;
    a.out.f[6][lane] = s.t;
    if (out.oor)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + 3),
                (unsigned long long)out.oor);
  }
  warp_sum(a.stats, out.rew, out.goals, out.truncs);
}

// K10 (kPacked) and K11: blocks of a.lanes consumer threads, one a lane,
// then kProducers producer warps; with kSharedRows the prepared rows (and
// with kTable the tick table and the raw codes) are copied into shared
// memory by bulk copies while the producers start; with kSharedAcc the
// block's visits go to private accumulators in shared memory
// (retire_shared), added to the device's once, at the end, where a cell
// was visited.
template <bool kPacked, bool kTable, bool kSharedRows, bool kSharedAcc,
          bool kScalars>
__device__ __forceinline__ void altq_chunk_body(const AltqArgs& a) {
  static_assert(kSharedRows || !(kTable || kSharedAcc),
                "the tick table and the accumulators sit beside the rows");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* isd = reinterpret_cast<int*>(smem + 16);
  const int rbytes = kSharedRows ? row_bytes(a.n_codes) : 0;
  const int tbytes = kTable ? tick_bytes(a.n_codes) : 0;
  const int wbytes = kTable ? raw_bytes(a.n_codes) : 0;
  const float2* vals =
      kSharedRows ? reinterpret_cast<const float2*>(smem + kHead) : a.vals;
  const uint8_t* greedy = reinterpret_cast<const uint8_t*>(vals + a.n_codes);
  unsigned char* tick = smem + kHead + rbytes;
  const uint16_t* code_raw = reinterpret_cast<const uint16_t*>(tick + tbytes);
  uint16_t* ring = reinterpret_cast<uint16_t*>(tick + tbytes + wbytes);
  uint4* acc = reinterpret_cast<uint4*>(ring + kRingStages * kTile * a.lanes);
  const int n_cells_acc = kCols * a.n_codes;
  const int nthreads = a.lanes + 32 * kProducers;
  const int lane0 = blockIdx.x * a.lanes;
  const int n_tiles = a.n_steps / kTile + (a.n_steps % kTile != 0);
  const int l = threadIdx.x;
  if (threadIdx.x < kMaxIsd) {
    const State e = isd_state(a.g, min((int)threadIdx.x, a.g.nI - 1));
    int* f = isd + 5 * threadIdx.x;
    f[0] = e.ra; f[1] = e.ca; f[2] = e.rb; f[3] = e.cb; f[4] = e.p;
  }
  if constexpr (kSharedAcc) {
    for (int i = threadIdx.x; i < n_cells_acc; i += nthreads)
      acc[i] = make_uint4(0, 0, 0, 0);
  }
  if (kSharedRows && threadIdx.x == 0) init_bar(bar);
  __syncthreads();
  if (kSharedRows && threadIdx.x == 0) {
    expect_bytes(bar, rbytes + tbytes + wbytes);
    bulk_copy(bar, smem + kHead, a.vals, rbytes);
    if constexpr (kTable) {
      bulk_copy(bar, tick, a.tick, tbytes);
      bulk_copy(bar, tick + tbytes, a.code_raw, wbytes);
    }
  }
  if (l >= a.lanes) {
    if (a.g.nI == 3)
      altq_produce<true, kScalars>(a, ring, l - a.lanes, lane0, n_tiles,
                                   nthreads);
    else
      altq_produce<false, kScalars>(a, ring, l - a.lanes, lane0, n_tiles,
                                    nthreads);
  } else {
    altq_consume<kPacked, kTable, kSharedRows, kSharedAcc>(
        a, isd, vals, greedy, reinterpret_cast<const char*>(tick), code_raw,
        reinterpret_cast<unsigned*>(acc), bar, ring, l, lane0, n_tiles,
        nthreads);
  }
  if constexpr (kSharedAcc) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_cells_acc; i += nthreads) {
      const uint4 c = acc[i];
      if (c.w) {
        atomicAdd(reinterpret_cast<unsigned long long*>(a.sums + i),
                  ((unsigned long long)c.z << 32) +
                      ((unsigned long long)c.y << 16) + c.x);
        atomicAdd(a.cnt + i, (int)c.w);
      }
    }
  }
}

// The previous design, kept for ops/altq_variants.py (which dispatches it
// in place of the kernel to time it): one thread a lane hashing, scanning
// the table and stepping, its visits added to device memory.
template <bool kPacked>
__global__ void altq_kernel(AltPlanes in, AltPlanes out,
                            const float* __restrict__ table, long long* sums,
                            int* cnt, long long* stats, int B, int n_steps,
                            uint32_t seed, int eps_int, int step_offset,
                            float gamma, float limit, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0, out_of_range = 0;
  if (lane < B) {
    const int nc = n_cells(g);
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[6][lane]};
    int turn = in.f[5][lane];
    const uint32_t ctr = (uint32_t)lane;
    float q[5];
    // the pending retirement: its cell, reward, continuation and baseline
    // (V(s) for K10, q(s, a) for K11)
    int p_idx = -1;
    float p_r = 0.0f, p_cont = 0.0f, p_base = 0.0f;
    for (int i = 0; i < n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + step_offset);
      const uint32_t bits0 = random_word(seed, step, 0u, ctr);
      const uint32_t bits1 = random_word(seed, step, 1u, ctr);
      const uint32_t bits2 = random_word(seed, step, 2u, ctr);
      const int base = cellpair_encode(s, g, nc) * kCols + turn * 5;
      const float v = mover_q(table, base, turn, q);
      if (p_idx >= 0)
        out_of_range +=
            retire(sums, cnt, p_idx, target(p_r, p_cont, v), p_base, limit);
      const int best = mover_greedy(q, turn == 0 ? 1.0f : -1.0f);
      const int a = u16(bits0, 0) < eps_int ? u16(bits0, 1) % 5 : best;
      bool goal, trunc;
      int r;
      alt_transition(s, turn, a, bits1, g, goal, r);
      autoreset(s, goal, bits2, g, trunc);
      const bool term = goal || trunc;

      p_idx = base + a;
      p_r = (float)r;
      p_cont = term ? 0.0f : gamma;
      p_base = kPacked ? v : q[a];
      turn = term ? 0 : 1 - turn;
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    if (p_idx >= 0) {  // trailing retirement against the final state's V
      const int base = cellpair_encode(s, g, nc) * kCols + turn * 5;
      const float v = mover_q(table, base, turn, q);
      out_of_range +=
          retire(sums, cnt, p_idx, target(p_r, p_cont, v), p_base, limit);
    }
    if (out_of_range)
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + 3),
                (unsigned long long)out_of_range);
    out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
    out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
    out.f[4][lane] = s.p;  out.f[5][lane] = turn;
    out.f[6][lane] = s.t;
  }
  block_sum(stats, rew, goals, truncs);
}

template <bool kPacked, bool kTable, bool kSharedRows, bool kSharedAcc>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducers)
    altq_chunk_kernel(AltqArgs a) {
  altq_chunk_body<kPacked, kTable, kSharedRows, kSharedAcc, false>(a);
}

// The same chunk with its scalars read from device memory (a.scalars): the
// calls a CUDA graph captures.  A kernel of its own, so that the by-value
// kernel keeps its code.
template <bool kPacked, bool kTable, bool kSharedRows, bool kSharedAcc>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducers)
    altq_graph_chunk_kernel(AltqArgs a) {
  altq_chunk_body<kPacked, kTable, kSharedRows, kSharedAcc, true>(a);
}

constexpr int kMaxDevices = 64;

// A chunk's launch (altq_graph_chunk_kernel where a.scalars is set); the
// kernel's shared-memory limit is raised once per device and size, not on
// every call.
template <bool kPacked, bool kTable, bool kSharedRows, bool kSharedAcc>
cudaError_t launch_chunk(const AltqArgs& a, int device, int smem,
                         cudaStream_t st) {
  const bool graph = a.scalars != nullptr;
  auto kernel =
      graph ? altq_graph_chunk_kernel<kPacked, kTable, kSharedRows, kSharedAcc>
            : altq_chunk_kernel<kPacked, kTable, kSharedRows, kSharedAcc>;
  static int allowed[2][kMaxDevices] = {};
  if (device >= kMaxDevices || smem > allowed[graph][device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) allowed[graph][device] = smem;
  }
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  kernel<<<blocks, a.lanes + 32 * kProducers, smem, st>>>(a);
  return cudaGetLastError();
}

// Where a call keeps its prepared rows, its tick table and its
// accumulators (altq_codes.shared_rows, uses_table, shared_acc): shared
// memory when they fit beside the ring of the widest block (both boards'
// rows; 5x4's tick table, given by the caller where its entries hold the
// codes; 5x4's accumulators, when a block adds at most kAccMaxVisits
// values to a cell), else device memory, and no table.
struct Placement {
  bool rows, table, acc;
};

inline Placement placement(int n_codes, bool has_table, int lanes,
                           int n_steps) {
  const bool rows = fits(n_codes, 0, 0);
  const bool table = has_table && rows && fits(n_codes, n_codes, 0);
  return Placement{rows, table,
                   rows && fits(n_codes, table ? n_codes : 0, n_codes) &&
                       (long long)lanes * n_steps <= kAccMaxVisits};
}

template <bool kPacked>
cudaError_t dispatch(const AltqArgs& a, Placement p, int device, int smem,
                     cudaStream_t st) {
  if (p.table)
    return p.acc ? launch_chunk<kPacked, true, true, true>(a, device, smem, st)
                 : launch_chunk<kPacked, true, true, false>(a, device, smem,
                                                            st);
  if (p.rows)
    return p.acc ? launch_chunk<kPacked, false, true, true>(a, device, smem,
                                                            st)
                 : launch_chunk<kPacked, false, true, false>(a, device, smem,
                                                             st);
  return launch_chunk<kPacked, false, false, false>(a, device, smem, st);
}

// One chunk call: checks, one memset of the sums, stats and counts, the
// prep pass, the chunk.
int chunk(int device, void* const* in, void* buf, const float* table,
          const int16_t* tick, const uint16_t* code_raw,
          const int32_t* params, int n_codes, int B, int n_steps,
          uint32_t seed, int eps_int, int step_offset,
          const int32_t* scalars, float gamma, float limit, int packed,
          int lanes, void* stream) {
  if (B <= 0 || n_steps <= 0 || n_codes < 1 || lanes < 32 ||
      lanes > kMaxLanes || lanes % 32 != 0 || params[6] < 1 ||
      params[6] > kMaxIsd || eps_int < 0 || eps_int > 65536 ||
      step_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (tick != nullptr && (4 * n_codes > kCodeMask + 1 || code_raw == nullptr))
    return (int)cudaErrorInvalidValue;
  const Game g = make_game(params);
  const Placement p = placement(n_codes, tick != nullptr, lanes, n_steps);
  const int smem = smem_bytes(lanes, p.rows ? n_codes : 0,
                              p.table ? n_codes : 0, p.acc ? n_codes : 0);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AltqLayout l = altq_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, st);
  if (e != cudaSuccess) return (int)e;
  float2* vals = reinterpret_cast<float2*>(base + l.rows);
  altq_prep_kernel<<<(n_codes + 255) / 256, 256, 0, st>>>(table, n_codes,
                                                          vals);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int32_t* out[7];
  for (int k = 0; k < 7; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  const AltqArgs a{make_alt_planes(in),
                   make_alt_planes(reinterpret_cast<void* const*>(out)),
                   table, vals, tick, code_raw,
                   reinterpret_cast<long long*>(base + l.sums),
                   reinterpret_cast<int*>(base + l.cnt),
                   reinterpret_cast<long long*>(base + l.stats), n_codes,
                   lanes, B, n_steps, step_offset, eps_int, seed,
                   gamma, limit, g, scalars};
  return (int)(packed ? dispatch<true>(a, p, device, smem, st)
                      : dispatch<false>(a, p, device, smem, st));
}

}  // namespace

extern "C" {

// K10 (packed != 0: residual sums) or K11 (packed == 0: TD sums).
// device: the CUDA ordinal of every pointer and of the stream; in: host
// array of 7 device pointers to int32 [B] (ra, ca, rb, cb, p, turn, t);
// buf: one device allocation of gst_altq_layout's total bytes, which
// receives the int64 sums [n_codes, 10], the int64 stats [4] (reward sum,
// goals, truncations, values outside +-limit), the int32 counts [n_codes,
// 10] (all three zeroed here), the 7 output planes and the prepared rows;
// table: device float32 [n_codes, 10]; tick: device int16 [5 * 2 *
// n_codes], K4's tick table (rollout_codes.build_alt_table), with code_raw
// its raw codes, or null for the arithmetic walk; params: the game
// description (make_game); lanes: lanes per block, a multiple of 32 in
// [32, 512] (any fits: gst_altq_smem_bytes); scalars: null, or a device
// int32 [3] holding (seed, eps_int, step_offset), which the kernel then
// reads in place of those three arguments when it runs (a call captured
// in a CUDA graph); the caller keeps them in range.
int gst_altq_chunk(int device, void* const* in, void* buf, const float* table,
                   const int16_t* tick, const uint16_t* code_raw,
                   const int32_t* params, int n_codes, int B, int n_steps,
                   uint32_t seed, int eps_int, int step_offset,
                   const int32_t* scalars, float gamma, float limit,
                   int packed, int lanes, void* stream) {
  return chunk(device, in, buf, table, tick, code_raw, params, n_codes, B,
               n_steps, seed, eps_int, step_offset, scalars, gamma, limit,
               packed, lanes, stream);
}

// A call's byte offsets in buf (altq_codes.layout): sums, stats, cnt, the
// end of the zeroed span, the fields, the rows and the total.
void gst_altq_layout(int n_codes, int B, long long* out) {
  const AltqLayout l = altq_layout(n_codes, B);
  out[0] = l.sums; out[1] = l.stats; out[2] = l.cnt; out[3] = l.zero;
  out[4] = l.fields; out[5] = l.rows; out[6] = l.total;
}

// A chunk's dynamic shared memory per block (altq_codes.block_smem_bytes)
// and where it keeps its rows, tick table and accumulators (bits 0, 1, 2
// of *where: shared memory).
int gst_altq_smem_bytes(int lanes, int n_codes, int has_table, int n_steps,
                        int32_t* where) {
  const Placement p = placement(n_codes, has_table != 0, lanes, n_steps);
  *where = (int)p.rows | (int)p.table << 1 | (int)p.acc << 2;
  return smem_bytes(lanes, p.rows ? n_codes : 0, p.table ? n_codes : 0,
                    p.acc ? n_codes : 0);
}

// The pipeline: steps a tile, tiles in the ring, producer warps.
void gst_altq_shape(int32_t* out) {
  out[0] = kTile;
  out[1] = kRingStages;
  out[2] = kProducers;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
