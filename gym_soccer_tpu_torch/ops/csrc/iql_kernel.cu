// Independent-Q learner chunks for Hopper (sm_90a): kernels K8 and K9.
//
// Replaces the Pallas TPU kernels `_iql_packed_kernel` (K8, wrapper
// `iql_packed_chunk`) and `_iql_kernel` (K9, wrapper `iql_chunk`) of
// gym_soccer_tpu/ops/iql_kernel.py.  One template,
// `iql_chunk_kernel<kPacked, kSharedRows, kSharedAcc>`, computes both after
// its prep pass `iql_prep_kernel`; they differ only in the baseline a
// visit carries.  `iql_graph_chunk_kernel` is the same body reading the
// chunk's seed, eps_int and step offset from device memory: the calls the
// trainer's grouped mode captures in a CUDA graph (ops/dispatch.py).
//
// What it computes, for every lane (one independent game) and step i:
// four murmur3 counter words keyed on (chunk seed, i + step_offset, word,
// global lane); the compact cellpair code cp of the state; both players'
// greedy actions (a strict `>` scan from action 0 over the table's five
// values, so the lowest index wins a tie; the table holds double-bf16
// hi + lo, the values the JAX kernel acts on) and maxes at cp; the
// retirement of the PREVIOUS step, whose targets r + cont * max q_A(cp) and
// -r + cont * max q_B(cp) now have their bootstrap values; eps-greedy
// actions (A explores when the low 16 bits of word 0 are below eps_int and
// then takes the high 16 bits mod 5; B the same with word 3); the game
// transition and autoreset of K1 on words 1 and 2; cont = 0 on a goal or a
// truncation, else gamma.  After the last step a trailing retirement uses
// the maxes of the final (post-autoreset) state.  Per (cp, player, action)
// the kernel counts the visits and sums target - baseline, where the
// baseline is max q(s) for K8 (the Bellman residual; the host completes
// the TD with cnt * (max q - q) between chunks) and q(s, a) for K9 (the
// full TD).
//
// Exactness: the sums are int64 fixed point in units of 2^-32 (each value
// rounded once, to nearest), added with integer atomics, so they are the
// same in any order: the kernels equal their plain PyTorch versions bit
// for bit, for any block size, and a resumed training run equals an
// uninterrupted one.  They stay exact while every value lies within
// +-limit = 2^30 / (B * n_steps); each lane counts the values outside (or
// not finite) in a register and adds its count to stats[3] once, at the
// end, so the host need not read the table to know.  Every float
// operation is written with an explicit rounding intrinsic so that nvcc
// forms no FMA the plain version lacks.
//
// What bounded the previous design on this card (one thread a lane, 64
// blocks of 128 at 8192 lanes, 68 SMs idle, one warp a scheduler): each
// step was one dependent chain of four hashes, the state's code, ten table
// loads, two five-way scans, four global atomics and K1's transition: 327
// SASS a lane-step, 75-100 us of device time per 8192 x 64 chunk on an
// NVIDIA H100 80GB HBM3 at 700 W, under 5 % of its bound.  Most of that
// chain does not depend on the state: the four words, both players'
// explore-or-greedy choices and explored actions, the slip classes, the
// coin bits and the ISD index follow from (seed, step, lane) and the
// chunk's eps_int alone, and the table is frozen for the chunk, so a
// code's greedy actions and maxes are the same for every lane visiting it.
//
// What the design does about it: K5's split (learner_kernel.cu).
// Producer warps (kProducers a block) hash each (lane, step) into a 16-bit
// code (ops/iql_codes.py: each player's choice, an explored action or
// kGreedy; the two slip classes; the coin bits; the ISD index) handed over
// in tiles of kTile steps through a ring of kRingStages tiles on named
// barriers.  A prep pass turns each table row into the two maxes (a
// float2) and the two greedy actions (a byte): 9 B a code, 9,936 B on 5x4
// and 122,512 B on 11x7, so both boards' rows are copied into shared
// memory by bulk copies while the producers start (a board whose rows do
// not fit reads them from L2).  One consumer thread per lane reads its
// state's prepared row, retires the pending visits against its maxes,
// selects each action (the code's, or the row's greedy one: a select, not
// a branch), maps action and slip class to the effective move (a nibble
// table) and steps by the branch-free transition (step_moves) and the ISD
// reset.  K9 loads q(s, a_A) and q(s, a_B) from the table right after the
// actions are known and first reads them at the next step's retirement,
// off the chain.  `threads` is lanes per block, by default the fewest
// that keep the grid to one wave (64 at 8192 lanes, 512 at 65536).  The
// call is one allocation (outputs, sums, counts, stats, the prep pass's
// rows), zeroed where it sums by one memset.
//
// What bounds it then: the accumulation.  Four device-memory atomics a
// lane-step (two 8-byte sums, two 4-byte counts) took 31 of 62 us of an
// 8192 x 64 chunk on 5x4 and 244 of 284 us at the trainer's 65536 x 32,
// at the L2's rate for atomics rather than by contention (spreading them
// over neighbouring cells gained 3-7 %), and warp aggregation (match, then
// reductions) made it 11x slower.  So on boards whose accumulators fit
// beside the rows (kSharedAcc: 5x4's 1104 x 10 cells of 16 B, 176,640 B)
// each block adds its visits to its own cells in shared memory with four
// native 32-bit shared atomics (the sums of the fixed-point value's bits
// 0-15, 16-31 and 32-63, and the count: a 64-bit shared add compiles to a
// compare-and-swap loop), exact while a block adds at most kAccMaxVisits
// values to a cell, and adds its visited cells to device memory once, at
// the end.  11x7's 2.2 MB of cells do not fit; its visits go to device
// memory.  On an NVIDIA H100 80GB HBM3 at 700 W (ops/iql_variants.py,
// device time with the memset and the prep pass) an 8192 x 64 chunk takes
// 35.6 us on 5x4 (K8; K9 35.3) and 58.3 on 11x7 against the previous
// design's 76.0 and 83.5, and a 65536 x 32 chunk on 5x4 49.5 us against
// 278.0.

#include "pipeline.cuh"

using namespace gst;

namespace {

constexpr int kCols = 10;  // table and accumulator row: A's 5, then B's 5
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
// A block adds at most this many values to one private accumulator cell
// (lanes x steps), so that its 16-bit parts' 32-bit sums stay exact.
constexpr int kAccMaxVisits = 1 << 16;
// (slip class, action) -> the action whose move is made, a nibble each
// (learner_codes.EFFECT).
constexpr unsigned long long kEffect =
    0x43210ull | 0x12430ull << 20 | 0x21340ull << 40;
static_assert((32 * kProducers) % kTile == 0,
              "a producer thread keeps one step slot of every tile");

// The prep pass's rows of n codes (iql_codes.row_bytes): a float2 of
// maxes each, then a byte of greedy actions each, padded to 16 B.
__host__ __device__ constexpr int row_bytes(int n) {
  return (9 * n + 15) / 16 * 16;
}

// Dynamic shared memory of a block (iql_codes.smem_bytes): the head, the
// prepared rows of n_rows codes (0: in device memory), the ring and the
// private accumulators of n_acc codes (0: none), 16 B a cell.
__host__ __device__ constexpr int smem_bytes(int lanes, int n_rows,
                                             int n_acc) {
  return kHead + row_bytes(n_rows) + kRingStages * kTile * 2 * lanes +
         16 * kCols * n_acc;
}

__host__ __device__ constexpr bool fits(int n_rows, int n_acc) {
  return smem_bytes(kMaxLanes, n_rows, n_acc) <= kSmemBudget;
}

// Byte offsets in a call's one allocation (iql_codes.layout).
struct IqlLayout {
  long long sums, stats, cnt, zero, fields, rows, total;
};

inline IqlLayout iql_layout(int n_codes, int B) {
  IqlLayout l;
  l.sums = 0;
  l.stats = 8LL * kCols * n_codes;
  l.cnt = l.stats + 32;
  l.zero = l.cnt + 4LL * kCols * n_codes;
  l.fields = (l.zero + 15) / 16 * 16;
  l.rows = (l.fields + 24LL * B + 15) / 16 * 16;
  l.total = l.rows + row_bytes(n_codes);
  return l;
}

struct IqlArgs {
  Planes in, out;
  const float* table;     // [n_codes, 10]: K9's q(s, a)
  const float2* vals;     // the prep pass's maxes; its greedy bytes follow
  long long* sums;
  int* cnt;
  long long* stats;
  int n_codes, lanes, B, n_steps, step_offset, eps_int;
  uint32_t seed;
  float gamma, limit;
  Game g;
  // iql_graph_chunk_kernel: (seed, eps_int, step_offset) in device memory,
  // scalars[0..2]; last, so that the other fields keep their places
  const int32_t* scalars;
};

// Greedy action (strict > from action 0) and max of five Q values.
__device__ __forceinline__ int greedy(const float* q, float& best) {
  int a = 0;
  best = q[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    if (q[k] > best) {
      a = k;
      best = q[k];
    }
  }
  return a;
}

// One visit's value (r + cont * v_next) - base.
__device__ __forceinline__ float visit_value(float r, float cont,
                                             float v_next, float base) {
  return __fsub_rn(__fadd_rn(r, __fmul_rn(cont, v_next)), base);
}

// Add one visit's (r + cont * v_next) - base to cell idx; return 1 if it
// lies outside +-limit or is not finite, else 0.
__device__ __forceinline__ int retire(long long* sums, int* cnt, int idx,
                                      float r, float cont, float v_next,
                                      float base, float limit) {
  const float delta = visit_value(r, cont, v_next, base);
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
__device__ __forceinline__ int retire_shared(unsigned* acc, int idx, float r,
                                             float cont, float v_next,
                                             float base, float limit) {
  const float delta = visit_value(r, cont, v_next, base);
  const unsigned long long u =
      (unsigned long long)__float2ll_rn(__fmul_rn(delta, kFix));
  unsigned* c = acc + 4 * idx;
  atomicAdd(c, (unsigned)u & 0xFFFFu);
  atomicAdd(c + 1, (unsigned)(u >> 16) & 0xFFFFu);
  atomicAdd(c + 2, (unsigned)(u >> 32));
  atomicAdd(c + 3, 1u);
  return !(fabsf(delta) <= limit);
}

// The prep pass: code k's maxes and greedy actions, g_A | g_B << 3.
__global__ void iql_prep_kernel(const float* __restrict__ table, int n_codes,
                                float2* vals) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_codes) return;
  float q[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) q[j] = table[(size_t)k * kCols + j];
  float va, vb;
  const int ga = greedy(q, va), gb = greedy(q + 5, vb);
  vals[k] = make_float2(va, vb);
  reinterpret_cast<uint8_t*>(vals + n_codes)[k] = (uint8_t)(ga | gb << 3);
}

// Producer thread pt: the step codes of every tile, [lane][step] in the
// tile, each tile handed over on its kFull barrier once its ring slot is
// free again (its kEmpty barrier).  The thread keeps one step slot, so its
// words' keys are made once a tile.
template <bool kMod3, bool kScalars>
__device__ __forceinline__ void iql_produce(const IqlArgs& a, uint16_t* ring,
                                            int pt, int lane0, int n_tiles,
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
    const uint32_t c1 = c0 + kW, c2 = c0 + 2u * kW, c3 = c0 + 3u * kW;
    int l = pt / kTile;
#pragma unroll 1
    for (int j = pt; j < per_tile; j += kThreads) {
      const uint32_t lane = (uint32_t)(lane0 + l);
      const uint32_t b0 = fmix32(fmix32(lane ^ c0) + c0);
      const uint32_t b1 = fmix32(fmix32(lane ^ c1) + c1);
      const uint32_t b2 = fmix32(fmix32(lane ^ c2) + c2);
      const uint32_t b3 = fmix32(fmix32(lane ^ c3) + c3);
      const int xa = u16(b0, 0) < (kScalars ? eps_dev : a.eps_int)
                         ? u16(b0, 1) % 5
                         : kGreedy;
      const int xb = u16(b3, 0) < (kScalars ? eps_dev : a.eps_int)
                         ? u16(b3, 1) % 5
                         : kGreedy;
      const int ua = u16(b1, 0), ub = u16(b1, 1);
      const int sa = (ua >= t_keep) + (ua >= t_half);
      const int sb = (ub >= t_keep) + (ub >= t_half);
      tile[j] = (uint16_t)(xa | xb << 3 | sa << 6 | sb << 8 |
                           (int)(b2 & 3u) << 10 |
                           isd_pick<kMod3>(u16(b2, 1), mask) << 12);
      l += kThreads / kTile;
    }
    bar_arrive(kFull + st, nthreads);
  }
}

// A consumer's walk over the ring, as K1/K2's `walk`: tile k + 1 loaded
// into registers before tile k's steps, its slot released after them; the
// last, partial tile read from its slot.  step(code) takes one step.
template <class Step>
__device__ __forceinline__ void iql_walk(const IqlArgs& a,
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

// A lane-step: the state's prepared row (maxes, greedy actions), the
// pending visits' retirement against the maxes, both actions (the code's
// or the row's greedy one), the transition under the effective moves
// (step_moves), the reset to the ISD entry's fields; the visits stay
// pending until the next row's maxes.  Their baselines are the maxes (K8)
// or q(s, a_A), q(s, a_B) (K9), loaded from the table right after the
// actions are known and first read by the next step's retirement.
template <bool kPacked, bool kSharedRows, bool kSharedAcc>
struct IqlStep {
  const Game* g;
  const int* isd;          // shared: [kMaxIsd][5]
  const float2* vals;      // shared (kSharedRows) or device memory
  const uint8_t* greedy;
  const float* table;
  long long* sums;         // device memory
  int* cnt;
  unsigned* acc;           // shared (kSharedAcc): the block's own cells
  float gamma, limit;
  int nc;
  bool active;
  State s;
  int p_a, p_b;            // the pending visits' cells (p_a -1: none)
  float p_r, p_cont, p_base_a, p_base_b;
  int rew, goals, truncs, oor;

  __device__ __forceinline__ int row() const {
    return cellpair_encode(s, *g, nc);
  }

  __device__ __forceinline__ float2 maxes(int k) const {
    if constexpr (kSharedRows) return vals[k];
    else return __ldg(vals + k);
  }

  __device__ __forceinline__ int actions(int k) const {
    if constexpr (kSharedRows) return greedy[k];
    else return __ldg(greedy + k);
  }

  __device__ __forceinline__ int add(int idx, float r, float v_next,
                                     float base) {
    if constexpr (kSharedAcc)
      return retire_shared(acc, idx, r, p_cont, v_next, base, limit);
    else
      return retire(sums, cnt, idx, r, p_cont, v_next, base, limit);
  }

  __device__ __forceinline__ void settle(float2 v) {
    if (p_a >= 0)
      oor += add(p_a, p_r, v.x, p_base_a) + add(p_b, -p_r, v.y, p_base_b);
  }

  __device__ __forceinline__ void operator()(uint32_t code) {
    const int k = row();
    const float2 v = maxes(k);
    const int gr = actions(k);
    settle(v);
    const int xa = code & 7u, xb = (code >> 3) & 7u;
    const int aa = xa == kGreedy ? (gr & 7) : xa;
    const int ab = xb == kGreedy ? (gr >> 3) : xb;
    const int cell = k * kCols;
    float base_a = v.x, base_b = v.y;
    if constexpr (!kPacked) {
      base_a = __ldg(table + cell + aa);
      base_b = __ldg(table + cell + 5 + ab);
    }
    const int* fp = isd + 5 * (int)(code >> 12);
    const int f[5] = {lds(fp), lds(fp + 1), lds(fp + 2), lds(fp + 3),
                      lds(fp + 4)};
    const bool late = s.t + 1 >= g->max_steps;
    bool goal;
    int r;
    step_moves(s, class_move((code >> 6) & 3u, aa),
               class_move((code >> 8) & 3u, ab), (int)((code >> 10) & 3u),
               *g, goal, r);
    const bool term = goal | late;
    s.ra = term ? f[0] : s.ra;
    s.ca = term ? f[1] : s.ca;
    s.rb = term ? f[2] : s.rb;
    s.cb = term ? f[3] : s.cb;
    s.p = term ? f[4] : s.p;
    s.t = term ? 0 : s.t + 1;
    p_a = active ? cell + aa : -1;
    p_b = cell + 5 + ab;
    p_r = (float)r;
    p_cont = term ? 0.0f : gamma;
    p_base_a = base_a;
    p_base_b = base_b;
    rew += r;
    goals += goal;
    truncs += late & !goal;
  }
};

// Consumer thread l: lane lane0 + l; then the trailing retirement against
// the final state's maxes.  A ragged block's spare lanes step lane B - 1's
// state and keep nothing.
template <bool kPacked, bool kSharedRows, bool kSharedAcc>
__device__ __forceinline__ void iql_consume(
    const IqlArgs& a, const int* isd, const float2* vals,
    const uint8_t* greedy, unsigned* acc, uint64_t* bar,
    const uint16_t* ring, int l, int lane0, int n_tiles, int nthreads) {
  const int lane = lane0 + l, src = min(lane, a.B - 1);
  const bool active = lane < a.B;
  IqlStep<kPacked, kSharedRows, kSharedAcc> step{
      &a.g, isd, vals, greedy, a.table, a.sums, a.cnt, acc, a.gamma,
      a.limit, n_cells(a.g), active,
      State{a.in.f[0][src], a.in.f[1][src], a.in.f[2][src],
            a.in.f[3][src], a.in.f[4][src], a.in.f[5][src]},
      -1, -1, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0, 0, 0};
  if constexpr (kSharedRows) wait_table(bar);
  iql_walk(a, ring, l, n_tiles, nthreads, step);
  step.settle(step.maxes(step.row()));  // the last step, the final maxes
  if (!active) {
    step.rew = step.goals = step.truncs = 0;
  } else {
    const State& s = step.s;
    a.out.f[0][lane] = s.ra; a.out.f[1][lane] = s.ca;
    a.out.f[2][lane] = s.rb; a.out.f[3][lane] = s.cb;
    a.out.f[4][lane] = s.p;  a.out.f[5][lane] = s.t;
    if (step.oor)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + 3),
                (unsigned long long)step.oor);
  }
  warp_sum(a.stats, step.rew, step.goals, step.truncs);
}

// K8 (kPacked) and K9: blocks of a.lanes consumer threads, one a lane,
// then kProducers producer warps; with kSharedRows the prepared rows are
// copied into shared memory by bulk copies while the producers start;
// with kSharedAcc the block's visits go to private accumulators in shared
// memory (retire_shared), added to the device's once, at the end, where a
// cell was visited.
template <bool kPacked, bool kSharedRows, bool kSharedAcc, bool kScalars>
__device__ __forceinline__ void iql_chunk_body(const IqlArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* isd = reinterpret_cast<int*>(smem + 16);
  const int rbytes = kSharedRows ? row_bytes(a.n_codes) : 0;
  const float2* vals =
      kSharedRows ? reinterpret_cast<const float2*>(smem + kHead) : a.vals;
  const uint8_t* greedy = reinterpret_cast<const uint8_t*>(vals + a.n_codes);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kHead + rbytes);
  uint4* acc = reinterpret_cast<uint4*>(
      smem + kHead + rbytes + kRingStages * kTile * 2 * a.lanes);
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
    expect_bytes(bar, rbytes);
    bulk_copy(bar, smem + kHead, a.vals, rbytes);
  }
  if (l >= a.lanes) {
    if (a.g.nI == 3)
      iql_produce<true, kScalars>(a, ring, l - a.lanes, lane0, n_tiles,
                                  nthreads);
    else
      iql_produce<false, kScalars>(a, ring, l - a.lanes, lane0, n_tiles,
                                   nthreads);
  } else {
    iql_consume<kPacked, kSharedRows, kSharedAcc>(
        a, isd, vals, greedy, reinterpret_cast<unsigned*>(acc), bar, ring, l,
        lane0, n_tiles, nthreads);
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

template <bool kPacked, bool kSharedRows, bool kSharedAcc>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducers)
    iql_chunk_kernel(IqlArgs a) {
  iql_chunk_body<kPacked, kSharedRows, kSharedAcc, false>(a);
}

// The same chunk with its scalars read from device memory (a.scalars): the
// calls a CUDA graph captures.  A kernel of its own, so that the by-value
// kernel keeps its code.
template <bool kPacked, bool kSharedRows, bool kSharedAcc>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducers)
    iql_graph_chunk_kernel(IqlArgs a) {
  iql_chunk_body<kPacked, kSharedRows, kSharedAcc, true>(a);
}

constexpr int kMaxDevices = 64;

// A chunk's launch (iql_graph_chunk_kernel where a.scalars is set); the
// kernel's shared-memory limit is raised once per device and size, not on
// every call.
template <bool kPacked, bool kSharedRows, bool kSharedAcc>
cudaError_t launch_chunk(const IqlArgs& a, int device, int smem,
                         cudaStream_t st) {
  const bool graph = a.scalars != nullptr;
  auto kernel =
      graph ? iql_graph_chunk_kernel<kPacked, kSharedRows, kSharedAcc>
            : iql_chunk_kernel<kPacked, kSharedRows, kSharedAcc>;
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

// Where a call keeps its prepared rows and its accumulators: shared
// memory when they fit beside the ring of the widest block (5x4 and 11x7's
// rows; 5x4's accumulators, when a block adds at most kAccMaxVisits values
// to a cell), else device memory.
struct Placement {
  bool rows, acc;
};

inline Placement placement(int n_codes, int lanes, int n_steps) {
  const bool rows = fits(n_codes, 0);
  return Placement{rows, rows && fits(n_codes, n_codes) &&
                             (long long)lanes * n_steps <= kAccMaxVisits};
}

// One chunk call: checks, one memset of the sums, stats and counts, the
// prep pass, the chunk.
template <bool kPacked>
int chunk(int device, void* const* in, void* buf, const float* table,
          const int32_t* params, int n_codes, int B, int n_steps,
          uint32_t seed, int eps_int, int step_offset,
          const int32_t* scalars, float gamma, float limit, int lanes,
          void* stream) {
  if (B <= 0 || n_steps <= 0 || n_codes < 1 || lanes < 32 ||
      lanes > kMaxLanes || lanes % 32 != 0 || params[6] < 1 ||
      params[6] > kMaxIsd || eps_int < 0 || eps_int > 65536 ||
      step_offset < 0)
    return (int)cudaErrorInvalidValue;
  const Game g = make_game(params);
  const Placement p = placement(n_codes, lanes, n_steps);
  const int smem = smem_bytes(lanes, p.rows ? n_codes : 0,
                              p.acc ? n_codes : 0);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const IqlLayout l = iql_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, st);
  if (e != cudaSuccess) return (int)e;
  float2* vals = reinterpret_cast<float2*>(base + l.rows);
  iql_prep_kernel<<<(n_codes + 255) / 256, 256, 0, st>>>(table, n_codes,
                                                         vals);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int32_t* out[6];
  for (int k = 0; k < 6; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  const IqlArgs a{make_planes(in),
                  make_planes(reinterpret_cast<void* const*>(out)), table,
                  vals, reinterpret_cast<long long*>(base + l.sums),
                  reinterpret_cast<int*>(base + l.cnt),
                  reinterpret_cast<long long*>(base + l.stats), n_codes,
                  lanes, B, n_steps, step_offset, eps_int, seed,
                  gamma, limit, g, scalars};
  if (p.acc)
    return (int)launch_chunk<kPacked, true, true>(a, device, smem, st);
  return (int)(p.rows ? launch_chunk<kPacked, true, false>(a, device, smem, st)
                      : launch_chunk<kPacked, false, false>(a, device, smem,
                                                            st));
}

}  // namespace

extern "C" {

// K8 (packed != 0: residual sums) or K9 (packed == 0: TD sums).
// device: the CUDA ordinal of every pointer and of the stream; in: host
// array of 6 device pointers to int32 [B]; buf: one device allocation of
// gst_iql_layout's total bytes, which receives the int64 sums [n_codes,
// 10], the int64 stats [4] (reward sum, goals, truncations, values outside
// +-limit), the int32 counts [n_codes, 10] (all three zeroed here), the 6
// output planes and the prepared rows; table: device float32 [n_codes,
// 10]; params: the game description (make_game); lanes: lanes per block, a
// multiple of 32 in [32, 512] (any fits: gst_iql_smem_bytes); scalars:
// null, or a device int32 [3] holding (seed, eps_int, step_offset), which
// the kernel then reads in place of those three arguments when it runs (a
// call captured in a CUDA graph); the caller keeps them in range.
int gst_iql_chunk(int device, void* const* in, void* buf, const float* table,
                  const int32_t* params, int n_codes, int B, int n_steps,
                  uint32_t seed, int eps_int, int step_offset,
                  const int32_t* scalars, float gamma, float limit,
                  int packed, int lanes, void* stream) {
  return packed ? chunk<true>(device, in, buf, table, params, n_codes, B,
                              n_steps, seed, eps_int, step_offset, scalars,
                              gamma, limit, lanes, stream)
                : chunk<false>(device, in, buf, table, params, n_codes, B,
                               n_steps, seed, eps_int, step_offset, scalars,
                               gamma, limit, lanes, stream);
}

// A call's byte offsets in buf (iql_codes.layout): sums, stats, cnt, the
// end of the zeroed span, the fields, the rows and the total.
void gst_iql_layout(int n_codes, int B, long long* out) {
  const IqlLayout l = iql_layout(n_codes, B);
  out[0] = l.sums; out[1] = l.stats; out[2] = l.cnt; out[3] = l.zero;
  out[4] = l.fields; out[5] = l.rows; out[6] = l.total;
}

// A chunk's dynamic shared memory per block (iql_codes.smem_bytes).
int gst_iql_smem_bytes(int lanes, int n_codes, int n_steps) {
  const Placement p = placement(n_codes, lanes, n_steps);
  return smem_bytes(lanes, p.rows ? n_codes : 0, p.acc ? n_codes : 0);
}

// The pipeline: steps a tile, tiles in the ring, producer warps.
void gst_iql_shape(int32_t* out) {
  out[0] = kTile;
  out[1] = kRingStages;
  out[2] = kProducers;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
