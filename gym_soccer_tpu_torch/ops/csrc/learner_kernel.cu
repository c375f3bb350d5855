// Minimax-Q learner chunks for Hopper (sm_90a): kernels K5, K6 and K7.
//
// Replaces four Pallas TPU call sites of gym_soccer_tpu/ops/
// learner_kernel.py, one body each side:
//   chunk_kernel<true, *, false>   <- `_packed_kernel` (K5, wrapper
//                                     `packed_learner_chunk`)
//   chunk_kernel<true, *, true>    <- `_mg_packed_kernel` (K6, wrapper
//                                     `multigrid_packed_learner_chunk`)
//   chunk_kernel<false, *, false>  <- `_learner_kernel` (K7, wrapper
//                                     `learner_chunk`)
//   chunk_kernel<false, *, true>   <- `_mg_learner_kernel` (K7, wrapper
//                                     `multigrid_learner_chunk`)
// each launch after its prep pass prep_rows_kernel (the middle flag: the
// prepared rows in shared memory or in L2).  The JAX package serves all
// four from `_packed_body` / `_learner_body`, whose only switches are the
// accumulation layout and `planes is None`.  Here all four share the split
// design below (chunk_kernel<kPacked, kShared, kMulti>, and
// graph_chunk_kernel, the same body reading the chunk seed from device
// memory for the calls the trainers' grouped modes capture in a CUDA
// graph, ops/dispatch.py); learner_kernel,
// the previous design, serves only ops/learner_variants.py's
// previous-design variants of K5, K6 and K7.
//
// What it computes, for every lane (one independent game) and step i:
// three murmur3 counter words keyed on (chunk seed, i, word, global lane);
// the compact cellpair code cp of the state, plus, with kMulti, the lane's
// row offset into the variants' concatenated tables; the lane's 10
// exploration-mixed policy values and v at cp; the retirement of the
// PREVIOUS step, whose target r + cont * v(cp) now has its bootstrap
// value; actions sampled by first exceedance over the five pi values of
// each player (A from the low 16 bits of word 0, B from the high 16);
// the game transition and autoreset of K1 (kMulti: of K3, on the lane's
// own board); cont = 0 on a goal or a truncation, else gamma.  After the
// last step a trailing retirement uses v of the final (post-autoreset)
// state.  Per (cp, joint action) the kernel counts the visits and sums
// target - baseline, where the baseline is v(s) for the packed layout
// (kPacked: the Bellman residual; the host completes the TD sums with
// cnt * (v - q) between chunks) and q(s, a) for the unpacked one (the full
// TD).  Both step the same trajectories for the same policy columns.
//
// Table rows: pi_a[5], pi_b[5], v (11 columns), and with !kPacked q[25]
// after them (36 columns), all float32, v and q exact.
//
// Exactness: the sums are int64 fixed point in units of 2^-32 (each value
// rounded once, to nearest), added with integer atomics, so the sums are
// the same in any order: the kernels equal their plain PyTorch versions
// bit for bit, for any block size, and a training run resumed from a
// checkpoint equals an uninterrupted one.  They stay exact while every
// table value read (v, and q(s, a) when unpacked) lies within +-limit =
// 2^29 / (B * n_steps) (ops/learner_kernel.py `value_limit`); each lane
// counts the values outside (or not finite) in a register and adds its
// count to stats[3] once, at the end.  Every float operation is written
// with an explicit rounding intrinsic so that nvcc cannot contract
// r + cont * v into an FMA, which the plain version does not do.
//
// What bounds it on this card: the integer work of K1 (about 200 SASS
// instructions per lane-step) plus, per lane-step, two table reads (pi
// rows and v, 44 B, and q(s, a) when unpacked, from L1/L2) and two global
// atomics (an 8-byte sum and a 4-byte count) on 25 x n_codes cells, which
// contend where many lanes sit in the same state: the initial states right
// after resets.  The 5x4 tables are 48 KB packed and 159 KB unpacked, the
// accumulators 331 KB; all of it stays in the 50 MB L2.
//
// What the previous design (learner_kernel, PRs 1-6) did about it: one
// thread per lane with the state, its board (kMulti) and the pending
// retirement in registers and a loop over the steps (K1's previous shape);
// the table indexed directly by compact code and read through the
// read-only path (__ldg), in place of the TPU's one-hot matmul gathers and
// scatters over packed rows; atomics straight to L2.  There is no VMEM
// budget to guard: any grid and any mixture runs.
//
// K5.  In that design (64 blocks of 128 at 8192 lanes, 68 SMs idle) a
// step took ~2,160 cycles of one warp's chain for ~281 SASS: 76.6 us of
// device time per 8192 x 64 chunk on an NVIDIA H100 80GB HBM3 at 700 W
// (ops/learner_variants.py).  Most of a step does not depend on the state:
// the three words, the two sampling uniforms, each player's slip class,
// the coin bits and the ISD index.  K5 now splits a step as K1/K2 do.
// Producer warps (kProducers a block) hand each (lane, step)'s 40 bits over
// through a 2-tile ring: word 0 as it is and a side byte (slip classes,
// coin, ISD index).  One consumer thread per lane reads its state's
// prepared row, retires the previous step, samples both actions (one
// multiply and four compares each: a prep pass stores the running sums of
// pi in index order, sample5's roundings, beside v and the row's first
// accumulator cell), maps action and slip class to the effective move (a
// nibble table) and steps by the branch-free transition (step_moves).  On
// 5x4 the prepared rows (1104 x 48 B) are copied into shared memory by
// bulk copies; boards whose rows do not fit (11x7) read them from L2.
// `threads` is lanes per block, by default the fewest that keep the grid to
// one wave (64 at 8192 lanes, 512 at 65536), so the rows are copied once
// per SM.  The call is one allocation (outputs, sums, counts, stats, the
// prep pass's rows), zeroed where it sums by one memset.  A step table in
// shared memory (K1's, re-keyed by the 760 walkable states, beside their
// rows: 188,480 B) measured no faster, so the walk is arithmetic.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (ops/learner_variants.py, device
// time with the memset and the prep pass) an 8192 x 64 chunk takes 29.3 us
// against the previous design's 76.6 us (2.6x; 8.8 us of it the hashing
// alone; the rows in L2 cost 38.2 us).  What bounds K5 at the contract's
// 65536 x 32 is its accumulation: two global atomics a lane-step (an
// 8-byte sum, a 4-byte count) take ~81 of its 117 us, and the previous
// design is as fast there (115 us).  Warp-aggregated atomics win 5-7 % at
// 65536 x 32 and lose 2x on 8192 x 64 (60 us): lanes of a warp seldom
// share a cell.  A block's visits at 65536 x 32 fall on about half as many
// distinct cells (7,577 of 16,384 on 5x4), so privatising the accumulators
// in shared memory is the next lever; they do not fit beside the rows and
// the ring on 5x4 (19,000 walkable cells at 10 B), so it is not built here.
//
// K7 (both sites) takes K5's design.  In the previous one (learner_kernel,
// 64 blocks of 128 at 8192 lanes) an 8192 x 64 chunk took 86.7 us of
// kernel on 5x4 and 67.0 us on the mixture, each step one dependent chain
// from the hash to the q(s, a) load.  The producers hand over K5's word
// and side byte; on a mixture the slip class and the ISD index are the
// lane's (its slip entry in shared memory, filled by its consumer once a
// block; the blocked layout puts at most two variants in a block).  The
// prep pass reads the 36-column table into K5's prepared rows, so a step
// samples as K5's does; the rows are in shared memory on 5x4 and in L2 on
// 11x7 and on the mixture (8,928 codes).  The baseline q(s, a) stays in the
// table: its load is issued right after the sample and first read by the
// next step's retirement, off the chain.  On a mixture the consumer keeps
// its board (LaneBoard) and its row offset in registers and computes its
// ISD resets; the prepared row's cell carries the offset.  On an NVIDIA
// H100 80GB HBM3 at 700 W (ops/learner_variants.py, device time with the
// memset and the prep pass) an 8192 x 64 chunk takes 33.1 us on 5x4, 46.5
// on 11x7 and 43.7 on the 3-board mixture, against the previous design's
// 91.3, 96.0 and 69.8 us; q(s, a) in shared memory too gains 2 % on 5x4,
// so it stays in L2.  The calls are host-bound (the wrapper's work).
//
// K6 is K7 multigrid's instance on the packed table, chunk_kernel<true,
// kShared, true>: the same producers (the lane's slip entry from shared
// memory), one consumer a lane keeping its board and row offset in
// registers, and K5's baseline v(s) from the prepared row, so no q(s, a)
// load.  The rows go to shared memory where shared_rows allows it (the
// --multigrid recipe's 5x4 + 6x5: 3,624 codes, 223,200 B a block at 512
// lanes; a one-board mixture) and are read from L2 elsewhere (the 3-board
// mixture's 8,928 codes, 5x4 + 11x7's 14,720).  A window of a block's own
// variants' rows would not bring those under the budget: 8x6's rows alone
// are 254,592 B.  On an NVIDIA H100 80GB HBM3 at 700 W
// (ops/learner_variants.py, device time with the memset and the prep pass)
// an 8192 x 64 chunk takes 43.1 us on the 3-board mixture and a 16384 x 64
// one 44.4 us on 5x4 + 6x5, against the previous design's 55.7 and 56.4
// (64 or 128 blocks of 128 threads, each thread a whole lane-step); at
// 32768 x 64 both take 92-96 us, 41 of them the accumulation atomics.

#include "pipeline.cuh"

using namespace gst;

namespace {

constexpr int kColV = 10;  // v after pi_a[5], pi_b[5]
constexpr int kColQ = 11;  // q[25] after v (unpacked rows only)
constexpr int kNJ = 25;    // joint actions
constexpr float kFix = 4294967296.0f;  // 2^32: fixed-point scale

// First exceedance of u * total over the running sums of five
// probabilities, summed in index order (learner_kernel.py `sample5`); the
// previous design's sampler, so unreferenced where no variant builds it.
[[maybe_unused]] __device__ __forceinline__ int sample5(
    const float* __restrict__ pi, float u) {
  float c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) c[k] = __ldg(pi + k);
  float total = c[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) total = __fadd_rn(total, c[k]);
  const float target = __fmul_rn(u, total);
  int a = 0;
  float s = c[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    a += s <= target;
    s = __fadd_rn(s, c[k]);
  }
  return a;
}

// Add one visit's (r + cont * v_next) - base to cell idx.
__device__ __forceinline__ void retire(long long* sums, int* cnt, int idx,
                                       float r, float cont, float v_next,
                                       float base) {
  const float delta = __fsub_rn(__fadd_rn(r, __fmul_rn(cont, v_next)), base);
  const long long fixed = __float2ll_rn(__fmul_rn(delta, kFix));
  atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
            (unsigned long long)fixed);
  atomicAdd(cnt + idx, 1);
}

// 1 if a table value lies outside +-limit or is not finite, else 0.
__device__ __forceinline__ int out_of(float x, float limit) {
  return !(fabsf(x) <= limit);
}

// The step loop of one lane on board g, whose rows start at row cpo of the
// table.  Adds the lane's stats to rew, goals, truncs and its count of
// out-of-range table values to out_of_range.
template <bool kPacked, class G>
__device__ __forceinline__ void learn_lane(
    State& s, const G& g, int cpo, int lane, const float* __restrict__ table,
    long long* sums, int* cnt, int n_steps, uint32_t seed, float gamma,
    float limit, int& rew, int& goals, int& truncs, int& out_of_range) {
  constexpr int kCols = kPacked ? kColQ : kColQ + kNJ;
  const int nc = n_cells(g);
  const uint32_t ctr = (uint32_t)lane;
  // the pending retirement: cell index, reward, continuation, baseline
  // (v(s) packed, q(s, a) unpacked)
  int p_idx = -1;
  float p_r = 0.0f, p_cont = 0.0f, p_base = 0.0f;
  for (int i = 0; i < n_steps; ++i) {
    const uint32_t bits0 = random_word(seed, (uint32_t)i, 0u, ctr);
    const uint32_t bits1 = random_word(seed, (uint32_t)i, 1u, ctr);
    const uint32_t bits2 = random_word(seed, (uint32_t)i, 2u, ctr);
    const int cp = cellpair_encode(s, g, nc) + cpo;
    const float* row = table + (size_t)cp * kCols;
    const float v_here = __ldg(row + kColV);
    out_of_range += out_of(v_here, limit);
    if (p_idx >= 0) retire(sums, cnt, p_idx, p_r, p_cont, v_here, p_base);

    // u16 / 65536 is exact in float32
    const float ua = (float)u16(bits0, 0) * (1.0f / 65536.0f);
    const float ub = (float)u16(bits0, 1) * (1.0f / 65536.0f);
    const int aa = sample5(row, ua);
    const int ab = sample5(row + 5, ub);
    bool goal, trunc;
    int r;
    transition(s, aa, ab, bits1, bits2, g, goal, r);
    autoreset(s, goal, bits2, g, trunc);

    const int ja = aa * 5 + ab;
    p_idx = cp * kNJ + ja;
    p_r = (float)r;
    p_cont = (goal || trunc) ? 0.0f : gamma;
    if constexpr (kPacked) {
      p_base = v_here;
    } else {
      p_base = __ldg(row + kColQ + ja);
      out_of_range += out_of(p_base, limit);
    }
    rew += r;
    goals += goal;
    truncs += trunc;
  }
  if (p_idx >= 0) {  // trailing retirement against the final state's v
    const int cp = cellpair_encode(s, g, nc) + cpo;
    const float v_end = __ldg(table + (size_t)cp * kCols + kColV);
    out_of_range += out_of(v_end, limit);
    retire(sums, cnt, p_idx, p_r, p_cont, v_end, p_base);
  }
}

// geo (kMulti only): the planes H, W, glo, ghi, q_int and the lane's row
// offset; g: the shared board (!kMulti) or just max_steps (kMulti).
template <bool kPacked, bool kMulti>
__global__ void learner_kernel(Planes in, Planes out, Planes geo,
                               const float* __restrict__ table,
                               long long* sums, int* cnt, long long* stats,
                               int B, int n_steps, uint32_t seed,
                               float gamma, float limit, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0, out_of_range = 0;
  if (lane < B) {
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[5][lane]};
    if constexpr (kMulti) {
      learn_lane<kPacked>(s, lane_game(geo, lane, g.max_steps),
                          geo.f[5][lane], lane, table, sums, cnt, n_steps,
                          seed, gamma, limit, rew, goals, truncs,
                          out_of_range);
    } else {
      learn_lane<kPacked>(s, g, 0, lane, table, sums, cnt, n_steps, seed,
                          gamma, limit, rew, goals, truncs, out_of_range);
    }
    if (out_of_range)
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + 3),
                (unsigned long long)out_of_range);
    out.f[0][lane] = s.ra; out.f[1][lane] = s.ca;
    out.f[2][lane] = s.rb; out.f[3][lane] = s.cb;
    out.f[4][lane] = s.p;  out.f[5][lane] = s.t;
  }
  block_sum(stats, rew, goals, truncs);
}

// ---------------------------------------------------------------------
// K5, K6 and K7 (both sites): producer warps make step codes, consumer
// threads walk and learn
// ---------------------------------------------------------------------

constexpr int kTile = 8;          // steps a ring tile holds
constexpr int kRingStages = 2;    // tiles in the ring
constexpr int kProducers = 8;     // producer warps a block
constexpr int kMaxLanes = 512;    // lanes per block: 768 threads at most
constexpr int kRowBytes = 48;     // a prepared row (learner_codes.py)
constexpr int kSmemBudget = 232448;
constexpr int kHead = 16 + 4 * kMaxIsd * 5;  // mbarrier, ISD fields
constexpr int kFull = 1;          // named barriers: a tile is written
constexpr int kEmpty = 1 + kRingStages;  // ... and read
constexpr int kColsUnpacked = kColQ + kNJ;  // an unpacked table row
// (slip class, action) -> the action whose move is made, a nibble each
// (learner_codes.EFFECT).
constexpr unsigned long long kEffect =
    0x43210ull | 0x12430ull << 20 | 0x21340ull << 40;
static_assert((32 * kProducers) % kTile == 0,
              "a producer thread keeps one step slot of every tile");

// Shared memory of a split chunk's block (learner_codes.smem_bytes): the
// head, the prepared rows of n_rows codes (0: the rows stay in device
// memory), the ring and, on a mixture (multi), each lane's slip entry
// (lane_slip).
__host__ __device__ constexpr int chunk_smem_bytes(int lanes, int n_rows,
                                                   bool multi) {
  return kHead + kRowBytes * n_rows + kRingStages * kTile * 5 * lanes +
         (multi ? 16 * lanes : 0);
}

// The rows go to shared memory when they fit beside the ring of the
// widest block (learner_codes.shared_rows: 5x4's 1104 codes, 52,992 B; the
// mixture 5x4 + 6x5's 3,624, 173,952 B).
__host__ __device__ constexpr bool shared_rows(int n_codes, bool multi) {
  return chunk_smem_bytes(kMaxLanes, n_codes, multi) <= kSmemBudget;
}

// Byte offsets in a split chunk call's one allocation
// (learner_codes.layout).
struct ChunkLayout {
  long long sums, stats, cnt, zero, fields, rows, total;
};

inline ChunkLayout chunk_layout(int n_codes, int B) {
  ChunkLayout l;
  l.sums = 0;
  l.stats = 8LL * kNJ * n_codes;
  l.cnt = l.stats + 32;
  l.zero = l.cnt + 4LL * kNJ * n_codes;
  l.fields = (l.zero + 15) / 16 * 16;
  l.rows = (l.fields + 24LL * B + 15) / 16 * 16;
  l.total = l.rows + (long long)kRowBytes * n_codes;
  return l;
}

struct ChunkArgs {
  Planes in, out, geo;  // geo (a mixture): H, W, glo, ghi, q_int, row offset
  const float4* rows;   // the prep pass's rows, [n_codes][3]
  const float* q;       // the unpacked table's q(s, 0) column (K7)
  long long* sums;
  int* cnt;
  long long* stats;
  int n_codes, lanes, B, n_steps;
  uint32_t seed;
  float gamma, limit;
  Game g;               // a mixture: max_steps alone
  // graph_chunk_kernel: the chunk seed in device memory, scalars[0]; last,
  // so that the other fields keep their places
  const int32_t* scalars;
};

// The prep pass: compact code k's row of a table of `cols` columns as a
// prepared row, the running sums of pi in index order (sample5's
// roundings), v and the row's first accumulator cell.
__global__ void prep_rows_kernel(const float* __restrict__ table, int cols,
                                 int n_codes, float4* rows) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_codes) return;
  const float* src = table + (size_t)k * cols;
  float c[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) c[j] = src[j];
#pragma unroll
  for (int j = 1; j < 5; ++j) {
    c[j] = __fadd_rn(c[j - 1], c[j]);
    c[5 + j] = __fadd_rn(c[4 + j], c[5 + j]);
  }
  rows[3 * k] = make_float4(c[0], c[1], c[2], c[3]);
  rows[3 * k + 1] = make_float4(c[4], c[5], c[6], c[7]);
  rows[3 * k + 2] = make_float4(c[8], c[9], src[kColV],
                                __int_as_float(k * kNJ));
}

// Producer thread pt: each tile's words [lane][step] and side bytes
// (slip class a | slip class b << 2 | coin << 4 | ISD index << 6), handed
// over as K1/K2's tiles are.  The steps of a chunk count from 0; its seed
// is a.seed, or with kScalars scalars[0] in device memory, read when the
// kernel runs (a call captured in a CUDA graph, whose arguments are
// frozen).  One board: its slip thresholds and ISD pick; a mixture
// (kMulti): lane lane0 + l's, from its slip entry.
template <bool kMod3, bool kMulti, bool kScalars>
__device__ __forceinline__ void learn_produce(const ChunkArgs& a,
                                             unsigned char* ring,
                                             const int4* slip, int pt,
                                             int lane0, int n_tiles,
                                             int nthreads) {
  constexpr int kThreads = 32 * kProducers;
  int t_keep = 65536 - a.g.q_int, t_half = 65536 - a.g.q_int / 2;
  int mask = a.g.nI - 1;
  const int per_tile = a.lanes * kTile;
  const uint32_t slot = (uint32_t)(pt % kTile);
  const uint32_t seed_dev = kScalars ? (uint32_t)__ldg(a.scalars) : 0u;
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kRingStages;
    if (k >= kRingStages) bar_sync(kEmpty + st, nthreads);
    uint32_t* words = reinterpret_cast<uint32_t*>(ring + st * 5 * per_tile);
    uint8_t* side = ring + st * 5 * per_tile + 4 * per_tile;
    const uint32_t c0 =
        step_key(kScalars ? seed_dev : a.seed, slot + (uint32_t)(k * kTile));
    const uint32_t c1 = c0 + 0xC2B2AE3Du, c2 = c0 + 2u * 0xC2B2AE3Du;
    int l = pt / kTile;
#pragma unroll 1
    for (int j = pt; j < per_tile; j += kThreads) {
      if constexpr (kMulti) {
        const int4 b = slip[l];
        t_keep = b.x; t_half = b.y; mask = b.z;
      }
      const uint32_t lane = (uint32_t)(lane0 + l);
      const uint32_t b0 = fmix32(fmix32(lane ^ c0) + c0);
      const uint32_t b1 = fmix32(fmix32(lane ^ c1) + c1);
      const uint32_t b2 = fmix32(fmix32(lane ^ c2) + c2);
      const int ua = u16(b1, 0), ub = u16(b1, 1);
      const int ca = (ua >= t_keep) + (ua >= t_half);
      const int cb = (ub >= t_keep) + (ub >= t_half);
      words[j] = b0;
      side[j] = (uint8_t)(ca | (cb << 2) | ((b2 & 3u) << 4) |
                          (isd_pick<kMod3>(u16(b2, 1), mask) << 6));
      l += kThreads / kTile;
    }
    bar_arrive(kFull + st, nthreads);
  }
}

// Consumer l's tile: its kTile words and side bytes into registers.
__device__ __forceinline__ void load_tile(const unsigned char* stage,
                                          int per_tile, int l,
                                          uint32_t (&w)[kTile],
                                          uint32_t (&sd)[kTile / 4]) {
  const uint4* q = reinterpret_cast<const uint4*>(stage) + l * (kTile / 4);
#pragma unroll
  for (int v = 0; v < kTile / 4; ++v) {
    const uint4 x = q[v];
    w[4 * v] = x.x; w[4 * v + 1] = x.y; w[4 * v + 2] = x.z; w[4 * v + 3] = x.w;
  }
  const uint2 y = reinterpret_cast<const uint2*>(stage + 4 * per_tile)[l];
  sd[0] = y.x;
  sd[1] = y.y;
}

// A consumer's walk over the ring, as K1/K2's `walk`: tile k + 1 loaded
// into registers before tile k's steps; step(word, side) takes one step.
template <class Step>
__device__ __forceinline__ void learn_walk(const ChunkArgs& a,
                                           const unsigned char* ring, int l,
                                           int n_tiles, int nthreads,
                                           Step& step) {
  const int per_tile = a.lanes * kTile;
  const int n_full = a.n_steps / kTile;
  uint32_t cw[kTile], nw[kTile], cs[kTile / 4], ns[kTile / 4];
  if (n_tiles > 0) {
    bar_sync(kFull, nthreads);
    load_tile(ring, per_tile, l, cw, cs);
    if (kRingStages < n_tiles) bar_arrive(kEmpty, nthreads);
  }
  for (int k = 0; k < n_full; ++k) {
    const int k1 = k + 1, st1 = k1 % kRingStages;
    if (k1 < n_tiles) {
      bar_sync(kFull + st1, nthreads);
      load_tile(ring + st1 * 5 * per_tile, per_tile, l, nw, ns);
    }
#pragma unroll
    for (int s = 0; s < kTile; ++s)
      step(cw[s], (cs[s / 4] >> (8 * (s & 3))) & 0xFFu);
    if (k1 + kRingStages < n_tiles) bar_arrive(kEmpty + st1, nthreads);
#pragma unroll
    for (int v = 0; v < kTile; ++v) cw[v] = nw[v];
#pragma unroll
    for (int v = 0; v < kTile / 4; ++v) cs[v] = ns[v];
  }
  const unsigned char* last = ring + (n_full % kRingStages) * 5 * per_tile;
  const uint32_t* lw = reinterpret_cast<const uint32_t*>(last) + l * kTile;
  const uint8_t* ls = last + 4 * per_tile + l * kTile;
#pragma unroll 1
  for (int s = 0; s < a.n_steps - n_full * kTile; ++s) step(lw[s], ls[s]);
}

__device__ __forceinline__ int class_move(uint32_t cls, int a) {
  return (int)(kEffect >> (4 * ((int)cls * 5 + a))) & 7;
}

// Prepared row k: from shared memory (kShared) or through the read-only
// path from device memory.
template <bool kShared>
__device__ __forceinline__ void load_row(const float4* rows, int k,
                                         float4& x, float4& y, float4& z) {
  if constexpr (kShared) {
    x = rows[3 * k]; y = rows[3 * k + 1]; z = rows[3 * k + 2];
  } else {
    x = __ldg(rows + 3 * k); y = __ldg(rows + 3 * k + 1);
    z = __ldg(rows + 3 * k + 2);
  }
}

// A lane's board on one board: the launch's game, its ISD entries' fields
// in shared memory.
struct OneBoard {
  const Game* g;
  const int* isd;  // shared: [kMaxIsd][5]
  int nc;

  __device__ __forceinline__ int row(const State& s) const {
    return cellpair_encode(s, *g, nc);
  }
  __device__ __forceinline__ const Game& geo() const { return *g; }
  __device__ __forceinline__ int max_steps() const { return g->max_steps; }
  __device__ __forceinline__ void isd_fields(int idx, int (&f)[5]) const {
    const int* fp = isd + 5 * idx;
    f[0] = lds(fp); f[1] = lds(fp + 1); f[2] = lds(fp + 2);
    f[3] = lds(fp + 3); f[4] = lds(fp + 4);
  }
};

// A lane's own board on a mixture (K6, K7 multigrid): its geometry in
// registers, its rows from row offset cpo of the concatenated table.
struct OwnBoard {
  LaneBoard b;
  int nc, cpo;

  __device__ __forceinline__ int row(const State& s) const {
    return cellpair_encode(s, b, nc) + cpo;
  }
  __device__ __forceinline__ const LaneBoard& geo() const { return b; }
  __device__ __forceinline__ int max_steps() const { return b.max_steps; }
  __device__ __forceinline__ void isd_fields(int idx, int (&f)[5]) const {
    b.isd(idx, f);
  }
};

// A lane-step: the state's prepared row (x, y, z: the running sums of
// pi_a and pi_b with their totals, v, the first accumulator cell), the
// previous step's retirement against its v, both actions sampled by first
// exceedance of u * total (one multiply and four compares: sample5), the
// transition under the effective moves (step_moves), the reset to the ISD
// entry's fields; the visit stays pending until the next row's v.  Its
// baseline is v(s) (kPacked, K5) or q(s, a) (K7), loaded from the table
// right after the sample and first read by the next step's retirement, off
// the chain; its out-of-range test is made there too.
template <bool kPacked, bool kShared, class Board>
struct LearnStep {
  Board b;
  const float4* rows;
  const float* q;         // the unpacked table's q(s, 0) column
  long long* sums;
  int* cnt;
  float gamma, limit;
  bool active;
  State s;
  int p_idx;              // the pending visit: cell (-1: none),
  float p_r, p_cont, p_base;  // reward, continuation, baseline
  int rew, goals, truncs, oor;

  // The pending visit's retirement against v_next, its baseline's range
  // test with it (K7).
  __device__ __forceinline__ void settle(float v_next) {
    if (p_idx >= 0) {
      if constexpr (!kPacked) oor += out_of(p_base, limit);
      retire(sums, cnt, p_idx, p_r, p_cont, v_next, p_base);
    }
  }

  __device__ __forceinline__ void operator()(uint32_t word, uint32_t side) {
    const int k = b.row(s);
    float4 x, y, z;
    load_row<kShared>(rows, k, x, y, z);
    oor += out_of(z.z, limit);
    settle(z.z);
    // u16 / 65536 is exact in float32
    const float ta = __fmul_rn((float)(word & 0xFFFFu) * (1.0f / 65536.0f),
                               y.x);
    const float tb = __fmul_rn((float)(word >> 16) * (1.0f / 65536.0f), z.y);
    const int aa = (x.x <= ta) + (x.y <= ta) + (x.z <= ta) + (x.w <= ta);
    const int ab = (y.y <= tb) + (y.z <= tb) + (y.w <= tb) + (z.x <= tb);
    const int ja = aa * 5 + ab;
    float base = z.z;
    if constexpr (!kPacked) base = __ldg(q + (size_t)k * kColsUnpacked + ja);
    int f[5];
    b.isd_fields((int)(side >> 6), f);
    const bool late = s.t + 1 >= b.max_steps();
    bool goal;
    int r;
    step_moves(s, class_move(side & 3u, aa), class_move((side >> 2) & 3u, ab),
               (int)((side >> 4) & 3u), b.geo(), goal, r);
    const bool term = goal | late;
    s.ra = term ? f[0] : s.ra;
    s.ca = term ? f[1] : s.ca;
    s.rb = term ? f[2] : s.rb;
    s.cb = term ? f[3] : s.cb;
    s.p = term ? f[4] : s.p;
    s.t = term ? 0 : s.t + 1;
    p_idx = active ? __float_as_int(z.w) + ja : -1;
    p_r = (float)r;
    p_cont = term ? 0.0f : gamma;
    p_base = base;
    rew += r;
    goals += goal;
    truncs += late & !goal;
  }
};

// Consumer thread l: lane lane0 + l on its board; then the trailing
// retirement against the final state's v.  A ragged block's spare lanes
// step lane B - 1's state and keep nothing.
template <bool kPacked, bool kShared, class Board>
__device__ __forceinline__ void learn_consume(const ChunkArgs& a, Board board,
                                              const float4* rows,
                                              uint64_t* bar,
                                              const unsigned char* ring,
                                              int l, int lane0, int n_tiles,
                                              int nthreads) {
  const int lane = lane0 + l, src = min(lane, a.B - 1);
  const bool active = lane < a.B;
  LearnStep<kPacked, kShared, Board> step{
      board, rows, a.q, a.sums, a.cnt, a.gamma, a.limit, active,
      State{a.in.f[0][src], a.in.f[1][src], a.in.f[2][src],
            a.in.f[3][src], a.in.f[4][src], a.in.f[5][src]},
      -1, 0.0f, 0.0f, 0.0f, 0, 0, 0, 0};
  if constexpr (kShared) wait_table(bar);
  learn_walk(a, ring, l, n_tiles, nthreads, step);
  float4 x, y, z;   // the last step, against the final state's v
  load_row<kShared>(rows, step.b.row(step.s), x, y, z);
  if (step.p_idx >= 0) step.oor += out_of(z.z, a.limit);
  step.settle(z.z);
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

// K5, K6 (kPacked) and K7: blocks of a.lanes consumer threads, one a
// lane, then kProducers producer warps; with kShared the prepared rows are
// copied into shared memory by bulk copies while the producers start.  On
// a mixture (kMulti: K6, K7 multigrid) each consumer first puts its lane's
// slip entry in shared memory for the producers.
template <bool kPacked, bool kShared, bool kMulti, bool kScalars>
__device__ __forceinline__ void chunk_body(const ChunkArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* isd = reinterpret_cast<int*>(smem + 16);
  const int rbytes = kShared ? kRowBytes * a.n_codes : 0;
  const float4* rows =
      kShared ? reinterpret_cast<const float4*>(smem + kHead) : a.rows;
  unsigned char* ring = smem + kHead + rbytes;
  int4* slip = reinterpret_cast<int4*>(ring + kRingStages * kTile * 5 *
                                                  a.lanes);
  const int nthreads = a.lanes + 32 * kProducers;
  const int lane0 = blockIdx.x * a.lanes;
  const int n_tiles = a.n_steps / kTile + (a.n_steps % kTile != 0);
  const int l = threadIdx.x, src = min(lane0 + l, a.B - 1);
  if constexpr (kMulti) {
    if (l < a.lanes) slip[l] = lane_slip(a.geo.f[4][src], a.geo.f[0][src]);
  } else if (threadIdx.x < kMaxIsd) {
    const State e = isd_state(a.g, min((int)threadIdx.x, a.g.nI - 1));
    int* f = isd + 5 * threadIdx.x;
    f[0] = e.ra; f[1] = e.ca; f[2] = e.rb; f[3] = e.cb; f[4] = e.p;
  }
  if (kShared && threadIdx.x == 0) init_bar(bar);
  __syncthreads();
  if (kShared && threadIdx.x == 0) {
    expect_bytes(bar, rbytes);
    bulk_copy(bar, smem + kHead, a.rows, rbytes);
  }
  if (l >= a.lanes) {
    if constexpr (kMulti)
      learn_produce<false, true, kScalars>(a, ring, slip, l - a.lanes, lane0,
                                           n_tiles, nthreads);
    else if (a.g.nI == 3)
      learn_produce<true, false, kScalars>(a, ring, slip, l - a.lanes, lane0,
                                           n_tiles, nthreads);
    else
      learn_produce<false, false, kScalars>(a, ring, slip, l - a.lanes,
                                            lane0, n_tiles, nthreads);
  } else if constexpr (kMulti) {
    const LaneBoard b = lane_board(a.geo, src, a.g.max_steps);
    learn_consume<kPacked, kShared>(a, OwnBoard{b, n_cells(b), a.geo.f[5][src]},
                                    rows, bar, ring, l, lane0, n_tiles,
                                    nthreads);
  } else {
    learn_consume<kPacked, kShared>(a, OneBoard{&a.g, isd, n_cells(a.g)},
                                    rows, bar, ring, l, lane0, n_tiles,
                                    nthreads);
  }
}

template <bool kPacked, bool kShared, bool kMulti>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducers)
    chunk_kernel(ChunkArgs a) {
  chunk_body<kPacked, kShared, kMulti, false>(a);
}

// The same chunk with its seed read from device memory (a.scalars): the
// calls a CUDA graph captures.  A kernel of its own, so that the seed
// argument's kernel keeps its code.
template <bool kPacked, bool kShared, bool kMulti>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducers)
    graph_chunk_kernel(ChunkArgs a) {
  chunk_body<kPacked, kShared, kMulti, true>(a);
}

constexpr int kMaxDevices = 64;

// A split chunk's launch (graph_chunk_kernel where a.scalars is set); the
// kernel's shared-memory limit is raised once per device and size, not on
// every call.
template <bool kPacked, bool kShared, bool kMulti>
cudaError_t launch_chunk(const ChunkArgs& a, int device, int smem,
                         cudaStream_t st) {
  const bool graph = a.scalars != nullptr;
  auto kernel = graph ? graph_chunk_kernel<kPacked, kShared, kMulti>
                      : chunk_kernel<kPacked, kShared, kMulti>;
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

// A split chunk call (K5, K6, K7; kMulti: geo and params = {max_steps}):
// checks, one memset of the sums, stats and counts, the prep pass, the
// chunk.
template <bool kPacked, bool kMulti>
int chunk(int device, void* const* in, void* const* geo, void* buf,
          const float* table, const int32_t* params, int n_codes, int B,
          int n_steps, uint32_t seed, const int32_t* scalars, float gamma,
          float limit, int lanes, void* stream) {
  if (B <= 0 || n_steps <= 0 || n_codes < 1 || lanes < 32 ||
      lanes > kMaxLanes || lanes % 32 != 0 || (kMulti && geo == nullptr) ||
      (!kMulti && (params[6] < 1 || params[6] > kMaxIsd)))
    return (int)cudaErrorInvalidValue;
  Game g{};
  if constexpr (kMulti) g.max_steps = params[0];
  else g = make_game(params);
  const bool shared = shared_rows(n_codes, kMulti);
  const int smem = chunk_smem_bytes(lanes, shared ? n_codes : 0, kMulti);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ChunkLayout l = chunk_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, st);
  if (e != cudaSuccess) return (int)e;
  float4* rows = reinterpret_cast<float4*>(base + l.rows);
  prep_rows_kernel<<<(n_codes + 255) / 256, 256, 0, st>>>(
      table, kPacked ? kColQ : kColsUnpacked, n_codes, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int32_t* out[6];
  for (int k = 0; k < 6; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  const ChunkArgs a{make_planes(in),
                    make_planes(reinterpret_cast<void* const*>(out)),
                    kMulti ? make_planes(geo) : Planes{}, rows,
                    table + kColQ,
                    reinterpret_cast<long long*>(base + l.sums),
                    reinterpret_cast<int*>(base + l.cnt),
                    reinterpret_cast<long long*>(base + l.stats), n_codes,
                    lanes, B, n_steps, seed, gamma, limit, g, scalars};
  return (int)(shared ? launch_chunk<kPacked, true, kMulti>(a, device, smem, st)
                      : launch_chunk<kPacked, false, kMulti>(a, device, smem,
                                                             st));
}

template <bool kPacked, bool kMulti>
int launch(int device, void* const* in, void* const* out, void* const* geo,
           const float* table, long long* sums, int* cnt, long long* stats,
           const int32_t* params, int B, int n_steps, uint32_t seed,
           float gamma, float limit, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Game g{};
  Planes gp{};
  cudaError_t e;
  if constexpr (kMulti) {
    e = check_launch(device, B, threads);
    g.max_steps = params[0];
    gp = make_planes(geo);
  } else {
    e = prepare(device, params, B, threads, stats, st);
    g = make_game(params);
  }
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + threads - 1) / threads;
  learner_kernel<kPacked, kMulti><<<blocks, threads, 0, st>>>(
      make_planes(in), make_planes(out), gp, table, sums, cnt, stats, B,
      n_steps, seed, gamma, limit, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6.  As K7 multigrid (gst_multigrid_learner_chunk), with table: device
// float32 [n_codes, 11].
int gst_multigrid_packed_learner_chunk(int device, void* const* in,
                                       void* const* geo, void* buf,
                                       const float* table,
                                       const int32_t* params, int n_codes,
                                       int B, int n_steps, uint32_t seed,
                                       const int32_t* scalars, float gamma,
                                       float limit, int lanes, void* stream) {
  return chunk<true, true>(device, in, geo, buf, table, params, n_codes, B,
                           n_steps, seed, scalars, gamma, limit, lanes,
                           stream);
}

// K5.  in: host array of 6 device pointers to int32 [B]; buf: one device
// allocation of gst_chunk_layout's total bytes, which receives the int64
// sums [n_codes, 25], the int64 stats [4], the int32 counts [n_codes, 25]
// (all three zeroed here), the 6 output planes and the prepared rows;
// table: device float32 [n_codes, 11]; params: the game description
// (make_game); seed: the chunk seed, unless scalars (a device int32 [1]
// holding it, or null) is set: a call captured in a CUDA graph reads its
// seed when it runs; lanes: lanes per block, a multiple of 32 in [32, 512]
// (any fits: gst_chunk_smem_bytes).
int gst_packed_learner_chunk(int device, void* const* in, void* buf,
                             const float* table, const int32_t* params,
                             int n_codes, int B, int n_steps, uint32_t seed,
                             const int32_t* scalars, float gamma,
                             float limit, int lanes, void* stream) {
  return chunk<true, false>(device, in, nullptr, buf, table, params, n_codes,
                            B, n_steps, seed, scalars, gamma, limit, lanes,
                            stream);
}

// K7.  As K5, with table: device float32 [n_codes, 36].
int gst_learner_chunk(int device, void* const* in, void* buf,
                      const float* table, const int32_t* params, int n_codes,
                      int B, int n_steps, uint32_t seed,
                      const int32_t* scalars, float gamma, float limit,
                      int lanes, void* stream) {
  return chunk<false, false>(device, in, nullptr, buf, table, params,
                             n_codes, B, n_steps, seed, scalars, gamma,
                             limit, lanes, stream);
}

// K7 multigrid.  As K7, with geo: host array of 6 device pointers to int32
// [B] (H, W, glo, ghi, q_int, row offset) and params: {max_steps}.
int gst_multigrid_learner_chunk(int device, void* const* in,
                                void* const* geo, void* buf,
                                const float* table, const int32_t* params,
                                int n_codes, int B, int n_steps,
                                uint32_t seed, const int32_t* scalars,
                                float gamma, float limit, int lanes,
                                void* stream) {
  return chunk<false, true>(device, in, geo, buf, table, params, n_codes, B,
                            n_steps, seed, scalars, gamma, limit, lanes,
                            stream);
}

// The split chunks' byte offsets in buf (learner_codes.layout): sums,
// stats, cnt, the end of the zeroed span, the fields, the rows and the
// total.
void gst_chunk_layout(int n_codes, int B, long long* out) {
  const ChunkLayout l = chunk_layout(n_codes, B);
  out[0] = l.sums; out[1] = l.stats; out[2] = l.cnt; out[3] = l.zero;
  out[4] = l.fields; out[5] = l.rows; out[6] = l.total;
}

// A split chunk's dynamic shared memory per block (learner_codes.
// smem_bytes); multi: a mixture's.
int gst_chunk_smem_bytes(int lanes, int n_codes, int multi) {
  return chunk_smem_bytes(
      lanes, shared_rows(n_codes, multi != 0) ? n_codes : 0, multi != 0);
}

// The split chunks' pipeline: steps a tile, tiles in the ring, producer
// warps.
void gst_chunk_shape(int32_t* out) {
  out[0] = kTile;
  out[1] = kRingStages;
  out[2] = kProducers;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
