// Minimax-Q learner chunks for Hopper (sm_90a): kernels K5, K6 and K7.
//
// Replaces four Pallas TPU call sites of gym_soccer_tpu/ops/
// learner_kernel.py, one body each side:
//   packed_kernel<*>              <- `_packed_kernel` (K5, wrapper
//                                    `packed_learner_chunk`), with its
//                                    prep pass prep_rows_kernel
//   learner_kernel<true, true>    <- `_mg_packed_kernel` (K6, wrapper
//                                    `multigrid_packed_learner_chunk`)
//   learner_kernel<false, false>  <- `_learner_kernel` (K7, wrapper
//                                    `learner_chunk`)
//   learner_kernel<false, true>   <- `_mg_learner_kernel` (K7, wrapper
//                                    `multigrid_learner_chunk`)
// The JAX package serves all four from `_packed_body` / `_learner_body`,
// whose only switches are the accumulation layout and `planes is None`;
// here K6 and K7 are learner_kernel's two template flags, and K5, the
// flagship's kernel, has a design of its own (below).
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
// What the design of K6/K7 does about it: one thread per lane with the
// state, its board (kMulti) and the pending retirement in registers and a
// loop over the steps (K1's previous shape); the table is indexed directly
// by compact code and read through the read-only path (__ldg), in place of
// the TPU's one-hot matmul gathers and scatters over packed rows; atomics
// go straight to L2.  There is no VMEM budget to guard: any grid and any
// mixture runs.
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

#include "pipeline.cuh"

using namespace gst;

namespace {

constexpr int kColV = 10;  // v after pi_a[5], pi_b[5]
constexpr int kColQ = 11;  // q[25] after v (unpacked rows only)
constexpr int kNJ = 25;    // joint actions
constexpr float kFix = 4294967296.0f;  // 2^32: fixed-point scale

// First exceedance of u * total over the running sums of five
// probabilities, summed in index order (learner_kernel.py `sample5`).
__device__ __forceinline__ int sample5(const float* __restrict__ pi,
                                       float u) {
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
// K5: producer warps make step codes, consumer threads walk and learn
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
// (slip class, action) -> the action whose move is made, a nibble each
// (learner_codes.EFFECT).
constexpr unsigned long long kEffect =
    0x43210ull | 0x12430ull << 20 | 0x21340ull << 40;
static_assert((32 * kProducers) % kTile == 0,
              "a producer thread keeps one step slot of every tile");

// Shared memory of a K5 block (learner_codes.smem_bytes): the head, the
// prepared rows of n_rows codes (0: the rows stay in device memory) and
// the ring.
__host__ __device__ constexpr int packed_smem_bytes(int lanes, int n_rows) {
  return kHead + kRowBytes * n_rows + kRingStages * kTile * 5 * lanes;
}

// The rows go to shared memory when they fit beside the ring of the
// widest block (learner_codes.shared_rows: 5x4's 1104 codes, 52,992 B).
__host__ __device__ constexpr bool shared_rows(int n_codes) {
  return packed_smem_bytes(kMaxLanes, n_codes) <= kSmemBudget;
}

// Byte offsets in a K5 call's one allocation (learner_codes.layout).
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

struct PackedArgs {
  Planes in, out;
  const float4* rows;   // the prep pass's rows, [n_codes][3]
  long long* sums;
  int* cnt;
  long long* stats;
  int n_codes, lanes, B, n_steps;
  uint32_t seed;
  float gamma, limit;
  Game g;
};

// The prep pass: compact code k's table row as a prepared row, the
// running sums of pi in index order (sample5's roundings).
__global__ void prep_rows_kernel(const float* __restrict__ table,
                                 int n_codes, float4* rows) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_codes) return;
  const float* src = table + (size_t)k * kColQ;
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
// over as K1/K2's tiles are.  The steps of a chunk count from 0.
template <bool kMod3>
__device__ __forceinline__ void learn_produce(const PackedArgs& a,
                                             unsigned char* ring, int pt,
                                             int lane0, int n_tiles,
                                             int nthreads) {
  constexpr int kThreads = 32 * kProducers;
  const int t_keep = 65536 - a.g.q_int, t_half = 65536 - a.g.q_int / 2;
  const int per_tile = a.lanes * kTile;
  const uint32_t slot = (uint32_t)(pt % kTile);
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kRingStages;
    if (k >= kRingStages) bar_sync(kEmpty + st, nthreads);
    uint32_t* words = reinterpret_cast<uint32_t*>(ring + st * 5 * per_tile);
    uint8_t* side = ring + st * 5 * per_tile + 4 * per_tile;
    const uint32_t c0 = step_key(a.seed, slot + (uint32_t)(k * kTile));
    const uint32_t c1 = c0 + 0xC2B2AE3Du, c2 = c0 + 2u * 0xC2B2AE3Du;
    uint32_t lane = (uint32_t)(lane0 + pt / kTile);
#pragma unroll 1
    for (int j = pt; j < per_tile; j += kThreads) {
      const uint32_t b0 = fmix32(fmix32(lane ^ c0) + c0);
      const uint32_t b1 = fmix32(fmix32(lane ^ c1) + c1);
      const uint32_t b2 = fmix32(fmix32(lane ^ c2) + c2);
      const int ua = u16(b1, 0), ub = u16(b1, 1);
      const int ca = (ua >= t_keep) + (ua >= t_half);
      const int cb = (ub >= t_keep) + (ub >= t_half);
      words[j] = b0;
      side[j] = (uint8_t)(ca | (cb << 2) | ((b2 & 3u) << 4) |
                          (isd_pick<kMod3>(u16(b2, 1), a.g.nI - 1) << 6));
      lane += kThreads / kTile;
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
__device__ __forceinline__ void learn_walk(const PackedArgs& a,
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

// A lane-step: the state's prepared row (x, y, z: the running sums of
// pi_a and pi_b with their totals, v, the first accumulator cell), the
// previous step's retirement against its v, both actions sampled by first
// exceedance of u * total (one multiply and four compares: sample5), the
// transition under the effective moves (step_moves), the reset to the ISD
// entry's fields; the visit stays pending until the next row's v.
template <bool kShared>
struct LearnStep {
  const Game* g;
  const float4* rows;
  const int* isd_fields;  // shared: [kMaxIsd][5]
  long long* sums;
  int* cnt;
  float gamma, limit;
  bool active;
  int nc;
  State s;
  int p_idx;              // the pending visit: cell (-1: none),
  float p_r, p_cont, p_base;  // reward, continuation, baseline v(s)
  int rew, goals, truncs, oor;

  __device__ __forceinline__ void operator()(uint32_t word, uint32_t side) {
    float4 x, y, z;
    load_row<kShared>(rows, cellpair_encode(s, *g, nc), x, y, z);
    oor += out_of(z.z, limit);
    if (p_idx >= 0) retire(sums, cnt, p_idx, p_r, p_cont, z.z, p_base);
    // u16 / 65536 is exact in float32
    const float ta = __fmul_rn((float)(word & 0xFFFFu) * (1.0f / 65536.0f),
                               y.x);
    const float tb = __fmul_rn((float)(word >> 16) * (1.0f / 65536.0f), z.y);
    const int aa = (x.x <= ta) + (x.y <= ta) + (x.z <= ta) + (x.w <= ta);
    const int ab = (y.y <= tb) + (y.z <= tb) + (y.w <= tb) + (z.x <= tb);
    const int* fp = isd_fields + 5 * (int)(side >> 6);
    const int f[5] = {lds(fp), lds(fp + 1), lds(fp + 2), lds(fp + 3),
                      lds(fp + 4)};
    const bool late = s.t + 1 >= g->max_steps;
    bool goal;
    int r;
    step_moves(s, class_move(side & 3u, aa), class_move((side >> 2) & 3u, ab),
               (int)((side >> 4) & 3u), *g, goal, r);
    const bool term = goal | late;
    s.ra = term ? f[0] : s.ra;
    s.ca = term ? f[1] : s.ca;
    s.rb = term ? f[2] : s.rb;
    s.cb = term ? f[3] : s.cb;
    s.p = term ? f[4] : s.p;
    s.t = term ? 0 : s.t + 1;
    p_idx = active ? __float_as_int(z.w) + aa * 5 + ab : -1;
    p_r = (float)r;
    p_cont = term ? 0.0f : gamma;
    p_base = z.z;
    rew += r;
    goals += goal;
    truncs += late & !goal;
  }
};

// K5's consumer thread l: lane lane0 + l; then the trailing retirement
// against the final state's v.
template <bool kShared>
__device__ __forceinline__ void learn_consume(const PackedArgs& a,
                                              const float4* rows,
                                              uint64_t* bar, const int* isd,
                                              const unsigned char* ring,
                                              int l, int lane0, int n_tiles,
                                              int nthreads) {
  const int lane = lane0 + l;
  const bool active = lane < a.B;
  LearnStep<kShared> step{
      &a.g, rows, isd, a.sums, a.cnt, a.gamma, a.limit, active,
      n_cells(a.g),
      active ? State{a.in.f[0][lane], a.in.f[1][lane], a.in.f[2][lane],
                     a.in.f[3][lane], a.in.f[4][lane], a.in.f[5][lane]}
             : isd_state(a.g, 0),
      -1, 0.0f, 0.0f, 0.0f, 0, 0, 0, 0};
  if constexpr (kShared) wait_table(bar);
  learn_walk(a, ring, l, n_tiles, nthreads, step);
  if (step.p_idx >= 0) {  // the last step, against the final state's v
    float4 x, y, z;
    load_row<kShared>(rows, cellpair_encode(step.s, a.g, step.nc), x, y, z);
    step.oor += out_of(z.z, a.limit);
    retire(a.sums, a.cnt, step.p_idx, step.p_r, step.p_cont, z.z,
           step.p_base);
  }
  if (!active) {
    step.rew = step.goals = step.truncs = 0;  // a ragged block's spare lanes
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

// K5: blocks of a.lanes consumer threads, one a lane, then kProducers
// producer warps; with kShared the prepared rows are copied into shared
// memory by bulk copies while the producers start.
template <bool kShared>
__global__ void __launch_bounds__(kMaxLanes + 32 * kProducers)
    packed_kernel(PackedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* isd = reinterpret_cast<int*>(smem + 16);
  const int rbytes = kShared ? kRowBytes * a.n_codes : 0;
  const float4* rows =
      kShared ? reinterpret_cast<const float4*>(smem + kHead) : a.rows;
  unsigned char* ring = smem + kHead + rbytes;
  const int nthreads = a.lanes + 32 * kProducers;
  const int lane0 = blockIdx.x * a.lanes;
  const int n_tiles = a.n_steps / kTile + (a.n_steps % kTile != 0);
  if (threadIdx.x < kMaxIsd) {
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
  if ((int)threadIdx.x >= a.lanes) {
    if (a.g.nI == 3)
      learn_produce<true>(a, ring, threadIdx.x - a.lanes, lane0, n_tiles,
                          nthreads);
    else
      learn_produce<false>(a, ring, threadIdx.x - a.lanes, lane0, n_tiles,
                           nthreads);
  } else {
    learn_consume<kShared>(a, rows, bar, isd, ring, threadIdx.x, lane0,
                           n_tiles, nthreads);
  }
}

constexpr int kMaxDevices = 64;

// The main launch; the kernel's shared-memory limit is raised once per
// device and size, not on every call.
template <bool kShared>
cudaError_t launch_packed(const PackedArgs& a, int device, int smem,
                          cudaStream_t st) {
  auto kernel = packed_kernel<kShared>;
  static int allowed[kMaxDevices] = {};
  if (device >= kMaxDevices || smem > allowed[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  kernel<<<blocks, a.lanes + 32 * kProducers, smem, st>>>(a);
  return cudaGetLastError();
}

// K5's call: checks, one memset of the sums, stats and counts, the prep
// pass, the chunk.
int packed_chunk(int device, void* const* in, void* buf, const float* table,
                 const int32_t* params, int n_codes, int B, int n_steps,
                 uint32_t seed, float gamma, float limit, int lanes,
                 void* stream) {
  if (params[6] < 1 || params[6] > kMaxIsd || B <= 0 || n_steps <= 0 ||
      n_codes < 1 || lanes < 32 || lanes > kMaxLanes || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const bool shared = shared_rows(n_codes);
  const int smem = packed_smem_bytes(lanes, shared ? n_codes : 0);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ChunkLayout l = chunk_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, st);
  if (e != cudaSuccess) return (int)e;
  float4* rows = reinterpret_cast<float4*>(base + l.rows);
  prep_rows_kernel<<<(n_codes + 255) / 256, 256, 0, st>>>(table, n_codes,
                                                          rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int32_t* out[6];
  for (int k = 0; k < 6; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  PackedArgs a{make_planes(in), make_planes(reinterpret_cast<void* const*>(out)),
               rows, reinterpret_cast<long long*>(base + l.sums),
               reinterpret_cast<int*>(base + l.cnt),
               reinterpret_cast<long long*>(base + l.stats), n_codes, lanes,
               B, n_steps, seed, gamma, limit, make_game(params)};
  return (int)(shared ? launch_packed<true>(a, device, smem, st)
                      : launch_packed<false>(a, device, smem, st));
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

// Every entry: device: the CUDA ordinal of every pointer and of the
// stream; in/out: host arrays of 6 device pointers to int32 [B]; geo: host
// array of 6 device pointers to int32 [B] (H, W, glo, ghi, q_int, row
// offset; multigrid entries only, else ignored); table: device float32
// [n_codes, 11] (packed) or [n_codes, 36] (unpacked); sums: device int64
// [n_codes, 25] and cnt: device int32 [n_codes, 25], both zeroed by the
// caller; stats: device int64 [4] (reward sum, goals, truncations, table
// values outside +-limit), zeroed by the caller; params: the game
// description (make_game), or for the multigrid entries {max_steps}.
#define GST_LEARNER_ENTRY(name, kPacked, kMulti)                            \
  int name(int device, void* const* in, void* const* out, void* const* geo, \
           const float* table, long long* sums, int* cnt, long long* stats, \
           const int32_t* params, int B, int n_steps, uint32_t seed,        \
           float gamma, float limit, int threads, void* stream) {           \
    return launch<kPacked, kMulti>(device, in, out, geo, table, sums, cnt,  \
                                   stats, params, B, n_steps, seed, gamma,  \
                                   limit, threads, stream);                 \
  }

// K5.  in: host array of 6 device pointers to int32 [B]; buf: one device
// allocation of gst_packed_chunk_layout's total bytes, which receives the
// int64 sums [n_codes, 25], the int64 stats [4], the int32 counts
// [n_codes, 25] (all three zeroed here), the 6 output planes and the
// prepared rows; table: device float32 [n_codes, 11]; lanes: lanes per
// block, a multiple of 32 in [32, 512] (any fits: gst_packed_smem_bytes).
int gst_packed_learner_chunk(int device, void* const* in, void* buf,
                             const float* table, const int32_t* params,
                             int n_codes, int B, int n_steps, uint32_t seed,
                             float gamma, float limit, int lanes,
                             void* stream) {
  return packed_chunk(device, in, buf, table, params, n_codes, B, n_steps,
                      seed, gamma, limit, lanes, stream);
}

// K5's byte offsets in buf (learner_codes.layout): sums, stats, cnt, the
// end of the zeroed span, the fields, the rows and the total.
void gst_packed_chunk_layout(int n_codes, int B, long long* out) {
  const ChunkLayout l = chunk_layout(n_codes, B);
  out[0] = l.sums; out[1] = l.stats; out[2] = l.cnt; out[3] = l.zero;
  out[4] = l.fields; out[5] = l.rows; out[6] = l.total;
}

// K5's dynamic shared memory per block (learner_codes.smem_bytes).
int gst_packed_smem_bytes(int lanes, int n_codes) {
  return packed_smem_bytes(lanes, shared_rows(n_codes) ? n_codes : 0);
}

// K5's pipeline: steps a tile, tiles in the ring, producer warps.
void gst_packed_shape(int32_t* out) {
  out[0] = kTile;
  out[1] = kRingStages;
  out[2] = kProducers;
}

GST_LEARNER_ENTRY(gst_multigrid_packed_learner_chunk, true, true)  // K6
GST_LEARNER_ENTRY(gst_learner_chunk, false, false)                 // K7
GST_LEARNER_ENTRY(gst_multigrid_learner_chunk, false, true)        // K7 mg

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
