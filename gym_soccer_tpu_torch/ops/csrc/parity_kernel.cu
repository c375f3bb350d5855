// Bit-exact reference-parity kernels for Hopper (sm_90a): K12 and K13.
//
// Replaces the Pallas TPU kernel `_parity_kernel`
// (gym_soccer_tpu/ops/parity_kernel.py:196), called closed loop by
// `parity_events` (:578) and scripted by `parity_scripted_events` (:678).
// One kernel, templated on kScripted.
//
// What it computes, for every lane (one reference env with its own
// MT19937 generator seeded RandomState(seed)) and every EVENT: one
// random_sample double u from the lane's generator; if the lane needs a
// reset, the ISD categorical of u (reference reset(), :410-424), else the
// transition categorical of u for the joint row the lane plays (step(),
// :394-396): the first float64 cumulative-sum threshold above u, or, when
// u passes them all, the first in-list slot (the reference's argmax over
// an all-False array; the TPU kernel clamps to slot 35 there instead).
// The closed-loop row is jr[raw state]; the scripted row is
// rows[steps, lane], 0 past the script's end, where steps counts the
// lane's transitions (a reset spends a draw but no script row).  Each
// event stores one journal word,
//   raw | done << 15 | trunc << 16 | was_reset << 17 | (reward + 1) << 18,
// and the lane's final state goes to eight int32 [B] planes.
//
// Every lane consumes one draw per event, so all generators stay at the
// same position and twist at the same event (every 312).  Each thread owns
// its lane's 624-word state in a [624, B] scratch array (a warp's loads
// coalesce; 20 MB at 8192 lanes stays in the 50 MB L2), seeds it
// (init_genrand) and twists it with the reference's sequential in-place
// loop.  The double is formed in float64, exactly as numpy does, and the
// thresholds are compared in float64: the TPU's integer IEEE-754 assembly
// and 16-bit limb compares are not needed on a card with f64.
//
// Thresholds by class: the cumulative row of a (state, joint row) is fixed
// by its 9-combo outcome-count pattern (ops/parity_kernel.py's build_pk
// verifies it), ~70 classes on 5x4 and 11x7.  The kernel computes the
// base-3 pattern code with the collision chain of core/rules.py (combos of
// zero probability left out), maps it to its class through a 3**9-entry
// lookup table, scans the class's 36 thresholds from shared memory, and
// recomputes the sampled outcome from the chosen combo's flags.  No
// per-state table is read, which at 11x7 would be 84 MB of thresholds.
//
// What bounds it on this card: per event about 25 integer operations of
// tempering, the 9-combo collision chain twice over (~300 integer
// operations), 36 float64 compares from shared memory, and 3 dependent
// loads (the two MT words, the row, the class id) from L1/L2; a twist
// every 312 events adds 624 loads and stores per lane.  At 8192 lanes
// there are 64 blocks of 128 threads on 132 SMs, so the dependent loads'
// latency is exposed: latency-bound, as K1 is; at more lanes the chain's
// instruction issue bounds it.  What the design does about it: one thread
// per lane, state in registers, a loop over the events with nothing but
// the journal word leaving the SM between twists, the journal store of
// event k at journal[k * B + lane], coalesced.  Shared memory for the MT
// states (64 lanes x 2,496 B = 160 KB a block) is the later alternative to
// the L2-resident scratch.

#include "game.cuh"

using namespace gst;

namespace {

constexpr int kSlots = 36;        // 9 combos x 4 outcome slots
constexpr int kMtN = 624;
constexpr int kMtM = 397;
constexpr int kTwistDoubles = kMtN / 2;
constexpr uint32_t kMatrixA = 0x9908B0DFu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7FFFFFFFu;
// Movement variant (0 intended, 1 and 2 the orthogonal slips) of each
// slip combo for A and for B, 2 bits per combo (config.COMBO_VARIANT_A/B:
// A 0,0,0,1,2,1,1,2,2 and B 0,1,2,0,0,1,2,1,2).
constexpr uint32_t kVariantA = (1u << 6) | (2u << 8) | (1u << 10) |
                               (1u << 12) | (2u << 14) | (2u << 16);
constexpr uint32_t kVariantB = (1u << 2) | (2u << 4) | (1u << 10) |
                               (2u << 12) | (1u << 14) | (2u << 16);

struct ParityArgs {
  const int32_t* seeds;       // [B] (uint32 bits)
  uint32_t* mt;               // [624, B] scratch
  const int32_t* rows;        // closed loop: jr [n_raw]; scripted: [T, B]
  int script_rows;            // T (scripted only)
  const double* cls_cum;      // [n_classes, 36]
  int n_classes;
  const int16_t* code_class;  // [3**9]
  int32_t* journal;           // [n_events, B]
  int32_t* out[8];            // ra, ca, rb, cb, p, t, needs_reset, steps
  int B, n_events;
  int combo_mask;             // bit c set iff combo c has probability > 0
  double isd_cum[kMaxIsd];
  Game g;
};

struct Lane {
  int ra, ca, rb, cb, p;
};

// One slip combo's moves and collision case (core/rules.resolve_outcomes).
struct Combo {
  int nxa, nya, nxb, nyb;
  bool c2, c4, c5, c13;
};

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9D2C5680u;
  y ^= (y << 15) & 0xEFC60000u;
  return y ^ (y >> 18);
}

// The reference's in-place twist of one lane's generator (genrand).
__device__ __forceinline__ void twist(uint32_t* mt, int lane, int B) {
  const size_t stride = (size_t)B;
  uint32_t* w = mt + lane;
  uint32_t cur = w[0];
  for (int k = 0; k < kMtN - 1; ++k) {
    const uint32_t nxt = w[(size_t)(k + 1) * stride];
    const uint32_t y = (cur & kUpper) | (nxt & kLower);
    // k + M < N reads an old word; beyond, the already-updated k + M - N
    const int src = k < kMtN - kMtM ? k + kMtM : k + kMtM - kMtN;
    w[(size_t)k * stride] =
        w[(size_t)src * stride] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
    cur = nxt;
  }
  const uint32_t y = (cur & kUpper) | (w[0] & kLower);
  w[(size_t)(kMtN - 1) * stride] = w[(size_t)(kMtM - 1) * stride] ^
                                   (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
}

__device__ __forceinline__ bool is_goal_state(const Lane& s, const Game& g) {
  const bool ga = s.p == 0 && in_goal_rows(s.ra, g) &&
                  (s.ca == 0 || s.ca == g.W - 1);
  const bool gb = s.p == 1 && in_goal_rows(s.rb, g) &&
                  (s.cb == 0 || s.cb == g.W - 1);
  return ga || gb;
}

__device__ __forceinline__ void variant(int mc0, int mr0, int v, int& mc,
                                        int& mr) {
  mc = v == 0 ? mc0 : (v == 1 ? -mr0 : mr0);
  mr = v == 0 ? mr0 : (v == 1 ? mc0 : -mc0);
}

__device__ __forceinline__ Combo eval_combo(int c, const Lane& s, int aa,
                                            int ab, const Game& g) {
  int mca, mra, mcb, mrb;
  variant((aa == 3) - (aa == 4), (aa == 2) - (aa == 1),
          (kVariantA >> (2 * c)) & 3, mca, mra);
  variant((ab == 3) - (ab == 4), (ab == 2) - (ab == 1),
          (kVariantB >> (2 * c)) & 3, mcb, mrb);
  Combo k;
  next_cell(s.ra, s.ca, mca, mra, s.p == 0, g, k.nxa, k.nya);
  next_cell(s.rb, s.cb, mcb, mrb, s.p == 1, g, k.nxb, k.nyb);
  const int ra = s.ra, ca = s.ca, rb = s.rb, cb = s.cb;
  const bool c1 =
      (ra == rb && abs(ca - cb) == 1 && k.nya == cb && k.nyb == ca) ||
      (ca == cb && abs(ra - rb) == 1 && k.nxa == rb && k.nxb == ra);
  k.c2 = !c1 && ((k.nxa == rb && k.nya == cb && ab == 0) ||
                 (k.nxb == ra && k.nyb == ca && aa == 0));
  const bool c3 =
      !c1 && !k.c2 &&
      ((ra == k.nxa && ca == k.nya && aa != 0 && k.nxb == ra &&
        k.nyb == ca) ||
       (rb == k.nxb && cb == k.nyb && ab != 0 && k.nxa == rb &&
        k.nya == cb));
  k.c4 = !c1 && !k.c2 && !c3 && k.nxa == k.nxb && k.nya == k.nyb;
  k.c5 = !(c1 || k.c2 || c3 || k.c4);
  k.c13 = c1 || c3;
  return k;
}

template <bool kScripted>
__device__ __forceinline__ void run_lane(const ParityArgs& a,
                                         const double* cls_cum, int lane) {
  const Game& g = a.g;
  const size_t B = (size_t)a.B;
  uint32_t* mt = a.mt;

  // seed: init_genrand, numpy's legacy RandomState(seed)
  uint32_t x = (uint32_t)a.seeds[lane];
  mt[lane] = x;
  for (int i = 1; i < kMtN; ++i) {
    x = 1812433253u * (x ^ (x >> 30)) + (uint32_t)i;
    mt[(size_t)i * B + lane] = x;
  }

  Lane s{0, 0, 0, 0, 0};
  int t = 0, nr = 1, steps = 0;
  for (int k = 0; k < a.n_events; ++k) {
    const int cursor = k % kTwistDoubles;
    if (cursor == 0) twist(mt, lane, a.B);
    // numpy random_sample: ((w0 >> 5) * 2^26 + (w1 >> 6)) / 2^53, exact
    const uint32_t w0 = temper(mt[(size_t)(2 * cursor) * B + lane]);
    const uint32_t w1 = temper(mt[(size_t)(2 * cursor + 1) * B + lane]);
    const double u = __dmul_rn(
        __dadd_rn(__dmul_rn((double)(w0 >> 5), 67108864.0),
                  (double)(w1 >> 6)),
        0x1p-53);

    // ---- transition interpretation of the draw ----
    int row;
    if constexpr (kScripted) {
      row = steps < a.script_rows ? a.rows[(size_t)steps * B + lane] : 0;
    } else {
      const int raw = (((s.ra * g.W + s.ca) * g.H + s.rb) * g.W + s.cb) * 2 +
                      s.p;
      row = __ldg(a.rows + raw);
    }
    const int aa = row / 5, ab = row - (row / 5) * 5;

    int code = 0, pow3 = 1;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const Combo kc = eval_combo(c, s, aa, ab, g);
      if ((a.combo_mask >> c) & 1) code += ((int)kc.c13 + 2 * kc.c4) * pow3;
      pow3 *= 3;
    }
    const bool absorbed = is_goal_state(s, g);
    if (absorbed) code = 0;
    const double* cum = cls_cum + kSlots * (int)__ldg(a.code_class + code);
    int i_sel = 0, n_zero = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const double cj = cum[j];
      i_sel += cj <= u;
      n_zero += cj == 0.0;
    }
    if (i_sel >= kSlots) i_sel = min(n_zero, kSlots - 1);

    // the sampled outcome: combo i_sel / 4, slot i_sel % 4, in the
    // reference's outcome order (core/rules.resolve_outcomes slots 0-3)
    const Combo k2 = eval_combo(i_sel >> 2, s, aa, ab, g);
    const int o = i_sel & 3;
    const bool c45 = k2.c4 || k2.c5;
    Lane n;
    if (o == 0) {
      n.ra = k2.c5 ? k2.nxa : s.ra;
      n.ca = k2.c5 ? k2.nya : s.ca;
      n.rb = c45 ? k2.nxb : s.rb;
      n.cb = c45 ? k2.nyb : s.cb;
      n.p = k2.c2 ? 1 - s.p : (k2.c5 ? s.p : 0);
    } else if (o == 1) {
      n.ra = s.ra;
      n.ca = s.ca;
      n.rb = k2.c4 ? k2.nxb : s.rb;
      n.cb = k2.c4 ? k2.nyb : s.cb;
      n.p = 1;
    } else {
      n.ra = k2.nxa;
      n.ca = k2.nya;
      n.rb = s.rb;
      n.cb = s.cb;
      n.p = o == 2 ? 0 : 1;
    }
    if (absorbed) n = s;  // absorbing self-loop (reference :300-301)
    const bool done = is_goal_state(n, g);
    const int ball_col = n.p == 0 ? n.ca : n.cb;
    const int rwd = (done && !absorbed) ? (ball_col == g.W - 1 ? 1 : -1) : 0;
    const bool trunc = t + 1 >= g.max_steps;

    // ---- reset interpretation of the same draw (ISD categorical) ----
    int ii = 0;
    for (int e = 0; e < g.nI; ++e) ii += a.isd_cum[e] <= u;
    ii = min(ii, g.nI - 1);

    // ---- merge: reset lanes take the ISD state, the others transition --
    const bool reset = nr != 0;
    int done_j = 0, trunc_j = 0, rj = 0;
    if (reset) {
#pragma unroll
      for (int e = 0; e < kMaxIsd; ++e) {
        if (e == ii) {
          s.ra = g.isd[e][0]; s.ca = g.isd[e][1];
          s.rb = g.isd[e][2]; s.cb = g.isd[e][3];
          s.p = g.isd[e][4];
        }
      }
      t = 0;
    } else {
      s = n;
      t = t + 1;
      done_j = done;
      trunc_j = trunc;
      rj = rwd;
    }
    const int raw_new =
        (((s.ra * g.W + s.ca) * g.H + s.rb) * g.W + s.cb) * 2 + s.p;
    a.journal[(size_t)k * B + lane] = raw_new | (done_j << 15) |
                                      (trunc_j << 16) | (nr << 17) |
                                      ((rj + 1) << 18);
    steps += 1 - nr;
    nr = reset ? 0 : (done_j | trunc_j);
  }
  a.out[0][lane] = s.ra; a.out[1][lane] = s.ca;
  a.out[2][lane] = s.rb; a.out[3][lane] = s.cb;
  a.out[4][lane] = s.p;  a.out[5][lane] = t;
  a.out[6][lane] = nr;   a.out[7][lane] = steps;
}

template <bool kScripted>
__global__ void parity_kernel(ParityArgs a) {
  extern __shared__ double s_cum[];
  for (int i = threadIdx.x; i < a.n_classes * kSlots; i += blockDim.x)
    s_cum[i] = a.cls_cum[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.B) run_lane<kScripted>(a, s_cum, lane);
}

template <bool kScripted>
int launch(int device, ParityArgs a, int threads, cudaStream_t st) {
  if (a.B <= 0 || a.n_events < 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || a.g.nI < 1 || a.g.nI > kMaxIsd ||
      a.n_classes < 1 || a.n_classes > 512 || a.script_rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int smem = a.n_classes * kSlots * (int)sizeof(double);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(parity_kernel<kScripted>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.B + threads - 1) / threads;
  parity_kernel<kScripted><<<blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K12 (scripted == 0) and K13 (scripted == 1).  device: the CUDA ordinal
// of every pointer and of the stream.  seeds: device int32 [B] (uint32
// bits); mt: device scratch [624, B]; rows: device int32, jr [n_raw]
// closed loop or the script [script_rows, B]; cls_cum: device float64
// [n_classes, 36]; code_class: device int16 [3**9]; params: host int32
// game description (make_game); isd_cum: host float64 [nI]; journal:
// device int32 [n_events, B]; out: host array of 8 device pointers to
// int32 [B].
int gst_parity_events(int device, int scripted, const int32_t* seeds,
                      uint32_t* mt, const int32_t* rows, int script_rows,
                      const double* cls_cum, int n_classes,
                      const int16_t* code_class, const int32_t* params,
                      const double* isd_cum, int combo_mask,
                      int32_t* journal, void* const* out, int B,
                      int n_events, int threads, void* stream) {
  ParityArgs a{};
  a.seeds = seeds;
  a.mt = mt;
  a.rows = rows;
  a.script_rows = script_rows;
  a.cls_cum = cls_cum;
  a.n_classes = n_classes;
  a.code_class = code_class;
  a.journal = journal;
  for (int i = 0; i < 8; ++i) a.out[i] = static_cast<int32_t*>(out[i]);
  a.B = B;
  a.n_events = n_events;
  a.combo_mask = combo_mask;
  a.g = make_game(params);
  for (int e = 0; e < a.g.nI && e < kMaxIsd; ++e) a.isd_cum[e] = isd_cum[e];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scripted ? launch<true>(device, a, threads, st)
                  : launch<false>(device, a, threads, st);
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
