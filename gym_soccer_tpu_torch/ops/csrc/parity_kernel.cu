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
// The design: every transition is a table lookup.  A lane's state is one
// packed word (ops/parity_kernel.py's pack_word): raw | outcome << 15 |
// key << 17, the outcome the done flag and reward of the transition that
// led there.  The host builds, from core/tables, the threshold class and
// the packed next word of every (key, row, slot) (build_lookup): goal
// states take code 0's class and step to themselves, zero-probability
// combos are masked, so the event loop has no collision chain, no pattern
// code and no goal test.  Scripted (K13), the key is the state's table row
// and an event reads class[key, row], searches the class's thresholds, and
// reads the next word at the chosen slot: two dependent loads from L1/L2.
// Closed loop (K12), a prep kernel launched first (closed_prep_kernel,
// the twin of closed_tables) gathers the tables by jr into raw-indexed
// form, each next word keyed by the class of the state it names, so an
// event is the search and one load.  The search is two-level: which group
// of six slots (the groups' last thresholds), then which of the group's
// first five, 11 float64 compares in place of 36.  Each block keeps its
// lanes' MT19937 states in shared memory, [624][L] lane-inner (a warp's
// accesses hit 32 banks), seeded and twisted there in place by each lane's
// own thread, eight words at a time with their old values read first,
// beside the class rows (36 float64 thresholds and the fallback slot, an
// odd stride of doubles so that different classes spread over the banks)
// and the ISD words, which the host supplies (keyed by their table rows
// scripted; closed loop, the prep kernel keys them by class beside its
// next words).  Event k+1's draw, ISD pick and script row are made while
// event k's next-word load is in flight, and the reset merge is one
// indexed shared read.  Joint rows (jr, the script) arrive in [0, 25): the
// wrapper clamps them there, for the kernel and the plain versions alike.
//
// What bounds it: latency.  At 8192 lanes there are 128 blocks of 64
// lanes on 132 SMs, two warps a SM, so each lane's dependent chain per
// event (the threshold loads and compares, the next-word load from L2) is
// the kernel's time: K12 0.613 ms per 8192 x 1536 call on 5x4 (0.619 ms
// on 11x7) and K13 0.658 ms per 8192 x 768, about 8x and 16x the time of
// their SASS instructions at the issue rate.  The chain's parts are the
// search's two rounds of shared loads and compares, the next-word load
// from L2 (K12's 5x4 table is 226 KB, K13's 3.3 MB; L1 keeps little beside
// 177 KB of shared memory) and, every 312 events, the twist.  The design
// before this one computed the 9-combo collision chain ten times per event
// and kept the MT states in a [624, B] device scratch: K12 took 5.30 ms
// and K13 3.18 ms per call.  All times NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 36;        // 9 combos x 4 outcome slots
constexpr int kStride = 37;       // doubles per class row: 36, fallback
constexpr int kRows = 25;         // joint rows
constexpr int kMaxIsd = 4;
constexpr int kMaxClasses = 512;
constexpr int kSmemBudget = 232448;
constexpr int kMtN = 624;
constexpr int kMtM = 397;
constexpr int kTwistDoubles = kMtN / 2;
constexpr uint32_t kMatrixA = 0x9908B0DFu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7FFFFFFFu;

struct ParityArgs {
  const int32_t* seeds;       // [B] (uint32 bits)
  const int32_t* rows;        // closed loop: jr [n_raw]; scripted: [T, B]
  int script_rows;            // T (scripted only)
  const int16_t* cls;         // [n_keys * 25] class of (key, row)
  const int32_t* words;       // closed: [n_raw, 36] (prepared); scripted:
  //                             [n_keys * 25, 36] next words
  const double* cum;          // [n_classes, 37]
  int n_classes;
  const int32_t* isd_word;    // [nI] the ISD states' words
  double isd_cum[kMaxIsd];
  int nI;
  int H, W, max_steps;
  int32_t* journal;           // [n_events, B]
  int32_t* out[8];            // ra, ca, rb, cb, p, t, needs_reset, steps
  int B, n_events;
};

__host__ __device__ constexpr int smem_bytes(int lanes, int n_classes) {
  return n_classes * kStride * (int)sizeof(double) +
         lanes * kMtN * (int)sizeof(uint32_t) + kMaxIsd * (int)sizeof(int);
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9D2C5680u;
  y ^= (y << 15) & 0xEFC60000u;
  return y ^ (y >> 18);
}

__device__ __forceinline__ uint32_t mix(uint32_t cur, uint32_t nxt,
                                        uint32_t src) {
  const uint32_t y = (cur & kUpper) | (nxt & kLower);
  return src ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
}

// The reference's in-place twist of one lane's generator (genrand), on
// its column of the block's [624][L] state: words k < 227 read the old
// word k + 397, the later ones the already-updated word k - 227.
__device__ __forceinline__ void twist(uint32_t* w, int L) {
  // eight words at a time, their old successors and their sources read
  // before any is written (a source k - 227 was written at least eight
  // words earlier)
  constexpr int kC = 8;
  uint32_t cur = w[0];
  int k = 0;
  for (; k + kC <= kMtN - 1; k += kC) {
    uint32_t nxt[kC], src[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      nxt[i] = w[(k + i + 1) * L];
      const int j = k + i < kMtN - kMtM ? k + i + kMtM : k + i + kMtM - kMtN;
      src[i] = w[j * L];
    }
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      w[(k + i) * L] = mix(cur, nxt[i], src[i]);
      cur = nxt[i];
    }
  }
  for (; k < kMtN - 1; ++k) {  // 616..622, all past 227
    const uint32_t nxt = w[(k + 1) * L];
    w[k * L] = mix(cur, nxt, w[(k + kMtM - kMtN) * L]);
    cur = nxt;
  }
  w[(kMtN - 1) * L] = mix(cur, w[0], w[(kMtM - 1) * L]);
}

// numpy random_sample from words 2c, 2c + 1: ((w0 >> 5) * 2^26 +
// (w1 >> 6)) / 2^53, exact.
__device__ __forceinline__ double draw(const uint32_t* w, int L, int c) {
  const uint32_t w0 = temper(w[(2 * c) * L]);
  const uint32_t w1 = temper(w[(2 * c + 1) * L]);
  return __dmul_rn(__dadd_rn(__dmul_rn((double)(w0 >> 5), 67108864.0),
                             (double)(w1 >> 6)),
                   0x1p-53);
}

// The ISD entry the reset draw u selects, as its packed word.
__device__ __forceinline__ uint32_t isd_pick(const ParityArgs& a,
                                             const uint32_t* s_isd,
                                             double u) {
  int ii = 0;
#pragma unroll
  for (int e = 0; e < kMaxIsd; ++e) ii += (e < a.nI) & (a.isd_cum[e] <= u);
  return s_isd[min(ii, a.nI - 1)];
}

template <bool kScripted>
__device__ __forceinline__ int script_row(const ParityArgs& a, int steps,
                                          int lane) {
  if constexpr (kScripted) {
    if (steps >= a.script_rows) return 0;
    return __ldg(a.rows + (size_t)steps * a.B + lane);
  } else {
    return 0;
  }
}

// The closed loop's raw-indexed words (ops/parity_kernel.py's
// closed_tables): out[raw, j] is the word of (raw, jr[raw], slot j), and
// out[n_raw * 36 + e] ISD word e, each with its key (the table row of the
// state it names) replaced by that state's class under jr.
__global__ void closed_prep_kernel(const int32_t* jr,
                                   const int32_t* raw_to_key,
                                   const int16_t* cls, const int32_t* words,
                                   int n_raw, const int32_t* isd_word, int nI,
                                   int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = n_raw * kSlots;
  if (i >= n + nI) return;
  uint32_t w;
  if (i < n) {
    const int raw = i / kSlots;
    const int row = __ldg(raw_to_key + raw) * kRows + __ldg(jr + raw);
    w = (uint32_t)__ldg(words + (size_t)row * kSlots + (i - raw * kSlots));
  } else {
    w = (uint32_t)__ldg(isd_word + (i - n));
  }
  const int c = __ldg(cls + (int)(w >> 17) * kRows + __ldg(jr + (w & 0x7FFF)));
  out[i] = (int32_t)((w & 0x1FFFFu) | ((uint32_t)c << 17));
}

// The first of a class's 36 thresholds above u (the count of those at
// or below it: they are sorted), or its fallback slot when u passes all.
__device__ __forceinline__ int pick_slot(const double* cum, double u) {
  // which group of six holds it (the groups' last thresholds), then which
  // of the group's first five, without a branch
  int g = 0;
#pragma unroll
  for (int m = 0; m < 6; ++m) g += cum[6 * m + 5] <= u;
  const int h = min(g, 5);
  const double* c = cum + 6 * h;
  int i = 6 * h;
#pragma unroll
  for (int j = 0; j < 5; ++j) i += c[j] <= u;
  return g >= 6 ? (int)cum[kSlots] : i;
}

template <bool kScripted>
__device__ __forceinline__ void run_lane(const ParityArgs& a,
                                         const double* s_cum, uint32_t* w,
                                         int L, const uint32_t* s_isd,
                                         int lane) {
  const size_t B = (size_t)a.B;

  // seed: init_genrand, numpy's legacy RandomState(seed)
  uint32_t x = (uint32_t)a.seeds[lane];
  w[0] = x;
  for (int i = 1; i < kMtN; ++i) {
    x = 1812433253u * (x ^ (x >> 30)) + (uint32_t)i;
    w[i * L] = x;
  }

  uint32_t word = 0, isd_next = 0;
  int t = 0, nr = 1, steps = 0;
  // event 0's state-independent work
  double u_next = 0.0;
  int row_next = 0, cursor = 0;
  if (a.n_events > 0) {
    twist(w, L);
    u_next = draw(w, L, 0);
    isd_next = isd_pick(a, s_isd, u_next);
    row_next = script_row<kScripted>(a, 0, lane);
  }
  for (int k = 0; k < a.n_events; ++k) {
    const double u = u_next;
    const uint32_t isd_w = isd_next;
    const int row = row_next;
    if (++cursor == kTwistDoubles) {
      cursor = 0;
      if (k + 1 < a.n_events) twist(w, L);
    }

    // ---- the transition: class, thresholds, next word ----
    const int key = (int)(word >> 17);
    int cls, base;
    if constexpr (kScripted) {
      base = key * kRows + row;
      cls = __ldg(a.cls + base);
    } else {
      base = (int)(word & 0x7FFF);
      cls = key;
    }
    const double* cum = s_cum + cls * kStride;
    const int i_sel = pick_slot(cum, u);
    const uint32_t nxt =
        (uint32_t)__ldg(a.words + (size_t)base * kSlots + i_sel);

    // ---- event k + 1's draw, ISD pick and script row, under the load ----
    u_next = draw(w, L, cursor);
    isd_next = isd_pick(a, s_isd, u_next);
    row_next = script_row<kScripted>(a, steps + 1 - nr, lane);

    // ---- merge: reset lanes take the ISD word, the others transition ----
    const bool reset = nr != 0;
    word = reset ? isd_w : nxt;
    const int o = (int)(word >> 15) & 3;     // 0 for an ISD word
    const int done = o != 0;
    const int trunc = !reset && t + 1 >= a.max_steps;
    const int r1 = (0x91 >> (2 * o)) & 3;    // reward + 1 of outcome o
    a.journal[(size_t)k * B + lane] = (int)(word & 0x7FFF) | (done << 15) |
                                      (trunc << 16) | (nr << 17) |
                                      (r1 << 18);
    t = reset ? 0 : t + 1;
    steps += 1 - nr;
    nr = reset ? 0 : (done | trunc);
  }
  int raw = (int)(word & 0x7FFF);
  a.out[4][lane] = raw & 1;
  raw >>= 1;
  a.out[3][lane] = raw % a.W;
  raw /= a.W;
  a.out[2][lane] = raw % a.H;
  raw /= a.H;
  a.out[1][lane] = raw % a.W;
  a.out[0][lane] = raw / a.W;
  a.out[5][lane] = t;
  a.out[6][lane] = nr;
  a.out[7][lane] = steps;
}

template <bool kScripted>
__global__ void parity_kernel(ParityArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_cum = reinterpret_cast<double*>(smem);
  uint32_t* s_mt =
      reinterpret_cast<uint32_t*>(s_cum + a.n_classes * kStride);
  uint32_t* s_isd = s_mt + kMtN * blockDim.x;
  for (int i = threadIdx.x; i < a.n_classes * kStride; i += blockDim.x)
    s_cum[i] = a.cum[i];
  for (int i = threadIdx.x; i < a.nI; i += blockDim.x)
    s_isd[i] = (uint32_t)a.isd_word[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.B)
    run_lane<kScripted>(a, s_cum, s_mt + threadIdx.x, blockDim.x, s_isd,
                        lane);
}

template <bool kScripted>
int launch(int device, ParityArgs a, const int32_t* raw_to_key, int n_raw,
           int32_t* prepared, int threads, cudaStream_t st) {
  if (a.B <= 0 || a.n_events < 0 || threads <= 0 || threads > 1024 ||
      a.nI < 1 || a.nI > kMaxIsd || a.n_classes < 1 ||
      a.n_classes > kMaxClasses || a.script_rows < 0 || n_raw <= 0 ||
      n_raw > 1 << 15)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(threads, a.n_classes);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if constexpr (!kScripted) {
    const int n = n_raw * kSlots + a.nI;
    closed_prep_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        a.rows, raw_to_key, a.cls, a.words, n_raw, a.isd_word, a.nI,
        prepared);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    a.words = prepared;
    a.isd_word = prepared + n_raw * kSlots;
  }
  e = cudaFuncSetAttribute(parity_kernel<kScripted>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.B + threads - 1) / threads;
  parity_kernel<kScripted><<<blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K12 (scripted == 0) and K13 (scripted == 1).  device: the CUDA ordinal
// of every pointer and of the stream.  seeds: device int32 [B] (uint32
// bits); rows: device int32, jr [n_raw] closed loop or the script
// [script_rows, B]; raw_to_key: device int32 [n_raw]; cls: device int16
// [n_keys * 25]; words: device int32 [n_keys * 25, 36] next words; cum:
// device float64 [n_classes, 37]; isd_word: device int32 [nI], the ISD
// states' words keyed by their table rows; isd_cum: host float64 [nI];
// prepared: device int32 [n_raw * 36 + nI] scratch for the closed loop's
// raw-indexed and ISD words (closed_prep_kernel, launched first on the
// same stream); every joint row in rows must lie in [0, 25); journal:
// device int32 [n_events, B]; out: host array of 8 device pointers to
// int32 [B]; threads: lanes per block, whose shared memory
// (gst_parity_smem_bytes) must fit 232,448 bytes.
int gst_parity_events(int device, int scripted, const int32_t* seeds,
                      const int32_t* rows, int script_rows,
                      const int32_t* raw_to_key, const int16_t* cls,
                      const int32_t* words, int n_raw, const double* cum,
                      int n_classes, const int32_t* isd_word,
                      const double* isd_cum, int nI, int32_t* prepared,
                      int H, int W, int max_steps, int32_t* journal,
                      void* const* out, int B, int n_events, int threads,
                      void* stream) {
  ParityArgs a{};
  a.seeds = seeds;
  a.rows = rows;
  a.script_rows = script_rows;
  a.cls = cls;
  a.words = words;
  a.cum = cum;
  a.n_classes = n_classes;
  a.isd_word = isd_word;
  a.nI = nI;
  for (int e = 0; e < nI && e < kMaxIsd; ++e) a.isd_cum[e] = isd_cum[e];
  a.H = H;
  a.W = W;
  a.max_steps = max_steps;
  a.journal = journal;
  for (int i = 0; i < 8; ++i) a.out[i] = static_cast<int32_t*>(out[i]);
  a.B = B;
  a.n_events = n_events;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scripted ? launch<true>(device, a, raw_to_key, n_raw, prepared,
                                 threads, st)
                  : launch<false>(device, a, raw_to_key, n_raw, prepared,
                                  threads, st);
}

// Dynamic shared memory of a block of `lanes` lanes (ops/parity_kernel.py's
// smem_bytes).
int gst_parity_smem_bytes(int lanes, int n_classes) {
  return smem_bytes(lanes, n_classes);
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
