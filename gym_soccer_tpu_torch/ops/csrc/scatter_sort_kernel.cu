// Scatter-add in lane order for Hopper (sm_90a): a design of kernel A1
// that was measured and not kept, one block with a stable radix sort by
// cell in shared memory (scatter_kernel.cu holds the kernel;
// ops/scatter_variants.py builds this one beside it and times both).
//
// It has no Pallas counterpart: the JAX package's HBM-table learners sum
// each step's TDs with XLA's scatter, `jnp.zeros_like(q).at[cells].add(td)`
// (gym_soccer_tpu/agents/learners.py:193-196, :343-344, :506-507), which
// XLA on the CPU adds in lane order, and the port's plain version
// (ops/scatter_kernel.py `scatter_add_plain`, `index_add_` on the CPU)
// adds in the same order.  `index_add_` on a CUDA tensor adds by float
// atomics in no fixed order, so its last bits change from run to run; A1
// gives the CPU's bits on the card.
//
// What it computes, for cells idx [B] in [0, n) and float32 values v [B]:
//   sums[c]   = ((0 + v[i0]) + v[i1]) + ...   over the lanes i0 < i1 < ...
//                                             with idx[i] == c
//   counts[c] = the number of those lanes, as a float32
// each addition one float32 round-to-nearest `__fadd_rn` (no FMA
// contraction, no reassociation).  Cells no lane hits stay as the
// wrapper's zero fill of [2, n] (this design needs one); a cell outside [0, n) is dropped, as XLA
// drops an out-of-range scatter.
//
// Design: one launch of one block, after the wrapper's zero fill, which
// takes the lanes in tiles of up to kMaxWarps * kWarpLanes = 8192, in
// lane order.  Each lane is one 64-bit item in shared memory, its cell
// (the key) in the high word and its value's bits in the low word; a cell
// outside [0, n) and the tile's lanes past the batch get the key n, which
// sorts last and is never added.  For each tile the block
//   1. orders the items by cell, stably, with an LSD radix sort in shared
//      memory, 8 bits of the key a pass (two passes for the 5x4 tables'
//      19025 cells, three for 11x7's 292,625): each warp owns 256 items
//      in lane order, 8 of 32; it counts their digits in its own column
//      of the digit counts, ranking each item among its warp's items of
//      the same digit with `__match_any_sync`; a block scan of the counts
//      in (digit, warp) order gives each warp's first place for each
//      digit, so each digit's items keep their lane order;
//   2. adds each cell's run: the thread whose 8 places hold the run's
//      first item adds the run's values in order, reading them from
//      shared memory 8 at a time with the next 8 loaded ahead, each
//      addition predicated on the item's key;
//   3. continues a run across tiles: a run starts from the sum and count
//      that earlier tiles left for its cell in `out` (this block wrote
//      them, before a barrier), so the additions keep lane order.
// The grid (one block), its threads and its shared memory depend only on
// the lanes and the cells, and nothing is read back to the host, so the
// learners' CUDA graphs capture the launch.
//
// What bounds it: the bytes are B * 12 + n * 8 (the cells and values read
// once, the sums and counts written once), far under a launch's floor at
// the learners' 8192 lanes.  The work is O(B): per tile one coalesced
// load of its lanes, a few hundred shared-memory instructions a warp a
// pass and the runs' additions.  A run is a chain of dependent additions,
// so the longest run bounds step 2: a cell that takes every lane of a
// tile costs 8192 additions at the adder's latency (4 cycles), and the
// tiles' runs of one cell follow each other.  One block uses one of the
// card's SMs; at the learners' sizes the launch and the barriers, not
// the bytes, set its time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 8;                  // items a thread, each pass
constexpr int kWarpLanes = 32 * kItems;    // items a warp: 256
constexpr int kMaxWarps = 32;              // warps of the block at most
constexpr int kDigitBits = 8;              // key bits a pass
constexpr int kDigits = 1 << kDigitBits;
constexpr int kHistStride = kDigits + 1;   // a warp's column, padded
constexpr int kPad = 2 * kItems;           // key-n items after a tile
constexpr int64_t kMaxCells = int64_t(1) << 31;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;   // above every key
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned key_of(uint64_t x) {
  return (unsigned)(x >> 32);
}

__device__ __forceinline__ float value_of(uint64_t x) {
  return __uint_as_float((unsigned)x);
}

// The digit counts `hist` (warp w's count of digit d at w * kHistStride +
// d) replaced by their exclusive prefix sums in (digit, warp) order: the
// place of warp w's first item of digit d.  Thread t takes the 8 entries
// t * 8 .. t * 8 + 7 of that order.  Called by the whole block between
// barriers; `wsum` holds 32 words.
__device__ void scan_counts(unsigned* hist, unsigned* wsum, int log_warps) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int warps = 1 << log_warps;
  unsigned before[kItems], sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int at = t * kItems + k;
    before[k] = sum;
    sum += hist[(at & (warps - 1)) * kHistStride + (at >> log_warps)];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const unsigned x = lane < warps ? wsum[lane] : 0u;
    unsigned s = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < warps) wsum[lane] = s - x;
  }
  __syncthreads();
  const unsigned first = wsum[w] + incl - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int at = t * kItems + k;
    hist[(at & (warps - 1)) * kHistStride + (at >> log_warps)] =
        first + before[k];
  }
}

// Items p .. p + 7 of a tile's buffer (p a multiple of 8): four 16-byte
// shared-memory loads.
__device__ __forceinline__ void load_items(uint64_t* x, const uint64_t* p) {
  const ulonglong2* q = reinterpret_cast<const ulonglong2*>(p);
#pragma unroll
  for (int j = 0; j < kItems / 2; ++j) {
    const ulonglong2 u = q[j];
    x[2 * j] = u.x;
    x[2 * j + 1] = u.y;
  }
}

// A run's sum and count: its cell's, after the earlier tiles' `had`.
__device__ __forceinline__ void store_run(float* sums, float* counts,
                                          unsigned c, float acc, float had,
                                          int len) {
  sums[c] = acc;
  counts[c] = __fadd_rn(had, (float)len);
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
sort_add_kernel(const int64_t* __restrict__ idx, const float* __restrict__ v,
                int lanes, unsigned n_cells, int passes, int log_warps,
                float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ __align__(16) uint64_t smem[];
  const int tile = kWarpLanes << log_warps;
  uint64_t* const buf0 = smem;
  uint64_t* const buf1 = smem + tile + kPad;
  unsigned* const hist = reinterpret_cast<unsigned*>(buf1 + tile + kPad);
  unsigned* const wsum = hist + (kHistStride << log_warps);
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  const uint64_t none = (uint64_t)n_cells << 32;   // key n: never added
  unsigned* const col = hist + w * kHistStride;    // this warp's counts
  if (t < kPad) {
    buf0[tile + t] = none;
    buf1[tile + t] = none;
  }

  for (int base = 0; base < lanes; base += tile) {
    uint64_t item[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int i = base + w * kWarpLanes + r * 32 + lane;
      uint64_t x = none;
      if (i < lanes) {
        const int64_t c = idx[i];
        const unsigned key =
            c >= 0 && c < (int64_t)n_cells ? (unsigned)c : n_cells;
        x = (uint64_t)key << 32 | __float_as_uint(v[i]);
      }
      item[r] = x;
    }
    uint64_t* src = buf1;
    uint64_t* dst = buf0;
    for (int pass = 0; pass < passes; ++pass) {
      if (pass > 0) {
#pragma unroll
        for (int r = 0; r < kItems; ++r)
          item[r] = src[w * kWarpLanes + r * 32 + lane];
      }
      const int shift = 32 + kDigitBits * pass;
#pragma unroll
      for (int k = 0; k < kDigits / 32; ++k) col[lane + 32 * k] = 0u;
      __syncwarp();
      unsigned peers[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {   // in lane order
        const unsigned d = (unsigned)(item[r] >> shift) & (kDigits - 1);
        peers[r] = __match_any_sync(kFull, d);
        if ((peers[r] & below) == 0u) col[d] += __popc(peers[r]);
        __syncwarp();
      }
      __syncthreads();
      scan_counts(hist, wsum, log_warps);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kItems; ++r) {   // in lane order
        const unsigned d = (unsigned)(item[r] >> shift) & (kDigits - 1);
        const unsigned at = col[d];
        dst[at + __popc(peers[r] & below)] = item[r];
        __syncwarp();
        if ((peers[r] & below) == 0u) col[d] = at + __popc(peers[r]);
        __syncwarp();
      }
      __syncthreads();
      uint64_t* const sorted = dst;
      dst = src;
      src = sorted;
    }

    // 2. Each thread adds the runs whose first item lies in its 8 places,
    // from its registers, and the last of them on past its places.  An
    // item of another cell adds -0.0, which leaves every sum as it is, so
    // the chain of additions has no select in it.
    const int p0 = t * kItems;
    uint64_t x[kItems];
    load_items(x, src + p0);
    unsigned prev = p0 == 0 ? kNoKey : key_of(src[p0 - 1]);
    bool own = false;   // adding a run whose first item is here
    unsigned c = 0u;
    float acc = 0.0f, had = 0.0f;
    int len = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned key = key_of(x[k]);
      if (key != prev) {   // a run's first item
        if (own) store_run(sums, counts, c, acc, had, len);
        own = key != n_cells;
        c = key;
        acc = had = 0.0f;
        len = 0;
        if (own && base > 0) {   // the earlier tiles' sum and count
          acc = sums[c];
          had = counts[c];
        }
      }
      acc = __fadd_rn(acc, own ? value_of(x[k]) : -0.0f);
      len += own;
      prev = key;
    }
    if (own) {   // the run goes on: 8 items at a time, the next 8 loaded
      int q = p0 + kItems;
      uint64_t y[kItems], z[kItems];
      load_items(y, src + q);
      for (;;) {
        load_items(z, src + q + kItems);
        unsigned match = 0u;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const bool mine = key_of(y[j]) == c;
          match |= (unsigned)mine << j;
          acc = __fadd_rn(acc, mine ? value_of(y[j]) : -0.0f);
        }
        len += __popc(match);
        if (match != (1u << kItems) - 1u) break;
        q += kItems;
#pragma unroll
        for (int j = 0; j < kItems; ++j) y[j] = z[j];
      }
      store_run(sums, counts, c, acc, had, len);
    }
    __syncthreads();   // the tile's runs written before the next reads
  }
}

struct Shape {
  int threads, tile, smem, passes, log_warps;
};

Shape shape_of(int lanes, int64_t n_cells) {
  Shape s;
  const int want = lanes < kMaxWarps * kWarpLanes ? lanes
                                                   : kMaxWarps * kWarpLanes;
  s.log_warps = 0;
  while ((kWarpLanes << s.log_warps) < want) ++s.log_warps;
  s.threads = 32 << s.log_warps;
  s.tile = kWarpLanes << s.log_warps;
  s.smem = (int)(2 * (s.tile + kPad) * sizeof(uint64_t) +
                 ((kHistStride << s.log_warps) + 32) * sizeof(unsigned));
  int bits = 0;   // of the largest key, n
  while (bits < 32 && (n_cells >> bits) != 0) ++bits;
  s.passes = bits > kDigitBits ? (bits + kDigitBits - 1) / kDigitBits : 1;
  return s;
}

}  // namespace

extern "C" {

// A1.  idx: device int64 [lanes]; v: device float32 [lanes]; out: device
// float32 [2, n_cells], zero-filled: the sums, then the counts.  All
// contiguous; lanes < 2**24, n_cells < 2**31.  Launches on `stream` and
// returns its cudaError_t (0 on success); no lanes or no cells launch
// nothing.
int gst_scatter_add(int device, const int64_t* idx, const float* v,
                    int lanes, int64_t n_cells, float* out, void* stream) {
  if (lanes < 0 || lanes >= (1 << 24) || n_cells < 0 ||
      n_cells >= kMaxCells)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0 || n_cells == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape sh = shape_of(lanes, n_cells);
  static int allowed[kMaxDevices] = {};
  if (device >= kMaxDevices || sh.smem > allowed[device]) {
    e = cudaFuncSetAttribute(sort_add_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sh.smem);
    if (e != cudaSuccess) return (int)e;
    if (device < kMaxDevices) allowed[device] = sh.smem;
  }
  sort_add_kernel<<<1, sh.threads, sh.smem,
                    static_cast<cudaStream_t>(stream)>>>(
      idx, v, lanes, (unsigned)n_cells, sh.passes, sh.log_warps, out,
      out + n_cells);
  return (int)cudaGetLastError();
}

// The launch's shape at `lanes` and `n_cells`, for chip_smoke.py's design
// line: threads of its block, lanes a tile, bytes of shared memory, radix
// passes a tile.
void gst_scatter_shape(int lanes, int64_t n_cells, int* shape) {
  const Shape sh = shape_of(lanes, n_cells);
  shape[0] = sh.threads;
  shape[1] = sh.tile;
  shape[2] = sh.smem;
  shape[3] = sh.passes;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
