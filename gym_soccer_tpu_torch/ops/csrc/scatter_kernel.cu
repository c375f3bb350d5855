// Scatter-add in lane order for Hopper (sm_90a): kernel A1.
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
// contraction, no reassociation).  A cell no lane hits gets 0 and 0; a
// cell outside [0, n) is dropped, as XLA drops an out-of-range scatter.
//
// Design: one launch, no zero fill.  The cells are cut into ranges of
// `cells` (a multiple of 32, so that the ranges spread over about as many
// blocks as the card has SMs), one range a block, one cell a thread.  Each
// block reads every lane's cell, in tiles of up to 8192 lanes in lane
// order: each warp takes 256 lanes, 32 at a time, and a ballot marks the
// lanes whose cell is in the block's range (their values are read from
// device memory only there).  Then, as the tile's kept lanes are few or
// many (kFewLanes):
//   few (the learners' steps): the kept lanes are listed in lane order,
//     each warp's after the warps before it, each lane after its ballot's
//     lanes before it, as 64-bit items (the cell's index in the range
//     high, the value's bits low); every thread reads the whole list, one
//     broadcast load an item, and adds the items of its own cell;
//   many (a hot cell takes a tile): the kept lanes are ordered by cell,
//     stably, with one counting-sort pass in shared memory: ballots on
//     the bits of each kept lane's cell give it its peers of the same
//     cell in its 32, and their leader adds their number to the warp's
//     count for that cell; a block scan of the counts in (cell, warp)
//     order gives each warp its first place for each cell, and each kept
//     lane its place by its peers before it, so each cell's run keeps
//     lane order; each thread adds its cell's run, eight values at a time,
//     the next eight loaded before the additions (-0.0 past the last,
//     which leaves the sum as it is).
// Each cell's sum and count stay in its thread's registers from one tile
// to the next, so the additions keep lane order.  At the end each block
// writes its range of sums and counts, every cell (0 where no lane hit
// it), with neighbouring threads on neighbouring cells.  The grid, the
// block and the shared memory depend only on the lanes and the cells, and
// nothing is read back to the host, so the learners' CUDA graphs capture
// the launch.
//
// What bounds it: the bytes are B * 12 + n * 8 (the cells and values read
// once, the sums and counts written once), far under a launch's floor at
// the learners' 8192 lanes; each block rereads the B cells from L2 (B * 8
// bytes a block, ~7.8 MB at 8192 lanes over the 5x4 tables' 119 blocks).
// The additions of one cell are a chain: a cell that takes most of the
// lanes costs its lanes' additions one after another in one thread, tile
// after tile, at a dependent addition's latency.  At the learners' sizes
// the launch, the block's barriers and its loads from L2 set the time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 8;                  // lanes a thread, each tile
constexpr int kWarpLanes = 32 * kItems;    // lanes a warp: 256
constexpr int kMaxWarps = 32;              // warps of a block at most
constexpr int kBlocks = 132;               // the card's SMs: blocks aimed at
constexpr int kCellBits = 10;             // bits of a cell's index, at most
// A tile whose kept lanes times the block's cells fall below kFewLanes
// (and whose kept lanes fit the tile's words as 8-byte items) is listed in
// lane order and each thread picks its cell's items from the list; else
// it is ordered by cell.
constexpr uint64_t kFewLanes = uint64_t(1) << 18;
constexpr int64_t kMaxCells = int64_t(1) << 31;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// An exclusive prefix sum over the block of `val`, one value a thread in
// thread order; `wsum` holds 33 words, the last the block's total.  Called
// by the whole block.
__device__ __forceinline__ unsigned block_scan(unsigned val, unsigned* wsum,
                                               int warps, int w, int lane) {
  unsigned incl = val;
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
    if (lane == 31) wsum[32] = s;
  }
  __syncthreads();
  return wsum[w] + incl - val;
}

// The `len` values run[0 .. len) of one cell added to `acc` in order:
// eight at a time, the next eight loaded before the additions; the last
// eight or fewer with -0.0 past the end, which leaves the sum as it is.
__device__ __forceinline__ void add_run(const float* run, unsigned len,
                                        float& acc) {
  float a[8], b[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) a[u] = (unsigned)u < len ? run[u] : -0.0f;
  unsigned j = 0;
  for (; j + 16 <= len; j += 8) {   // the next eight are all in the run
#pragma unroll
    for (int u = 0; u < 8; ++u) b[u] = run[j + 8 + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, a[u]);
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = b[u];
  }
  for (; j < len; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned at = j + 8 + u;
      b[u] = at < len ? run[at] : -0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, a[u]);
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = b[u];
  }
}

// The values of the items of cell `mine` among `list[0 .. K)` (kept lanes
// in lane order, cell index high, value bits low) added to `acc` in
// order, their number to `cnt`: every thread of a warp reads each item
// (one broadcast load), eight loaded ahead, and only the cell's thread
// adds it.
__device__ __forceinline__ void add_picked(const uint64_t* list, unsigned K,
                                           unsigned mine, float& acc,
                                           int& cnt) {
  unsigned j = 0;
  for (; j + 8 <= K; j += 8) {
    uint64_t y[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) y[u] = list[j + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if ((unsigned)(y[u] >> 32) == mine) {
        acc = __fadd_rn(acc, __uint_as_float((unsigned)y[u]));
        ++cnt;
      }
    }
  }
  for (; j < K; ++j) {
    const uint64_t y = list[j];
    if ((unsigned)(y >> 32) == mine) {
      acc = __fadd_rn(acc, __uint_as_float((unsigned)y));
      ++cnt;
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
partition_add_kernel(const int64_t* __restrict__ idx,
                     const float* __restrict__ v, int lanes,
                     int64_t n_cells, int cells, int cell_bits,
                     int log_warps, float* __restrict__ sums,
                     float* __restrict__ counts) {
  // [tile] values in cell order; the count of each (cell, warp) pair, a
  // row of warps + 1 words a cell; 33 words of the block scan; the cells'
  // cells + 1 run starts
  extern __shared__ __align__(16) float sorted[];
  const int warps = 1 << log_warps;   // blockDim.x / 32
  const int tile = warps * kWarpLanes;
  const int stride = warps + 1;
  unsigned* const tab = reinterpret_cast<unsigned*>(sorted + tile);
  unsigned* const wsum = tab + cells * stride;
  unsigned* const start = wsum + 33;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  const int64_t lo = (int64_t)blockIdx.x * cells;
  const int64_t hi = lo + cells < n_cells ? lo + cells : n_cells;
  const int each = cells / 32;   // (cell, warp) pairs a thread scans
  float acc = 0.0f;
  int cnt = 0;

  for (int base = 0; base < lanes; base += tile) {
    unsigned key[kItems], kept[kItems];
    float x[kItems];
    unsigned mine = 0u;   // this warp's kept lanes
#pragma unroll
    for (int r = 0; r < kItems; ++r) {   // all the loads in flight at once
      const int i = base + w * kWarpLanes + r * 32 + lane;
      const int64_t c = i < lanes ? idx[i] : -1;
      const bool in = c >= lo && c < hi;
      key[r] = in ? (unsigned)(c - lo) : 0u;
      x[r] = in ? v[i] : 0.0f;
      kept[r] = __ballot_sync(kFull, in);
      mine += __popc(kept[r]);
    }
    // the warps' kept lanes, in the run starts' words: the dense path
    // below writes those only after a barrier that follows these reads
    if (lane == 0) start[w] = mine;
    __syncthreads();
    const unsigned some = lane < warps ? start[lane] : 0u;
    unsigned place = __reduce_add_sync(kFull, lane < w ? some : 0u);
    const unsigned K = __reduce_add_sync(kFull, some);
    if ((uint64_t)K * cells < kFewLanes && 2 * K <= (unsigned)tile) {
      // Few kept lanes: listed in lane order, each thread picks its cell's.
      uint64_t* const list = reinterpret_cast<uint64_t*>(sorted);
#pragma unroll
      for (int r = 0; r < kItems; ++r) {   // in lane order
        if ((kept[r] >> lane) & 1u)
          list[place + __popc(kept[r] & below)] =
              (uint64_t)key[r] << 32 | __float_as_uint(x[r]);
        place += __popc(kept[r]);
      }
      __syncthreads();
      if (t < cells) add_picked(list, K, (unsigned)t, acc, cnt);
      __syncthreads();   // the list read before the next tile's is written
      continue;
    }
    // Many: ordered by cell, one run a cell.
    for (int c = lane; c < cells; c += 32) tab[c * stride + w] = 0u;
    __syncwarp();
    unsigned peers[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {   // in lane order
      const bool in = (kept[r] >> lane) & 1u;
      unsigned p = kept[r];
      if (p != 0u) {   // warp-uniform
#pragma unroll
        for (int b = 0; b < kCellBits; ++b) {   // the peers of one cell
          if (b < cell_bits) {
            const unsigned bit = __ballot_sync(kFull, (key[r] >> b) & 1u);
            p &= (key[r] >> b) & 1u ? bit : ~bit;
          }
        }
        if (in && (p & below) == 0u) tab[key[r] * stride + w] += __popc(p);
        __syncwarp();
      }
      peers[r] = p;
    }
    __syncthreads();
    // this thread's `each` pairs, in (cell, warp) order: their total, then
    // after the block's scan each pair's first place
    unsigned total = 0u;
    for (int e = 0; e < each; ++e) {
      const int at = t * each + e;
      total += tab[(at >> log_warps) * stride + (at & (warps - 1))];
    }
    place = block_scan(total, wsum, warps, w, lane);
    for (int e = 0; e < each; ++e) {
      const int at = t * each + e;
      unsigned* const count =
          tab + (at >> log_warps) * stride + (at & (warps - 1));
      const unsigned n = *count;
      *count = place;
      if ((at & (warps - 1)) == 0) start[at >> log_warps] = place;
      place += n;
    }
    if (t == 0) start[cells] = wsum[32];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r) {   // in lane order
      if (kept[r] == 0u) continue;       // warp-uniform
      const bool in = (kept[r] >> lane) & 1u;
      unsigned at = 0u;
      if (in) {
        at = tab[key[r] * stride + w];
        sorted[at + __popc(peers[r] & below)] = x[r];
      }
      __syncwarp();
      if (in && (peers[r] & below) == 0u)
        tab[key[r] * stride + w] = at + __popc(peers[r]);
      __syncwarp();
    }
    __syncthreads();
    if (t < cells) {
      const unsigned s0 = start[t], len = start[t + 1] - s0;
      add_run(sorted + s0, len, acc);
      cnt += len;
    }
    __syncthreads();   // the runs read before the next tile's are placed
  }
  if (t < cells && lo + t < hi) {
    sums[lo + t] = acc;
    counts[lo + t] = (float)cnt;
  }
}

struct Shape {
  int threads, tile, smem, blocks, cells, cell_bits, log_warps;
};

Shape shape_of(int lanes, int64_t n_cells) {
  Shape s;
  int64_t per = (n_cells + kBlocks - 1) / kBlocks;
  per = (per + 31) / 32 * 32;
  if (per < 32) per = 32;
  if (per > kMaxWarps * 32) per = kMaxWarps * 32;
  s.cells = (int)per;
  s.blocks = (int)((n_cells + per - 1) / per);
  s.cell_bits = 0;   // bits of a cell's index in the range
  while ((1 << s.cell_bits) < s.cells) ++s.cell_bits;
  const int want = lanes < kMaxWarps * kWarpLanes ? lanes
                                                   : kMaxWarps * kWarpLanes;
  s.log_warps = 0;   // a power of two of warps, for the lanes and cells
  while ((kWarpLanes << s.log_warps) < want ||
         (32 << s.log_warps) < s.cells)
    ++s.log_warps;
  const int warps = 1 << s.log_warps;
  s.threads = 32 * warps;
  s.tile = kWarpLanes * warps;
  s.smem = (int)((s.tile + s.cells * (warps + 1) + 33 + s.cells + 1) *
                 sizeof(unsigned));
  return s;
}

}  // namespace

extern "C" {

// A1.  idx: device int64 [lanes]; v: device float32 [lanes]; out: device
// float32 [2, n_cells], every word written: the sums, then the counts.
// All contiguous; lanes < 2**24, n_cells < 2**31.  Launches on `stream`
// and returns its cudaError_t (0 on success); no lanes or no cells launch
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
    e = cudaFuncSetAttribute(partition_add_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sh.smem);
    if (e != cudaSuccess) return (int)e;
    if (device < kMaxDevices) allowed[device] = sh.smem;
  }
  partition_add_kernel<<<sh.blocks, sh.threads, sh.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      idx, v, lanes, n_cells, sh.cells, sh.cell_bits, sh.log_warps, out,
      out + n_cells);
  return (int)cudaGetLastError();
}

// The launch's shape at `lanes` and `n_cells`, for chip_smoke.py's design
// line: threads of a block, lanes a tile, bytes of shared memory, blocks,
// cells a block, bits of a cell's index in its block's range.
void gst_scatter_shape(int lanes, int64_t n_cells, int* shape) {
  const Shape sh = shape_of(lanes, n_cells);
  shape[0] = sh.threads;
  shape[1] = sh.tile;
  shape[2] = sh.smem;
  shape[3] = sh.blocks;
  shape[4] = sh.cells;
  shape[5] = sh.cell_bits;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
