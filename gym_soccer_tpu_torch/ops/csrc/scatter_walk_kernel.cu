// Scatter-add in lane order for Hopper (sm_90a): kernel A1's previous
// design, a walk from each cell's first lane (scatter_kernel.cu holds the
// kernel; ops/scatter_variants.py builds this one beside it and times
// both).
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
// wrapper's zero fill; a cell outside [0, n) is dropped, as XLA drops an
// out-of-range scatter.
//
// Design, two launches after the wrapper's one zero fill of [3, n] words
// (the sums, the counts and each cell's head):
//   count_kernel, a thread a lane: the lanes of a warp that share a cell
//     (`__match_any_sync`) add their number to counts[c] by one float
//     atomic (adding whole numbers below 2**24 is exact, so the count does
//     not depend on the atomics' order) and their first lane to head[c]
//     by one integer atomicMax of B - i, so that B - head[c] is the
//     cell's first lane;
//   walk_kernel, a warp a lane: the warp of the first lane i of a cell
//     walks the lanes from i up, kTrips x 32 a step with coalesced loads
//     of idx and v (the next step's issued before this step's work), and
//     for each 32 that hold lanes of the cell (a ballot) stages their
//     values in shared memory, from which lane 0 adds the cell's in lane
//     order, until counts[c] values are added; the other warps return at
//     once.
// Nothing in the launch depends on the data's values on the host (no read
// back, no size from the data), so the learners' CUDA graphs capture it.
//
// What bounds it: the bytes are B * 12 + n * 8 (the cells and values read
// once, the sums and counts written once), far under a launch's floor at
// the learners' 8192 lanes.  The walk of a cell is a chain of dependent
// additions over the span from its first lane to its last, so the cell
// with the longest span (nearly the whole batch, once a few thousand
// cells hold two lanes or more) or the most lanes (at an engine's reset
// hundreds of lanes stand in one cell) bounds the second launch: a step
// of the span waits about one memory latency, and a 32 with lanes of the
// cell adds them one after another.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads a block, both kernels
constexpr int kWarps = kThreads / 32;    // lanes a block of walk_kernel
constexpr int kTrips = 4;                // 32s of lanes a step of a walk
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ idx, int lanes, int64_t n_cells,
             float* __restrict__ counts, int* __restrict__ head) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int64_t c = i < lanes ? idx[i] : -1;
  const unsigned peers = __match_any_sync(kFull, (unsigned long long)c);
  const int lane = threadIdx.x & 31;
  if (c < 0 || c >= n_cells || __ffs(peers) - 1 != lane) return;
  atomicAdd(counts + c, (float)__popc(peers));
  atomicMax(head + c, lanes - i);   // this lane is its peers' first
}

__global__ void __launch_bounds__(kThreads)
walk_kernel(const int64_t* __restrict__ idx, const float* __restrict__ v,
            int lanes, int64_t n_cells, float* __restrict__ sums,
            const float* __restrict__ counts,
            const int* __restrict__ head) {
  __shared__ float4 staged[kWarps][8];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + w;
  if (i >= lanes) return;                 // warp-uniform
  const int64_t c = idx[i];
  if (c < 0 || c >= n_cells || lanes - head[c] != i) return;
  const int want = (int)counts[c];
  float* stage = reinterpret_cast<float*>(staged[w]);
  float acc = 0.0f;                       // lane 0's
  int found = 0;
  int64_t cj[kTrips];
  float vj[kTrips];
#pragma unroll
  for (int u = 0; u < kTrips; ++u) {
    const int j = i + 32 * u + lane;
    cj[u] = j < lanes ? idx[j] : -1;
    vj[u] = j < lanes ? v[j] : 0.0f;
  }
  for (int j0 = i;; j0 += 32 * kTrips) {
    const int jn = j0 + 32 * kTrips;      // the next step's loads, first
    int64_t cn[kTrips];
    float vn[kTrips];
#pragma unroll
    for (int u = 0; u < kTrips; ++u) {
      const int j = jn + 32 * u + lane;
      cn[u] = j < lanes ? idx[j] : -1;
      vn[u] = j < lanes ? v[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kTrips; ++u) {
      const unsigned mask = __ballot_sync(kFull, cj[u] == c);
      if (mask == 0u) continue;           // warp-uniform
      found += __popc(mask);
      stage[lane] = vj[u];
      __syncwarp();
      if (lane == 0) {                    // in lane order
        float x[32];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 f = staged[w][q];
          x[4 * q] = f.x;
          x[4 * q + 1] = f.y;
          x[4 * q + 2] = f.z;
          x[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if (mask >> k & 1u) acc = __fadd_rn(acc, x[k]);
      }
      __syncwarp();
    }
    if (found >= want || jn >= lanes) break;
#pragma unroll
    for (int u = 0; u < kTrips; ++u) {
      cj[u] = cn[u];
      vj[u] = vn[u];
    }
  }
  if (lane == 0) sums[c] = acc;
}

}  // namespace

extern "C" {

// A1.  idx: device int64 [lanes]; v: device float32 [lanes]; out: device
// float32 [3, n_cells], zero-filled: the sums, then the counts, then the
// heads (int32 words).  All contiguous; lanes < 2**24.  Launches on
// `stream` and returns its cudaError_t (0 on success); lanes == 0
// launches nothing.
int gst_scatter_add(int device, const int64_t* idx, const float* v,
                    int lanes, int64_t n_cells, float* out, void* stream) {
  if (lanes < 0 || lanes >= (1 << 24) || n_cells < 0)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* counts = out + n_cells;
  int* head = reinterpret_cast<int*>(out + 2 * n_cells);
  count_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      idx, lanes, n_cells, counts, head);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  walk_kernel<<<(lanes + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      idx, v, lanes, n_cells, out, counts, head);
  return (int)cudaGetLastError();
}

// Threads a block and lanes a block of the walk, for chip_smoke.py's
// design line.
void gst_scatter_shape(int* shape) {
  shape[0] = kThreads;
  shape[1] = kWarps;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
