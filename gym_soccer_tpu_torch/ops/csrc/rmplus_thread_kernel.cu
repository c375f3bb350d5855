// R1's previous design: the batched 5x5 RM+ solve with one thread
// walking one game through every iteration.  Only
// ops/rmplus_variants.py builds it, to time it beside the committed
// kernel (csrc/rmplus_kernel.cu, a lane group a game) in the same run and
// to hold both to each other bit for bit; no wrapper launches it.  Its C
// interface is the committed kernel's, so `agents.learners.declare` loads
// either.
//
// What it computes, for each game M[g] (float32, row-major 5x5), with
// x, y the row maximizer's and the column minimizer's strategies, R the
// cumulative regrets (rx, ry) and S the weighted strategy sums (sx, sy),
// all zero at the start, for t = 0 .. iters-1:
//   s = sum_i R[i] in index order; X = s > 0 ? R / max(s, 1e-30) : 0.2
//   pay_x = M y, pay_y = x M, each a chain of float32 FMAs over j
//   vx = sum_i x[i] * pay_x[i] (rounded products, sums in index order)
//   rx = max(rx + (pay_x - vx), 0); ry = max(ry - (pay_y - vx), 0)
//   S = float32(double(X) * (t + 1) + double(S))
// then x = sx / sum(sx), y = sy / sum(sy) and value = sum_i (x M)_i y[i].
// iters == 0 gives 0 / 0: NaN strategies, as the plain version gives.
//
// Exactness: the plain version's arithmetic is fixed operation by
// operation, so R1 equals it bit for bit.  An FMA-chain step (`_fma_dot`)
// is the product of two float32, exact in float64, added to the float32
// accumulator in float64 and rounded to float32: one float64 FMA (the
// product is exact, so fusing it rounds nothing) and a conversion.  The
// averaging step is likewise one float64 FMA (a float32 times t + 1 <
// 2^24 is exact).  Every float32 product, sum and quotient is written with
// an explicit rounding intrinsic, so that nvcc's default -fmad=true cannot
// contract s + a * b into an FMA; the clamp keeps a NaN as torch's
// clamp_min does.
//
// What bounds it on this card: the latency of each thread's dependent
// chain, ~280 SASS instructions an iteration (the strategies' sums and
// divisions, four FMA-chain steps of a float32 -> float64 conversion, a
// float64 FMA and a conversion back, vx, the regret update).  The time
// does not move with the games a block or the games a call (761 to 11705,
// one to three warps a SM); the divisions (`strategy`) and the float64 FMA
// chains take most of it (ops/rmplus_variants.py times each part).  The
// games' 100 B each are read once; there is nothing else to move.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kA = 5;           // actions a player
constexpr int kThreads = 32;    // games a block: one warp

// One step of `_fma_dot`'s chain: float32(p * double(z) + acc), p and z
// float32 values held in float64.
__device__ __forceinline__ float chain(float acc, double p, double z) {
  return __double2float_rn(__fma_rn(p, z, (double)acc));
}

// sum_i a[i] in index order.
__device__ __forceinline__ float seq_sum(const float (&a)[kA]) {
  float s = a[0];
#pragma unroll
  for (int i = 1; i < kA; ++i) s = __fadd_rn(s, a[i]);
  return s;
}

// sum_i a[i] * b[i]: each product rounded, then summed in index order.
__device__ __forceinline__ float seq_dot(const float (&a)[kA],
                                         const float (&b)[kA]) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < kA; ++i) s = __fadd_rn(s, __fmul_rn(a[i], b[i]));
  return s;
}

// The RM+ strategy of regrets r: r / sum(r), or uniform if the sum is not
// positive, each share as IEEE division rounds it.  A zero regret's share
// is the regret itself (0 / d for d > 0, with its sign), with no division:
// RM+ clamps many regrets to zero, and __fdiv_rn on every share took 1.7x
// as long (ops/rmplus_variants.py).
__device__ __forceinline__ void strategy(const float (&r)[kA],
                                         float (&x)[kA]) {
  const float s = seq_sum(r);
  const float d = fmaxf(s, 1e-30f);
#pragma unroll
  for (int i = 0; i < kA; ++i)
    x[i] = s > 0.0f ? (r[i] == 0.0f ? r[i] : __fdiv_rn(r[i], d)) : 0.2f;
}

// torch.clamp_min(v, 0) on the card: a NaN stays NaN.
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// (M y)[i] and (x M)[i], each an FMA chain over j from j = 0.
__device__ __forceinline__ void payoffs(const float (&m)[kA * kA],
                                        const float (&x)[kA],
                                        const float (&y)[kA],
                                        float (&px)[kA], float (&py)[kA]) {
  double xd[kA], yd[kA];
#pragma unroll
  for (int j = 0; j < kA; ++j) {
    xd[j] = (double)x[j];
    yd[j] = (double)y[j];
  }
#pragma unroll
  for (int i = 0; i < kA; ++i) {
    float a = __fmul_rn(m[i * kA], y[0]);
    float b = __fmul_rn(m[i], x[0]);
#pragma unroll
    for (int j = 1; j < kA; ++j) {
      a = chain(a, (double)m[i * kA + j], yd[j]);
      b = chain(b, (double)m[j * kA + i], xd[j]);
    }
    px[i] = a;
    py[i] = b;
  }
}

// Iteration t's updates from the strategies x, y: the payoffs, vx, the
// regrets and the strategy sums.
__device__ __forceinline__ void update(const float (&m)[kA * kA],
                                       const float (&x)[kA],
                                       const float (&y)[kA], int t,
                                       float (&rx)[kA], float (&ry)[kA],
                                       float (&sx)[kA], float (&sy)[kA]) {
  float px[kA], py[kA];
  payoffs(m, x, y, px, py);
  const float vx = seq_dot(x, px);
  const double w = (double)(t + 1);
#pragma unroll
  for (int i = 0; i < kA; ++i) {
    rx[i] = clamp0(__fadd_rn(rx[i], __fsub_rn(px[i], vx)));
    ry[i] = clamp0(__fadd_rn(ry[i], -__fsub_rn(py[i], vx)));
    sx[i] = __double2float_rn(__fma_rn((double)x[i], w, (double)sx[i]));
    sy[i] = __double2float_rn(__fma_rn((double)y[i], w, (double)sy[i]));
  }
}

__global__ void __launch_bounds__(kThreads)
    rmplus_kernel(const float* __restrict__ games, int n_games, int iters,
                  float* __restrict__ value, float* __restrict__ xs,
                  float* __restrict__ ys) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_games) return;
  float m[kA * kA];
#pragma unroll
  for (int k = 0; k < kA * kA; ++k) m[k] = games[(size_t)g * kA * kA + k];
  float rx[kA], ry[kA], sx[kA], sy[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) rx[i] = ry[i] = sx[i] = sy[i] = 0.0f;
#pragma unroll 1
  for (int t = 0; t < iters; ++t) {
    float x[kA], y[kA];
    strategy(rx, x);
    strategy(ry, y);
    update(m, x, y, t, rx, ry, sx, sy);
  }
  const float nx = seq_sum(sx), ny = seq_sum(sy);
  float x[kA], y[kA], px[kA], py[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) {
    x[i] = __fdiv_rn(sx[i], nx);
    y[i] = __fdiv_rn(sy[i], ny);
  }
  payoffs(m, x, y, px, py);   // py = x M
  value[g] = seq_dot(py, y);
#pragma unroll
  for (int i = 0; i < kA; ++i) {
    xs[(size_t)g * kA + i] = x[i];
    ys[(size_t)g * kA + i] = y[i];
  }
}

}  // namespace

extern "C" {

// R1.  games: device float32 [n_games, 5, 5], contiguous; out: device
// float32 [11 * n_games]: the values [n_games], then x [n_games, 5], then
// y [n_games, 5]; iters >= 0.  Launches on `stream` and returns its
// cudaError_t (0 on success); n_games == 0 launches nothing.
int gst_rmplus_solve(int device, const float* games, int n_games, int iters,
                     float* out, void* stream) {
  if (n_games < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (n_games == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_games + kThreads - 1) / kThreads;
  rmplus_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      games, n_games, iters, out, out + n_games, out + 6 * (size_t)n_games);
  return (int)cudaGetLastError();
}

// The launch's shape: lanes a game, games a warp, warps a block.
void gst_rmplus_shape(int* shape) {
  shape[0] = 1;
  shape[1] = 32;
  shape[2] = kThreads / 32;
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
