// An empty kernel for Hopper (sm_90a): the floor under kernels S2 and S3.
//
// It computes nothing.  ops/mixed_alt_variants.py launches it with the
// grid and block that S2 and S3 take at a number of lanes (one thread a
// lane, `threads` lanes a block), captures it in a CUDA graph and times
// the replays as it times the kernels, so that a kernel's time above this
// one is the work of its lanes: their loads, draws, moves, table reads and
// stores, not the launch and the block scheduling every kernel pays.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launches empty_kernel on `stream` in ceil(lanes / threads) blocks of
// `threads` threads and returns its cudaError_t (0 on success); lanes == 0
// launches nothing.
int gst_launch_floor(int device, int lanes, int threads, void* stream) {
  if (lanes < 0 || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  empty_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* gst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
