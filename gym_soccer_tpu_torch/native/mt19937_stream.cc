// Batched MT19937 uniform-stream generator (parity-path host component).
//
// Reproduces numpy's legacy RandomState(seed).random_sample(n) streams —
// the exact generator the reference environment consumes one draw from per
// reset/step (soccer_simultaneous_env.py:57-58, :395, :414 via gym's
// categorical_sample) — for thousands of per-instance streams at once,
// multithreaded and GIL-free.  Loaded via ctypes (no pybind11 in this
// toolchain); gym_soccer_tpu/core/parity.py falls back to the numpy loop
// when the shared object is unavailable.
//
// Algorithm notes:
//  * seeding is Knuth's init_genrand (numpy _legacy_seeding for integer
//    seeds < 2^32: mt19937_seed);
//  * random_sample draws two 32-bit tempered outputs a, b and returns
//    (a>>5)*2^26 + (b>>6), divided by 2^53 — a 53-bit double in [0, 1).
//
// Build: g++ -O3 -shared -fPIC -pthread mt19937_stream.cc -o _mt19937.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int N = 624;
constexpr int M = 397;
constexpr uint32_t MATRIX_A = 0x9908b0dfU;
constexpr uint32_t UPPER_MASK = 0x80000000U;
constexpr uint32_t LOWER_MASK = 0x7fffffffU;

struct MT19937 {
  uint32_t mt[N];
  int mti;

  explicit MT19937(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < N; mti++) {
      mt[mti] =
          (1812433253U * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) + mti);
    }
  }

  uint32_t next32() {
    uint32_t y;
    if (mti >= N) {
      for (int kk = 0; kk < N - M; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + M] ^ (y >> 1) ^ ((y & 1U) ? MATRIX_A : 0U);
      }
      for (int kk = N - M; kk < N - 1; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + (M - N)] ^ (y >> 1) ^ ((y & 1U) ? MATRIX_A : 0U);
      }
      y = (mt[N - 1] & UPPER_MASK) | (mt[0] & LOWER_MASK);
      mt[N - 1] = mt[M - 1] ^ (y >> 1) ^ ((y & 1U) ? MATRIX_A : 0U);
      mti = 0;
    }
    y = mt[mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680U;
    y ^= (y << 15) & 0xefc60000U;
    y ^= (y >> 18);
    return y;
  }

  double next_double() {
    uint32_t a = next32() >> 5, b = next32() >> 6;
    return (a * 67108864.0 + b) / 9007199254740992.0;
  }
};

void fill_range(const uint64_t* seeds, int64_t n_draws, double* out,
                int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; i++) {
    MT19937 gen(static_cast<uint32_t>(seeds[i] & 0xFFFFFFFFULL));
    double* row = out + i * n_draws;
    for (int64_t j = 0; j < n_draws; j++) row[j] = gen.next_double();
  }
}

}  // namespace

extern "C" {

// out must hold n_seeds * n_draws doubles.
void mt19937_gen_streams(const uint64_t* seeds, int64_t n_seeds,
                         int64_t n_draws, double* out, int n_threads) {
  if (n_threads <= 1 || n_seeds < 2 * n_threads) {
    fill_range(seeds, n_draws, out, 0, n_seeds);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n_seeds + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n_seeds ? lo + chunk : n_seeds;
    if (lo >= hi) break;
    workers.emplace_back(fill_range, seeds, n_draws, out, lo, hi);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
