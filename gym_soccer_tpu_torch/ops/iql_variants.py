"""Time variants of the K8 and K9 independent-Q kernels on a CUDA card.

Each variant is ``csrc/iql_kernel.cu`` with a few text patches
(`VARIANTS`), built beside the port's own build, and launched through
``iql_packed_chunk`` (K8) and ``iql_chunk`` (K9) at ``chip_smoke.py``'s
chunk, 8192 lanes x 64 steps on 5x4 and 11x7 (slip 0.2), and at the IQL
trainer's 65536 x 32 on 5x4, eps 0.3, from step 640, on Q tables with
near-ties.  Each runs at the lanes per block listed beside it (None: the
default for the batch).  Design variants (the previous design, the rows
read from L2, the visits added by device-memory atomics in place of each
block's private accumulators in shared memory, those atomics
warp-aggregated, the block sizes) must give the committed kernel's fields,
stats, counts and int64 sums bit for bit, and equal the plain version run
on the CPU at 1024 lanes x 16 steps; they are checked so.  ``diag-`` variants break the result on purpose to
show what one part costs (the step without its accumulation atomics; the
device-memory atomics spread over neighbouring cells, few on one address)
and are only timed.

    python -m gym_soccer_tpu_torch.ops.iql_variants

prints one line per variant, kernel, shape and block size and exits 1 if a
design variant differs.  Each line gives, per board, two times, both the
median of 5 legs of at least 50 ms (CUDA events): ``call``, of the wrapper
as a user calls it (its host work included), and ``device``, of the same
call captured in a CUDA graph and replayed (the memset, the prep pass and
the kernel alone); and the registers, the card's name and its power limit.
Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# The committed entry's dispatch, and the previous design's in its place:
# one thread a lane hashing, scanning and stepping (iql_kernel<kPacked>,
# 64 blocks of 128 at 8192 lanes), its outputs placed in the call's one
# allocation.
_ENTRY = """  return packed ? chunk<true>(device, in, buf, table, params, n_codes, B,
                              n_steps, seed, eps_int, step_offset, scalars,
                              gamma, limit, lanes, stream)
                : chunk<false>(device, in, buf, table, params, n_codes, B,
                               n_steps, seed, eps_int, step_offset, scalars,
                               gamma, limit, lanes, stream);"""
_OLD_ENTRY = """  (void)lanes;
  (void)scalars;
  if (B <= 0 || n_steps <= 0 || params[6] < 1 || params[6] > kMaxIsd)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const IqlLayout l = iql_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, st);
  if (e != cudaSuccess) return (int)e;
  void* out[6];
  for (int k = 0; k < 6; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  long long* sums = reinterpret_cast<long long*>(base + l.sums);
  int* cnt = reinterpret_cast<int*>(base + l.cnt);
  long long* stats = reinterpret_cast<long long*>(base + l.stats);
  const int blocks = (B + 127) / 128;
  if (packed)
    iql_kernel<true><<<blocks, 128, 0, st>>>(
        make_planes(in), make_planes(out), table, sums, cnt, stats, B,
        n_steps, seed, eps_int, step_offset, gamma, limit, make_game(params));
  else
    iql_kernel<false><<<blocks, 128, 0, st>>>(
        make_planes(in), make_planes(out), table, sums, cnt, stats, B,
        n_steps, seed, eps_int, step_offset, gamma, limit, make_game(params));
  return (int)cudaGetLastError();"""
_NAMESPACE_END = """}  // namespace

extern "C" {"""
# The previous design's kernel (its greedy scan and retire are the
# committed source's).
_OLD_KERNEL = """__device__ __forceinline__ void load_q(const float* __restrict__ table,
                                       int cp, float* qa, float* qb) {
  const float* row = table + (size_t)cp * kCols;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    qa[k] = __ldg(row + k);
    qb[k] = __ldg(row + 5 + k);
  }
}

template <bool kPacked>
__global__ void iql_kernel(Planes in, Planes out,
                           const float* __restrict__ table, long long* sums,
                           int* cnt, long long* stats, int B, int n_steps,
                           uint32_t seed, int eps_int, int step_offset,
                           float gamma, float limit, Game g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0, out_of_range = 0;
  if (lane < B) {
    const int nc = n_cells(g);
    State s{in.f[0][lane], in.f[1][lane], in.f[2][lane],
            in.f[3][lane], in.f[4][lane], in.f[5][lane]};
    const uint32_t ctr = (uint32_t)lane;
    float qa[5], qb[5];
    int p_a = -1, p_b = -1;
    float p_r = 0.0f, p_cont = 0.0f, p_base_a = 0.0f, p_base_b = 0.0f;
    for (int i = 0; i < n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + step_offset);
      const uint32_t bits0 = random_word(seed, step, 0u, ctr);
      const uint32_t bits1 = random_word(seed, step, 1u, ctr);
      const uint32_t bits2 = random_word(seed, step, 2u, ctr);
      const uint32_t bits3 = random_word(seed, step, 3u, ctr);
      const int cp = cellpair_encode(s, g, nc);
      load_q(table, cp, qa, qb);
      float va, vb;
      const int ga = greedy(qa, va);
      const int gb = greedy(qb, vb);
      if (p_a >= 0) {
        out_of_range +=
            retire(sums, cnt, p_a, p_r, p_cont, va, p_base_a, limit) +
            retire(sums, cnt, p_b, -p_r, p_cont, vb, p_base_b, limit);
      }
      const int aa = u16(bits0, 0) < eps_int ? u16(bits0, 1) % 5 : ga;
      const int ab = u16(bits3, 0) < eps_int ? u16(bits3, 1) % 5 : gb;
      bool goal, trunc;
      int r;
      transition(s, aa, ab, bits1, bits2, g, goal, r);
      autoreset(s, goal, bits2, g, trunc);
      p_a = cp * kCols + aa;
      p_b = cp * kCols + 5 + ab;
      p_r = (float)r;
      p_cont = (goal || trunc) ? 0.0f : gamma;
      p_base_a = kPacked ? va : qa[aa];
      p_base_b = kPacked ? vb : qb[ab];
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    if (p_a >= 0) {
      load_q(table, cellpair_encode(s, g, nc), qa, qb);
      float va, vb;
      greedy(qa, va);
      greedy(qb, vb);
      out_of_range +=
          retire(sums, cnt, p_a, p_r, p_cont, va, p_base_a, limit) +
          retire(sums, cnt, p_b, -p_r, p_cont, vb, p_base_b, limit);
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

"""
# The rows' place: shared memory where they fit (the kernel), or L2.
_ROWS = "  const bool rows = fits(n_codes, 0);"
# The accumulators' place: a block's own in shared memory where they fit
# (the kernel: 5x4), or device memory.
_DEVICE = ("""  return Placement{rows, rows && fits(n_codes, n_codes) &&
                             (long long)lanes * n_steps <= kAccMaxVisits};""",
           "  return Placement{rows, false};")
# retire's two global atomics, and retire_shared's four shared ones
_ATOMICS = """  atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
            (unsigned long long)fixed);
  atomicAdd(cnt + idx, 1);"""
_NO_ATOMICS = """  if (fixed == 0x7FFFFFFFFFFFFFFFLL) atomicAdd(cnt + idx, 1);"""
_SHARED_ATOMICS = """  atomicAdd(c, (unsigned)u & 0xFFFFu);
  atomicAdd(c + 1, (unsigned)(u >> 16) & 0xFFFFu);
  atomicAdd(c + 2, (unsigned)(u >> 32));
  atomicAdd(c + 3, 1u);"""
_NO_SHARED_ATOMICS = """  if (u == 0x7FFFFFFFFFFFFFFFull) atomicAdd(c + 3, 1u);"""
# Each visit's atomics moved to one of 8 neighbouring cells by the thread's
# lane in its warp, so that few of them meet on one address.
_SPREAD = """  atomicAdd(reinterpret_cast<unsigned long long*>(sums + (idx ^ (threadIdx.x & 7))),
            (unsigned long long)fixed);
  atomicAdd(cnt + (idx ^ (threadIdx.x & 7)), 1);"""
# The lanes of a warp that retire into one cell add their values (as three
# 32-bit parts, exact modulo 2**64) and their count by warp reductions, and
# one of them adds the totals.
_AGGREGATED = """  const unsigned group = __match_any_sync(__activemask(), idx);
  const unsigned long long u = (unsigned long long)fixed;
  const unsigned hi = __reduce_add_sync(group, (unsigned)(u >> 32));
  const unsigned mid = __reduce_add_sync(group, (unsigned)(u >> 16) & 0xFFFFu);
  const unsigned lo = __reduce_add_sync(group, (unsigned)u & 0xFFFFu);
  if ((threadIdx.x & 31) == __ffs(group) - 1) {
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
              ((unsigned long long)hi << 32) + ((unsigned long long)mid << 16) +
                  lo);
    atomicAdd(cnt + idx, __popc(group));
  }"""

# name -> ([(text in iql_kernel.cu, its replacement)], lanes per block to
# time (None: the batch's default)); each text must occur exactly once.
VARIANTS = {
    "kernel": ([], (None, 32, 128)),
    "previous-design": ([(_NAMESPACE_END, _OLD_KERNEL + _NAMESPACE_END),
                         (_ENTRY, _OLD_ENTRY)], (None,)),
    # the rows in L2, and with them the accumulators (they take the rows'
    # shared memory): compare with device-atomics
    "rows-in-l2": ([(_ROWS, "  const bool rows = false;")], (None,)),
    "device-atomics": ([_DEVICE], (None, 128)),
    "device-atomics-warp-aggregated": ([_DEVICE, (_ATOMICS, _AGGREGATED)],
                                       (None,)),
    # diagnostics: wrong results, by design
    "diag-no-atomics": ([(_ATOMICS, _NO_ATOMICS),
                         (_SHARED_ATOMICS, _NO_SHARED_ATOMICS)], (None,)),
    "diag-device-atomics-spread": ([_DEVICE, (_ATOMICS, _SPREAD)], (None,)),
}
# (lanes, steps) -> the boards timed at that shape
SHAPES = {(8192, 64): ((5, 4), (11, 7)), (65536, 32): ((5, 4),)}
SLIP = 0.2
EPS = 0.3
STEP_OFFSET = 640


def variant_source(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches applied; ValueError if a
    patched text does not occur exactly once."""
    for old, new in VARIANTS[name][0]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: its patch matches "
                             f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def _build_variant(name: str, out_dir):
    from . import _build
    src = out_dir / f"iql_kernel-{name}.cu"
    src.write_text(variant_source(
        name, (_build.CSRC / "iql_kernel.cu").read_text()))
    return _build.compile_sources([src], out_dir / f"iql_kernel-{name}.so")


def _registers(log: str) -> dict:
    """{'K8 shared rows' ...: registers} of K8's and K9's kernels in an
    nvcc log."""
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers", log, re.S):
        k = re.search(r"iql_chunk_kernelILb([01])ELb([01])ELb([01])E",
                      m.group(1))
        old = re.search(r"10iql_kernelILb([01])E", m.group(1))
        if k:
            regs[("K8" if k.group(1) == "1" else "K9")
                 + (" shared rows" if k.group(2) == "1" else " rows in L2")
                 + (" shared accumulators" if k.group(3) == "1" else "")] = \
                int(m.group(2))
        elif old:
            regs["previous " + ("K8" if old.group(1) == "1" else "K9")] = \
                int(m.group(2))
    return regs


def inputs(torch, ik, cfg, batch: int, device, seed: int):
    """Q tables in [-1, 1] with near-ties (every third state's action 1 one
    float32 step above action 0, a tie once double-bf16 rounded) made from
    a numpy seed, as the chunk's table; and the initial fields."""
    import numpy as np
    nS = len(ik.lk._cell_rows(cfg))
    rng = np.random.default_rng(seed)
    qa, qb = (torch.tensor(rng.uniform(-1, 1, (nS, 5)), dtype=torch.float32)
              for _ in range(2))
    qa[::3, 1] = torch.nextafter(qa[::3, 0], torch.tensor(2.0))
    return (ik.pack_iql_table(cfg, qa.to(device), qb.to(device)),
            ik.init_iql_state_fields(cfg, batch, device))


def _flat(out):
    fields, (sums, cnt), stats = out
    return [*fields, sums, cnt, *stats]


def main() -> int:
    import ctypes

    import torch

    from ..config import EnvConfig
    from . import iql_kernel as ik
    from . import parity_variants, rollout_variants

    if not torch.cuda.is_available():
        print("iql_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = rollout_variants._out_dir()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda n: _build_variant(n, out_dir), VARIANTS)))

    dev = torch.device("cuda", 0)
    eps = int(round(EPS * 65536))
    cfgs = {b: EnvConfig(width=b[0], height=b[1], slip_prob=SLIP)
            for b in {b for boards in SHAPES.values() for b in boards}}
    runs = {(shape, b): inputs(torch, ik, cfgs[b], shape[0], dev, b[0])
            for shape, boards in SHAPES.items() for b in boards}
    small = {b: inputs(torch, ik, c, 1024, "cpu", 3) for b, c in cfgs.items()}
    names = {True: "iql_packed_chunk", False: "iql_chunk"}
    cpu = {(b, packed): _flat(getattr(ik, names[packed])(
        cfgs[b], 5, eps, t, f, 1024, 16, 0.99, 9))
        for b, (t, f) in small.items() for packed in names}
    committed = ik._library
    want, ok = {}, True
    try:
        for name, (_, lane_sizes) in VARIANTS.items():
            lib = ik.declare(ctypes.CDLL(str(built[name])))
            ik._library = lambda lib=lib: lib
            regs = _registers(built[name].with_suffix(".log").read_text())
            diag = name.startswith("diag-")
            for packed, fn_name in names.items():
                chunk = getattr(ik, fn_name)
                for lanes in lane_sizes:
                    for shape, boards in SHAPES.items():
                        ms, same = {}, []
                        for b in boards:
                            table, fields = runs[shape, b]

                            def fn():
                                return chunk(cfgs[b], 77, eps, table, fields,
                                             *shape, 0.99, STEP_OFFSET, lanes)
                            out = [x.cpu() for x in _flat(fn())]
                            key = (packed, shape, b)
                            if name == "kernel" and lanes is None:
                                want[key] = out
                            same.append(all(torch.equal(x, y) for x, y in
                                            zip(out, want[key])))
                            st, sf = small[b]
                            got = _flat(chunk(cfgs[b], 5, eps, st.to(dev),
                                              [f.to(dev) for f in sf], 1024,
                                              16, 0.99, 9, lanes))
                            same.append(all(torch.equal(x.cpu(), y) for x, y
                                            in zip(got, cpu[b, packed])))
                            ms[f"{b[0]}x{b[1]}"] = (
                                parity_variants._time(fn),
                                rollout_variants._device_ms(fn))
                        if not diag and not all(same):
                            ok = False
                        equal = ("diagnostic, not compared" if diag
                                 else "bit-equal to the kernel and to the "
                                 "CPU plain version" if all(same) else
                                 "DIFFERS from the kernel or the CPU plain "
                                 "version")
                        print(f"[variant] {'K8' if packed else 'K9'} {name}, "
                              f"{shape[0]} x {shape[1]}, "
                              f"{lanes or 'default'} lanes per block: "
                              + ", ".join(f"{k} call {v[0]} / device {v[1]} "
                                          f"ms" for k, v in ms.items())
                              + f"; registers {regs}; {equal} | {card}",
                              flush=True)
    finally:
        ik._library = committed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
