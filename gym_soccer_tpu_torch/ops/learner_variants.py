"""Time variants of the K5 learner kernel on a CUDA card.

Each variant is ``csrc/learner_kernel.cu`` with a few text patches
(`VARIANTS`), built beside the port's own build and launched through
``packed_learner_chunk`` at ``chip_smoke.py``'s shapes: 8192 lanes x 64
steps (the flagship chunk) and 65536 x 32 (the 5x4 contract's chunk), on
5x4 and 11x7, slip 0.2, each at the lanes per block listed beside it (None:
the default for the batch).  Design variants (the previous design, the
rows read from L2 on 5x4 too, warp-aggregated atomics, the block sizes)
must give the committed kernel's
fields, stats, counts and int64 sums bit for bit, and equal the plain
version run on the CPU at 1024 lanes x 16 steps; they are checked so.
``diag-`` variants break the result on purpose to show what one part costs
(the walk without the hashing, the hashing without the walk, the step
without its accumulation atomics) and are only timed.

    python -m gym_soccer_tpu_torch.ops.learner_variants

prints one line per variant, shape and block size and exits 1 if a design
variant differs.  Each line gives, per board, two times, both the median of
5 legs of at least 50 ms (CUDA events): ``call``, of ``packed_learner_chunk``
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

# The committed K5 entry's body.
_ENTRY = """  return packed_chunk(device, in, buf, table, params, n_codes, B, n_steps,
                      seed, gamma, limit, lanes, stream);"""
# The previous design: one thread a lane hashing, sampling and stepping
# (learner_kernel<true, false>, 64 blocks of 128 at 8192 lanes), its
# outputs placed in the call's one allocation.
_OLD_ENTRY = """  (void)lanes;
  const ChunkLayout l = chunk_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  void* out[6];
  for (int k = 0; k < 6; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  return launch<true, false>(device, in, out, nullptr, table,
                             reinterpret_cast<long long*>(base + l.sums),
                             reinterpret_cast<int*>(base + l.cnt),
                             reinterpret_cast<long long*>(base + l.stats),
                             params, B, n_steps, seed, gamma, limit, 128,
                             stream);"""
# The rows' place: shared memory where they fit (the kernel), or L2.
_SHARED = "  const bool shared = shared_rows(n_codes);"
# retire's two global atomics
_ATOMICS = """  atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
            (unsigned long long)fixed);
  atomicAdd(cnt + idx, 1);"""
_AGGREGATED = """  const unsigned group = __match_any_sync(__activemask(), idx);
  long long total = 0;
  for (unsigned m = group; m; m &= m - 1)
    total += __shfl_sync(group, fixed, __ffs(m) - 1);
  if ((threadIdx.x & 31) == __ffs(group) - 1) {
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + idx),
              (unsigned long long)total);
    atomicAdd(cnt + idx, __popc(group));
  }"""
_NO_ATOMICS = """  if (fixed == 0x7FFFFFFFFFFFFFFFLL) atomicAdd(cnt + idx, 1);"""
_STEP_CALL = "      step(cw[s], (cs[s / 4] >> (8 * (s & 3))) & 0xFFu);"
_TAIL_CALL = "  for (int s = 0; s < a.n_steps - n_full * kTile; ++s) step(lw[s], ls[s]);"
_HASH = """      const uint32_t b0 = fmix32(fmix32(lane ^ c0) + c0);
      const uint32_t b1 = fmix32(fmix32(lane ^ c1) + c1);
      const uint32_t b2 = fmix32(fmix32(lane ^ c2) + c2);"""
_NO_HASH = """      const uint32_t b0 = lane * 0x9E3779B9u + c0;
      const uint32_t b1 = lane * 0x85EBCA6Bu + c1;
      const uint32_t b2 = lane * 0xC2B2AE35u + c2;"""

# name -> ([(text in learner_kernel.cu, its replacement)], lanes per block
# to time (None: the batch's default)); each text must occur exactly once.
VARIANTS = {
    "kernel": ([], (None, 32, 128, 256)),
    "previous-design": ([(_ENTRY, _OLD_ENTRY)], (None,)),
    "rows-in-l2": ([(_SHARED, "  const bool shared = false;")], (None,)),
    "warp-aggregated-atomics": ([(_ATOMICS, _AGGREGATED)], (None,)),
    # diagnostics: wrong results, by design
    "diag-no-atomics": ([(_ATOMICS, _NO_ATOMICS)], (None,)),
    "diag-hash-only": ([(_STEP_CALL, "      step.rew += (int)(cw[s] ^ cs[s / 4]);"),
                        (_TAIL_CALL, "  for (int s = 0; s < a.n_steps - n_full "
                                     "* kTile; ++s) step.rew += (int)lw[s];")],
                       (None,)),
    "diag-walk-only": ([(_HASH, _NO_HASH)], (None,)),
}
SHAPES = ((8192, 64), (65536, 32))
BOARDS = ((5, 4), (11, 7))
SLIP = 0.2


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
    src = out_dir / f"learner_kernel-{name}.cu"
    src.write_text(variant_source(
        name, (_build.CSRC / "learner_kernel.cu").read_text()))
    return _build.compile_sources([src], out_dir / f"learner_kernel-{name}.so")


def _registers(log: str) -> dict:
    """{'K5 table' ...: registers} of K5's kernels in an nvcc log."""
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers", log, re.S):
        k = re.search(r"packed_kernelILb([01])E", m.group(1))
        if k:
            regs["K5 " + ("shared rows" if k.group(1) == "1" else
                          "rows in L2")] = int(m.group(2))
        elif "learner_kernelILb1ELb0E" in m.group(1):
            regs["K5 previous"] = int(m.group(2))
    return regs


def main() -> int:
    import torch

    from ..config import EnvConfig
    from . import learner_kernel as lk
    from . import parity_variants, rollout_variants

    if not torch.cuda.is_available():
        print("learner_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = rollout_variants._out_dir()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda n: _build_variant(n, out_dir), VARIANTS)))

    import ctypes

    import numpy as np
    dev = torch.device("cuda", 0)
    cfgs = {b: EnvConfig(width=b[0], height=b[1], slip_prob=SLIP)
            for b in BOARDS}

    def inputs(cfg, batch, device, seed):
        nS = len(lk._cell_rows(cfg))
        rng = np.random.default_rng(seed)
        pa, pb = (torch.tensor(rng.dirichlet(np.ones(5), nS),
                               dtype=torch.float32, device=device)
                  for _ in range(2))
        v = torch.tensor(rng.uniform(-1, 1, nS), dtype=torch.float32,
                         device=device)
        return (lk.pack_m2(cfg, pa, pb, v, 0.2),
                lk.init_state_fields(cfg, batch, device))

    def flat(out):
        fields, (sums, cnt), stats = out
        return [*fields, sums, cnt, *stats]

    data = {(b, s): inputs(c, s[0], dev, b[0])
            for b, c in cfgs.items() for s in SHAPES}
    small = {b: inputs(c, 1024, "cpu", 3) for b, c in cfgs.items()}
    cpu = {b: flat(lk.packed_learner_chunk(c, 5, *small[b], 1024, 16))
           for b, c in cfgs.items()}
    committed = lk._library
    want, ok = {}, True
    try:
        for name, path in built.items():
            lib = lk.declare(ctypes.CDLL(str(path)))
            lk._library = lambda lib=lib: lib
            lk._packed_host.cache_clear()
            regs = _registers(path.with_suffix(".log").read_text())
            diag = name.startswith("diag-")
            for shape in SHAPES:
                for lanes in VARIANTS[name][1]:
                    ms, same = {}, []
                    for b, c in cfgs.items():
                        table, fields = data[(b, shape)]

                        def fn():
                            return lk.packed_learner_chunk(
                                c, 77, table, fields, *shape, 0.99,
                                threads=lanes)
                        out = [x.cpu() for x in flat(fn())]
                        if name == "kernel" and lanes is None:
                            want[(b, shape)] = out
                        same.append(all(torch.equal(x, y) for x, y in
                                        zip(out, want[(b, shape)])))
                        got = flat(lk.packed_learner_chunk(
                            c, 5, *(x.to(dev) if isinstance(x, torch.Tensor)
                                    else [f.to(dev) for f in x]
                                    for x in small[b]), 1024, 16))
                        same.append(all(torch.equal(x.cpu(), y) for x, y in
                                        zip(got, cpu[b])))
                        ms[f"{b[0]}x{b[1]}"] = (
                            parity_variants._time(fn),
                            rollout_variants._device_ms(fn))
                    if not diag and not all(same):
                        ok = False
                    equal = ("diagnostic, not compared" if diag
                             else "bit-equal to the kernel and to the CPU "
                             "plain version" if all(same) else
                             "DIFFERS from the kernel or the CPU plain "
                             "version")
                    print(f"[variant] K5 {name}, {shape[0]} x {shape[1]}, "
                          f"{lanes or 'default'} lanes per block: "
                          + ", ".join(f"{k} call {v[0]} / device {v[1]} ms"
                                      for k, v in ms.items())
                          + f"; registers {regs}; {equal} | {card}",
                          flush=True)
    finally:
        lk._library = committed
        lk._packed_host.cache_clear()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
