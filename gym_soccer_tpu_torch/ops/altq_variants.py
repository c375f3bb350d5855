"""Time variants of the K10 and K11 turn-based Q kernels on a CUDA card.

Each variant is ``csrc/altq_kernel.cu`` with a few text patches
(`VARIANTS`), built beside the port's own build, and launched through
``altq_packed_chunk`` (K10) and ``altq_chunk`` (K11) at ``chip_smoke.py``'s
chunk, 8192 lanes x 64 steps on 5x4 and 11x7 (slip 0.2), and at the
alternating gate's 65536 x 32 on 5x4, eps 0.3, from step 640, on a Q table
with near-ties.  Each runs at the lanes per block listed beside it (None:
the default for the batch).  Design variants (the previous design, the
arithmetic walk on 5x4 in place of the tick table, the visits added by
device-memory atomics in place of each block's private accumulators in
shared memory, the pending visit retired before the table walk's step in
place of after it, the block sizes) must give the committed kernel's fields,
stats, counts and int64 sums bit for bit, and equal the plain version run
on the CPU at 1024 lanes x 16 steps; they are checked so.  ``diag-``
variants break the result on purpose to show what one part costs (the
step without its accumulation atomics) and are only timed.

    python -m gym_soccer_tpu_torch.ops.altq_variants

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
# one thread a lane hashing, scanning and stepping (altq_kernel<kPacked>,
# 64 blocks of 128 at 8192 lanes), its outputs placed in the call's one
# allocation.
_ENTRY = """  return chunk(device, in, buf, table, tick, code_raw, params, n_codes, B,
               n_steps, seed, eps_int, step_offset, scalars, gamma, limit,
               packed, lanes, stream);"""
_OLD_ENTRY = """  (void)tick; (void)code_raw; (void)lanes; (void)scalars;
  if (B <= 0 || n_steps <= 0 || params[6] < 1 || params[6] > kMaxIsd)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AltqLayout l = altq_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, st);
  if (e != cudaSuccess) return (int)e;
  void* out[7];
  for (int k = 0; k < 7; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  long long* sums = reinterpret_cast<long long*>(base + l.sums);
  int* cnt = reinterpret_cast<int*>(base + l.cnt);
  long long* stats = reinterpret_cast<long long*>(base + l.stats);
  const int blocks = (B + 127) / 128;
  if (packed)
    altq_kernel<true><<<blocks, 128, 0, st>>>(
        make_alt_planes(in), make_alt_planes(out), table, sums, cnt, stats,
        B, n_steps, seed, eps_int, step_offset, gamma, limit,
        make_game(params));
  else
    altq_kernel<false><<<blocks, 128, 0, st>>>(
        make_alt_planes(in), make_alt_planes(out), table, sums, cnt, stats,
        B, n_steps, seed, eps_int, step_offset, gamma, limit,
        make_game(params));
  return (int)cudaGetLastError();"""
# The tick table where it fits (the kernel: 5x4), or the arithmetic walk.
_TABLE = ("  const bool table = has_table && rows && fits(n_codes, n_codes, 0);",
          "  const bool table = false;")
# The accumulators' place: a block's own in shared memory where they fit
# (the kernel: 5x4), or device memory.
_DEVICE = ("""  return Placement{rows, table,
                   rows && fits(n_codes, table ? n_codes : 0, n_codes) &&
                       (long long)lanes * n_steps <= kAccMaxVisits};""",
           "  return Placement{rows, table, false};")
# The pending visit retired before the step (as K8/K9 do) in place of
# after it, in the table walk.
_SETTLE_LAST = ("""    t = (goal | late) ? 0 : t + 1;
    this->settle(v);""", """    t = (goal | late) ? 0 : t + 1;""")
_SETTLE_FIRST = ("""    const int gr = (greedy[cs2 >> 2] >> (3 * (ct & 1))) & 7;
    const int x = code & 7u;""", """    const int gr = (greedy[cs2 >> 2] >> (3 * (ct & 1))) & 7;
    this->settle(v);
    const int x = code & 7u;""")
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

# name -> ([(text in altq_kernel.cu, its replacement)], lanes per block to
# time (None: the batch's default)); each text must occur exactly once.
VARIANTS = {
    "kernel": ([], (None, 32, 128)),
    "previous-design": ([(_ENTRY, _OLD_ENTRY)], (None,)),
    "arith-walk": ([_TABLE], (None,)),
    "device-atomics": ([_DEVICE], (None,)),
    "retire-first": ([_SETTLE_LAST, _SETTLE_FIRST], (None,)),
    # diagnostics: wrong results, by design
    "diag-no-atomics": ([(_ATOMICS, _NO_ATOMICS),
                         (_SHARED_ATOMICS, _NO_SHARED_ATOMICS)], (None,)),
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
    src = out_dir / f"altq_kernel-{name}.cu"
    src.write_text(variant_source(
        name, (_build.CSRC / "altq_kernel.cu").read_text()))
    return _build.compile_sources([src], out_dir / f"altq_kernel-{name}.so")


def _registers(log: str) -> dict:
    """{'K10 table shared accumulators' ...: registers} of K10's and K11's
    kernels in an nvcc log."""
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers", log, re.S):
        k = re.search(r"altq_chunk_kernelILb([01])ELb([01])ELb([01])ELb([01])E",
                      m.group(1))
        old = re.search(r"11altq_kernelILb([01])E", m.group(1))
        if k:
            regs[("K10" if k.group(1) == "1" else "K11")
                 + (" table" if k.group(2) == "1" else " arithmetic")
                 + (" rows in L2" if k.group(3) == "0" else "")
                 + (" shared accumulators" if k.group(4) == "1" else "")] = \
                int(m.group(2))
        elif old:
            regs["previous " + ("K10" if old.group(1) == "1" else "K11")] = \
                int(m.group(2))
    return regs


def inputs(torch, ak, cfg, batch: int, device, seed: int):
    """A Q table in [-1, 1] with near-ties (every third state's action 1
    one float32 step above action 0, a tie once double-bf16 rounded) made
    from a numpy seed, as the chunks' table; and the initial fields."""
    import numpy as np

    from ..envs.soccer_alternating_env import build_alt_tables
    nS = build_alt_tables(cfg).nS
    q = torch.tensor(np.random.default_rng(seed).uniform(-1, 1, (nS, 5)),
                     dtype=torch.float32)
    q[::3, 1] = torch.nextafter(q[::3, 0], torch.tensor(2.0))
    return (ak.pack_alt_table(cfg, q.to(device)),
            ak.init_alt_state_fields(cfg, batch, device))


def _flat(out):
    fields, (sums, cnt), stats = out
    return [*fields, sums, cnt, *stats]


def main() -> int:
    import ctypes

    import torch

    from ..config import EnvConfig
    from . import altq_kernel as ak
    from . import parity_variants, rollout_variants

    if not torch.cuda.is_available():
        print("altq_variants: no CUDA device", file=sys.stderr)
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
    runs = {(shape, b): inputs(torch, ak, cfgs[b], shape[0], dev, b[0])
            for shape, boards in SHAPES.items() for b in boards}
    small = {b: inputs(torch, ak, c, 1024, "cpu", 3) for b, c in cfgs.items()}
    names = {True: "altq_packed_chunk", False: "altq_chunk"}
    cpu = {(b, packed): _flat(getattr(ak, names[packed])(
        cfgs[b], 5, eps, t, f, 1024, 16, 0.99, 9))
        for b, (t, f) in small.items() for packed in names}
    committed = ak._library
    want, ok = {}, True
    try:
        for name, (_, lane_sizes) in VARIANTS.items():
            lib = ak.declare(ctypes.CDLL(str(built[name])))
            ak._library = lambda lib=lib: lib
            regs = _registers(built[name].with_suffix(".log").read_text())
            diag = name.startswith("diag-")
            for packed, fn_name in names.items():
                chunk = getattr(ak, fn_name)
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
                        print(f"[variant] {'K10' if packed else 'K11'} "
                              f"{name}, {shape[0]} x {shape[1]}, "
                              f"{lanes or 'default'} lanes per block: "
                              + ", ".join(f"{k} call {v[0]} / device {v[1]} "
                                          f"ms" for k, v in ms.items())
                              + f"; registers {regs}; {equal} | {card}",
                              flush=True)
    finally:
        ak._library = committed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
