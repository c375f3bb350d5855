"""Time variants of the K5, K6 and K7 learner kernels on a CUDA card.

Each variant is ``csrc/learner_kernel.cu`` with a few text patches
(`VARIANTS` for K5, `K6_VARIANTS` for K6, `K7_VARIANTS` for K7), built
beside the port's own build.  K5's are launched through
``packed_learner_chunk`` at ``chip_smoke.py``'s shapes: 8192 lanes x 64
steps (the flagship chunk) and 65536 x 32 (the 5x4 contract's chunk), on
5x4 and 11x7, slip 0.2.  K6's are launched through
``multigrid_packed_learner_chunk`` on ``tools/bench_all.py``'s 3-board
mixture at 8192 x 64 and 32768 x 64, on 5x4 + 11x7 at 8192 x 64 and on
the ``--multigrid`` recipe's 5x4 + 6x5 (slip 0.2) at its 16384 x 64, the
one whose prepared rows fit shared memory.  K7's are launched through
``learner_chunk`` at 8192 x 64 on 5x4 and 11x7 and
``multigrid_learner_chunk`` at 8192 x 64 on the 3-board mixture.  Each
runs at the lanes per block listed beside it (None: the default for the
batch).  Design variants (the previous design, the rows read from L2
where they fit shared memory, warp-aggregated atomics, q(s, a) read from
the table in shared memory on 5x4, the block sizes) must give the
committed kernel's fields, stats, counts and int64 sums bit for bit, and
equal the plain version run on the CPU at 1024 lanes x 16 steps; they are
checked so.  ``diag-`` variants break the result on purpose to show what
one part costs (the walk without the hashing, the hashing without the
walk, the step without its accumulation atomics) and are only timed.

    python -m gym_soccer_tpu_torch.ops.learner_variants

prints one line per variant, shape and block size and exits 1 if a design
variant differs.  Each line gives, per board, two times, both the median of
5 legs of at least 50 ms (CUDA events): ``call``, of the wrapper as a user
calls it (its host work included), and ``device``, of the same call
captured in a CUDA graph and replayed (the memset, the prep pass and the
kernel alone); and the registers, the card's name and its power limit.

    python -m gym_soccer_tpu_torch.ops.learner_variants --sass OLD NEW

builds the learner, IQL and turn-based Q libraries of two checkouts and
compares the SASS of every kernel both builds have (a change that must
leave a kernel's code as it was shows it so).

    python gym_soccer_tpu_torch/ops/learner_variants.py --wrappers ROOT...

times, for each checkout ROOT in turn (each in a process of its own that
imports the package from there and builds its kernels there), the
committed K5, K6 and K7 multigrid wrappers at 8192 x 64 (K5 on 5x4, the
others on the 3-board mixture): call and device ms, their difference, and
``host``, the host clock's time to issue one call of 100 issued back to
back from an idle card (the wrapper's host work alone: 100 calls do not
fill the launch queue).  Give the checkouts to compare in the order
A B B A.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# The committed entries' bodies: K5, K6, K7 and K7 multigrid.
_ENTRY = {
    (True, False): """  return chunk<true, false>(device, in, nullptr, buf, table, params, n_codes,
                            B, n_steps, seed, scalars, gamma, limit, lanes,
                            stream);""",
    (True, True): """  return chunk<true, true>(device, in, geo, buf, table, params, n_codes, B,
                           n_steps, seed, scalars, gamma, limit, lanes,
                           stream);""",
    (False, False): """  return chunk<false, false>(device, in, nullptr, buf, table, params,
                             n_codes, B, n_steps, seed, scalars, gamma,
                             limit, lanes, stream);""",
    (False, True): """  return chunk<false, true>(device, in, geo, buf, table, params, n_codes, B,
                            n_steps, seed, scalars, gamma, limit, lanes,
                            stream);"""}


def _old_entry(packed: bool, multi: bool) -> str:
    """The previous design's body of an entry: one thread a lane hashing,
    sampling and stepping (learner_kernel<kPacked, kMulti>, 64 blocks of
    128 at 8192 lanes; K6's design up to its redesign), its outputs placed
    in the call's one allocation."""
    flags = f"{str(packed).lower()}, {str(multi).lower()}"
    return f"""  (void)lanes;
  (void)scalars;
  const ChunkLayout l = chunk_layout(n_codes, B);
  char* base = static_cast<char*>(buf);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(base, 0, (size_t)l.zero, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  void* out[6];
  for (int k = 0; k < 6; ++k)
    out[k] = reinterpret_cast<int32_t*>(base + l.fields) + (size_t)k * B;
  return launch<{flags}>(device, in, out, {"geo" if multi else "nullptr"}, table,
                             reinterpret_cast<long long*>(base + l.sums),
                             reinterpret_cast<int*>(base + l.cnt),
                             reinterpret_cast<long long*>(base + l.stats),
                             params, B, n_steps, seed, gamma, limit, 128,
                             stream);"""


# The rows' place: shared memory where they fit (the kernel), or L2.
_SHARED = "  const bool shared = shared_rows(n_codes, kMulti);"
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
# K7 with the whole 36-column table (q(s, a) with it) in shared memory
# beside the prepared rows where they are there (5x4: 158,976 B more, up to
# 224 lanes a block), read from there in place of L2.
_Q_SMEM = [
    ("""  const int smem = chunk_smem_bytes(lanes, shared ? n_codes : 0, kMulti);
""", """  const int smem = chunk_smem_bytes(lanes, shared ? n_codes : 0, kMulti) +
                   (shared && !kPacked ? 4 * kColsUnpacked * n_codes : 0);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
"""),
    ("""  unsigned char* ring = smem + kHead + rbytes;
""", """  const int qbytes = kShared && !kPacked ? 4 * kColsUnpacked * a.n_codes : 0;
  unsigned char* ring = smem + kHead + rbytes + qbytes;
"""),
    ("""    expect_bytes(bar, rbytes);
    bulk_copy(bar, smem + kHead, a.rows, rbytes);
""", """    expect_bytes(bar, rbytes + qbytes);
    bulk_copy(bar, smem + kHead, a.rows, rbytes);
    bulk_copy(bar, smem + kHead + rbytes, a.q - kColQ, qbytes);
"""),
    ("""      board, rows, a.q, a.sums,""",
     """      board, rows, kShared && !kPacked ? reinterpret_cast<const float*>(
          rows + 3 * a.n_codes) + kColQ : a.q, a.sums,"""),
    ("""    if constexpr (!kPacked) base = __ldg(q + (size_t)k * kColsUnpacked + ja);
""", """    if constexpr (!kPacked)
      base = kShared ? q[(size_t)k * kColsUnpacked + ja]
                     : __ldg(q + (size_t)k * kColsUnpacked + ja);
""")]

# name -> ([(text in learner_kernel.cu, its replacement)], lanes per block
# to time (None: the batch's default)); each text must occur exactly once.
VARIANTS = {
    "kernel": ([], (None, 32, 128, 256)),
    "previous-design": ([(_ENTRY[True, False], _old_entry(True, False))],
                        (None,)),
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
# K6's: "kernel" and "rows-in-l2" are VARIANTS' builds (the rows in L2
# differ from the kernel on the recipe's mixture alone).
K6_VARIANTS = {
    "kernel": ([], (None, 32, 128)),
    "k6-previous-design": ([(_ENTRY[True, True], _old_entry(True, True))],
                           (None,)),
    "rows-in-l2": VARIANTS["rows-in-l2"],
    "warp-aggregated-atomics": VARIANTS["warp-aggregated-atomics"],
    "diag-no-atomics": VARIANTS["diag-no-atomics"],
}
# K7's: "kernel" and "rows-in-l2" are VARIANTS' builds.
K7_VARIANTS = {
    "kernel": ([], (None, 32, 96, 128)),
    "k7-previous-design": ([(_ENTRY[k], _old_entry(*k))
                            for k in ((False, False), (False, True))],
                           (None,)),
    "k7-q-in-shared-memory": (_Q_SMEM, (None,)),
    "rows-in-l2": VARIANTS["rows-in-l2"],
}
SHAPES = ((8192, 64), (65536, 32))
BOARDS = ((5, 4), (11, 7))
MIX3 = ((5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3))   # tools/bench_all.py:421
MIX_BIG = ((5, 4, 0.2), (11, 7, 0.2))    # examples/train_minimax_tpu.py:141
MG_BOARDS = ((5, 4, 0.2), (6, 5, 0.2))   # its --multigrid recipe
# K6's cells: (label, boards, lanes, steps); tools/bench_all.py:333-337
# runs the packed mixture learner at 32768 lanes, the recipe at 16384.
K6_CELLS = (("mixture", MIX3, 8192, 64), ("5x4+11x7", MIX_BIG, 8192, 64),
            ("mixture", MIX3, 32768, 64), ("5x4+6x5", MG_BOARDS, 16384, 64))
SLIP = 0.2


def variant_source(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches (of VARIANTS,
    K6_VARIANTS or K7_VARIANTS) applied; ValueError if a patched text does
    not occur exactly once."""
    for old, new in {**K6_VARIANTS, **K7_VARIANTS, **VARIANTS}[name][0]:
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
    """{'K5 shared rows' ...: registers} of K5's, K6's and K7's kernels in
    an nvcc log."""
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers", log, re.S):
        k = re.search(r"chunk_kernelILb([01])ELb([01])ELb([01])E", m.group(1))
        old = re.search(r"learner_kernelILb([01])ELb([01])E", m.group(1))
        if k:
            regs[{"10": "K5 ", "11": "K6 ", "00": "K7 ",
                  "01": "K7 multigrid "}[k.group(1) + k.group(3)]
                 + ("shared rows" if k.group(2) == "1" else "rows in L2")] = \
                int(m.group(2))
        elif old:
            regs["previous " + ("K6" if old.group(1) == "1" else "K7")
                 + (" multigrid" if old.group(2) == "1" else "")] = \
                int(m.group(2))
    return regs


def _inputs(torch, lk, cfg, batch, device, seed, packed):
    """A non-uniform table (v, and q when unpacked, in [-1, 1]) made from
    a numpy seed, and the initial state: six fields, or (planes, fields)
    for a mixture."""
    import numpy as np
    nS = lk.n_states(cfg)
    rng = np.random.default_rng(seed)
    pa, pb = (torch.tensor(rng.dirichlet(np.ones(5), nS), dtype=torch.float32,
                           device=device) for _ in range(2))
    v = torch.tensor(rng.uniform(-1, 1, nS), dtype=torch.float32,
                     device=device)
    q = torch.tensor(rng.uniform(-1, 1, (nS, 5, 5)), dtype=torch.float32,
                     device=device)
    table = (lk.pack_m2(cfg, pa, pb, v, 0.2) if packed
             else lk.pack_m(cfg, pa, pb, q, v, 0.2))
    return table, lk.init_state_fields(cfg, batch, device)


def _chunk(lk, cfg, seed, table, state, batch, steps, lanes=None):
    """K5 or K6 (an 11-column table), K7 or K7 multigrid (``cfg`` a
    tuple: K6 or K7 multigrid)."""
    packed = table.shape[1] == lk.TABLE_COLS
    if isinstance(cfg, tuple):
        fn = (lk.multigrid_packed_learner_chunk if packed
              else lk.multigrid_learner_chunk)
        return fn(cfg, seed, table, *state, batch, steps, 0.99,
                  threads=lanes)
    fn = lk.packed_learner_chunk if packed else lk.learner_chunk
    return fn(cfg, seed, table, state, batch, steps, 0.99, threads=lanes)


def _to(x, dev):
    return x.to(dev) if hasattr(x, "to") else type(x)(_to(y, dev) for y in x)


def main() -> int:
    import ctypes

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
    names = list(dict.fromkeys([*VARIANTS, *K6_VARIANTS, *K7_VARIANTS]))
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: _build_variant(n, out_dir), names)))

    dev = torch.device("cuda", 0)
    cfgs = {f"{b[0]}x{b[1]}": EnvConfig(width=b[0], height=b[1],
                                        slip_prob=SLIP) for b in BOARDS}

    def flat(out):
        fields, (sums, cnt), stats = out
        return [*fields, sums, cnt, *stats]

    # (kernel, shape) -> {label: (cfg, table, state)}, timed by the variants
    # named in the dict of that kernel
    runs = {("K5", s): {k: (c, *_inputs(torch, lk, c, s[0], dev, len(k), True))
                        for k, c in cfgs.items()} for s in SHAPES}
    k7_cells = {**cfgs, "mixture": tuple(EnvConfig(*b) for b in MIX3)}
    runs["K7", SHAPES[0]] = {k: (c, *_inputs(torch, lk, c, SHAPES[0][0], dev,
                                             len(k), False))
                             for k, c in k7_cells.items()}
    k6_cells = {}
    for label, boards, lanes, steps in K6_CELLS:
        c = tuple(EnvConfig(*b) for b in boards)
        k6_cells[label] = c
        runs.setdefault(("K6", (lanes, steps)), {})[label] = (
            c, *_inputs(torch, lk, c, lanes, dev, len(label), True))
    small = {(kern, k): (c, *_inputs(torch, lk, c, 1024, "cpu", 3,
                                     kern != "K7"))
             for kern, cells in (("K5", cfgs), ("K6", k6_cells),
                                 ("K7", k7_cells))
             for k, c in cells.items()}
    cpu = {key: flat(_chunk(lk, c, 5, t, st, 1024, 16))
           for key, (c, t, st) in small.items()}
    committed = lk._library
    want, ok = {}, True
    try:
        for (kern, shape), cells in runs.items():
            table_of = {"K5": VARIANTS, "K6": K6_VARIANTS,
                        "K7": K7_VARIANTS}[kern]
            for name in table_of:
                lib = lk.declare(ctypes.CDLL(str(built[name])))
                lk._library = lambda lib=lib: lib
                lk._entry.cache_clear()
                regs = _registers(built[name].with_suffix(".log").read_text())
                diag = name.startswith("diag-")
                for lanes in table_of[name][1]:
                    ms, same = {}, []
                    for label, (c, table, state) in cells.items():
                        def fn():
                            return _chunk(lk, c, 77, table, state, *shape,
                                          lanes)
                        out = [x.cpu() for x in flat(fn())]
                        key = (kern, shape, label)
                        if name == "kernel" and lanes is None:
                            want[key] = out
                        same.append(all(torch.equal(x, y) for x, y in
                                        zip(out, want[key])))
                        sc, st, ss = small[kern, label]
                        got = flat(_chunk(lk, sc, 5, st.to(dev),
                                          _to(ss, dev), 1024, 16))
                        same.append(all(torch.equal(x.cpu(), y) for x, y in
                                        zip(got, cpu[kern, label])))
                        ms[label] = (parity_variants._time(fn),
                                     rollout_variants._device_ms(fn))
                    if not diag and not all(same):
                        ok = False
                    equal = ("diagnostic, not compared" if diag
                             else "bit-equal to the kernel and to the CPU "
                             "plain version" if all(same) else
                             "DIFFERS from the kernel or the CPU plain "
                             "version")
                    print(f"[variant] {kern} {name}, {shape[0]} x {shape[1]}, "
                          f"{lanes or 'default'} lanes per block: "
                          + ", ".join(f"{k} call {v[0]} / device {v[1]} ms"
                                      for k, v in ms.items())
                          + f"; registers {regs}; {equal} | {card}",
                          flush=True)
    finally:
        lk._library = committed
        lk._entry.cache_clear()
    return 0 if ok else 1


def wrapper_times() -> int:
    """Call, device and host ms of the K5, K6 and K7 multigrid wrappers of
    the package first on ``sys.path``, at 8192 x 64 (K5 on 5x4, the others
    on the 3-board mixture), at their default block sizes; one line each."""
    import statistics
    import time

    import torch

    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.ops import parity_variants, rollout_variants
    if not torch.cuda.is_available():
        print("learner_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    mix = tuple(EnvConfig(*b) for b in MIX3)
    c54 = EnvConfig(5, 4, SLIP)
    where = os.path.dirname(os.path.dirname(lk.__file__))
    for name, cfg, packed in (("packed_learner_chunk", c54, True),
                              ("multigrid_packed_learner_chunk", mix, True),
                              ("multigrid_learner_chunk", mix, False)):
        table, state = _inputs(torch, lk, cfg, 8192, dev, 5, packed)
        fn = getattr(lk, name)
        if isinstance(cfg, tuple):
            def call():
                return fn(cfg, 77, table, *state, 8192, 64, 0.99)
        else:
            def call():
                return fn(cfg, 77, table, state, 8192, 64, 0.99)
        ms = parity_variants._time(call)
        device = rollout_variants._device_ms(call)
        legs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                call()
            legs.append((time.perf_counter() - t0) * 10.0)
        host = statistics.median(legs)
        torch.cuda.synchronize()
        print(f"[wrapper] {name} ({where}) 8192 x 64: call {ms} / device "
              f"{device} ms, call - device {ms - device} ms, host {host} ms "
              f"a call (legs {legs}) | {card}", flush=True)
    return 0


def sass_compare(old_root: str, new_root: str) -> int:
    """Build the learner, IQL and turn-based Q libraries of two checkouts
    (each with its own ``_build``, in a process of its own) and compare
    the SASS of every kernel the two builds share, instruction by
    instruction (addresses and encodings aside); one line a library."""
    from . import _build
    names = ("learner_kernel", "iql_kernel", "altq_kernel")
    code = ("from gym_soccer_tpu_torch.ops import _build; "
            f"print(*(_build.build(n) for n in {names!r}))")
    libs = [subprocess.run([sys.executable, "-c", code], cwd=root,
                           env={**os.environ, "PYTHONPATH": root},
                           capture_output=True, text=True, check=True,
                           timeout=600).stdout.split()
            for root in (os.path.abspath(old_root), os.path.abspath(new_root))]
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    # the anonymous namespace's mangled name, which carries a build hash
    anon = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")

    def functions(path):
        listing = subprocess.run([tool, "-sass", path], capture_output=True,
                                 text=True, check=True, timeout=300).stdout
        found, name = {}, None
        for line in listing.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = anon.sub("", m.group(1))
                found.setdefault(name, [])
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
            if m and name:
                found[name].append(anon.sub("", m.group(1).strip()))
        return found

    for lib, old, new in zip(names, *libs):
        a, b = functions(old), functions(new)
        both = sorted(set(a) & set(b))
        differ = [n for n in both if a[n] != b[n]]
        print(f"[sass] {lib}: {len(both)} kernels in both builds, "
              f"{len(both) - len(differ)} with the same SASS; differing: "
              f"{differ or 'none'}; only in {new_root}: "
              f"{sorted(set(b) - set(a)) or 'none'}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sass"]:
        sys.exit(sass_compare(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--wrappers"]:
        rc = 0
        for root in sys.argv[2:]:
            root = os.path.abspath(root)
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--here"],
                cwd=root, env={**os.environ, "PYTHONPATH": root}).returncode
        sys.exit(rc)
    if sys.argv[1:2] == ["--here"]:
        sys.exit(wrapper_times())
    sys.exit(main())
