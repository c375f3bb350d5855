"""Time variants of the lane-order scatter-add kernel A1 on a CUDA card.

Each variant is a source of ``csrc/`` with a few text patches
(`VARIANTS`): the kernel, ``csrc/scatter_kernel.cu`` (the cells cut into
ranges, one a block; each block keeps its range's lanes in lane order and
a thread a cell adds them); the previous design,
``csrc/scatter_walk_kernel.cu`` (each cell's count and first lane by
integer atomics, then the warp of each cell's first lane walks the lanes
from there); and a design measured and not kept,
``csrc/scatter_sort_kernel.cu`` (one block orders each tile of lanes by
cell with a stable radix sort in shared memory, then adds each cell's
run), which only this module builds.  Each is built beside the port's
own build and launched as ``ops.scatter_kernel.scatter_add`` launches the
kernel (after a zero fill where the design needs one), on `CASES`: 65536
lanes on one cell, 8192 over the 5x4 minimax table's 19025 cells, 8192
over 3 cells, and the cells and TDs of the port's ``minimax_train`` at
the entry point's recipe (`LEARNER_RECIPE`) at its steps 1 and 64,
captured from a run on the CPU (``learner_inputs``).  Every design
variant must equal the plain version (``index_add_`` on the CPU) bit for
bit, sums and counts; they are checked so.  ``diag-`` variants break the
result on purpose to show what one part of a call costs (the kernel's
ordering of a tile's many kept lanes by cell alone; its additions with
no loads; each warp's cycles in its ordering and adding steps; the sort design's loads alone, its sort
without the runs, its runs without their stores, one radix pass) and are
only timed.

    python -m gym_soccer_tpu_torch.ops.scatter_variants

prints one line per variant: for each case the ms per call (median of 5
legs of at least 50 ms, CUDA events) and the device ms a call by the
replay of a CUDA graph of `GRAPH_CALLS` calls; its registers; the card's
name and power limit.  Exits 1 if a design variant differs.  Needs
``nvcc`` and a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

KERNEL_SOURCE = "scatter_kernel.cu"
WALK_SOURCE = "scatter_walk_kernel.cu"
SORT_SOURCE = "scatter_sort_kernel.cu"
PREVIOUS = "walk from each cell's first lane (previous design)"
CYCLES = "diag-cycles of each warp's ordering and adding steps"
SORTED = "one block, a stable radix sort by cell"
# Each design's output: rows of its [rows, n] output (the sums, the counts
# and, for the walk, each cell's first lane), and whether the launcher
# zero-fills it first (the kernel writes every cell).
OUTPUT = {KERNEL_SOURCE: (2, False), WALK_SOURCE: (3, True),
          SORT_SOURCE: (2, True)}

_BLOCKS = ("constexpr int kBlocks = 132;               "
           "// the card's SMs: blocks aimed at")
_ADD = ("      add_run(sorted + s0, len, acc);")
_SORT_WARPS = ("constexpr int kMaxWarps = 32;              "
               "// warps of the block at most")
_RUNS = ("    // 2. Each thread adds the runs whose first item lies in its 8 "
         "places,")
_SORT = "    uint64_t* src = buf1;"
_STORE = ("  sums[c] = acc;\n"
          "  counts[c] = __fadd_rn(had, (float)len);")
_PASSES = ("  s.passes = bits > kDigitBits ? (bits + kDigitBits - 1) / "
           "kDigitBits : 1;")

# name -> (source in csrc/, [(text in it, its replacement)]); each text
# must occur exactly once.
VARIANTS = {
    "kernel": (KERNEL_SOURCE, []),
    PREVIOUS: (WALK_SOURCE, []),
    SORTED: (SORT_SOURCE, []),
    # ranges of about n / 264 and n / 66 cells: more, smaller blocks or
    # fewer, larger ones
    "264 blocks aimed at": (KERNEL_SOURCE, [
        (_BLOCKS, "constexpr int kBlocks = 264;")]),
    "66 blocks aimed at": (KERNEL_SOURCE, [
        (_BLOCKS, "constexpr int kBlocks = 66;")]),
    # the sort design in smaller tiles: a block of 512 or 256 threads
    SORTED + ", 4096 lanes a tile": (SORT_SOURCE, [
        (_SORT_WARPS, "constexpr int kMaxWarps = 16;")]),
    SORTED + ", 2048 lanes a tile": (SORT_SOURCE, [
        (_SORT_WARPS, "constexpr int kMaxWarps = 8;")]),
    # diagnostics: wrong results, by design, to show what a part costs
    # a tile's many kept lanes ordered by cell in shared memory, none added
    "diag-ordered only": (KERNEL_SOURCE, [
        (_ADD, "      if (lanes < 0) add_run(sorted + s0, len, acc);")]),
    # each run's additions with no loads (a tile of many kept lanes): the
    # chain of additions alone
    "diag-additions alone": (KERNEL_SOURCE, [
        ("    for (int u = 0; u < 8; ++u) b[u] = run[j + 8 + u];",
         "    for (int u = 0; u < 8; ++u) b[u] = a[(u + 1) & 7];")]),
    # where tile 0 keeps many lanes, each warp's cycles in its ordering
    # (from the tile's start to its runs placed) and adding steps, written
    # over its range's first sums and counts after the results (read by
    # ``cycles_report``)
    CYCLES: (KERNEL_SOURCE, [
        ("  float acc = 0.0f;\n  int cnt = 0;\n",
         "  float acc = 0.0f;\n  int cnt = 0;\n"
         "  long long ordering = 0, adding = 0, c0 = 0;\n"),
        ("    for (int c = lane; c < cells; c += 32) tab[c * stride + w] = 0u;\n",
         "    c0 = clock64();\n"
         "    for (int c = lane; c < cells; c += 32) tab[c * stride + w] = 0u;\n"),
        ("    if (t < cells) {\n", "    if (base == 0) ordering = clock64() - c0;\n"
         "    c0 = clock64();\n    if (t < cells) {\n"),
        ("    __syncthreads();   // the runs read before the next tile's are "
         "placed\n",
         "    if (base == 0) adding = clock64() - c0;\n"
         "    __syncthreads();   // the runs read before the next tile's are "
         "placed\n"),
        ("    counts[lo + t] = (float)cnt;\n  }\n",
         "    counts[lo + t] = (float)cnt;\n  }\n  __syncthreads();\n"
         "  if (lane == 0 && lo + w < hi) {\n"
         "    sums[lo + w] = (float)ordering;\n"
         "    counts[lo + w] = (float)adding;\n  }\n")]),
    # the sort design's loads alone (no sort, no runs)
    "diag-sort design, loads only": (SORT_SOURCE, [
        (_SORT, "    {\n      uint64_t s = 0;\n"
                "      for (int r = 0; r < kItems; ++r) s ^= item[r];"
                "\n      if (s == 12345u) sums[0] = 1.0f;\n    }\n"
                "    continue;\n" + _SORT)]),
    # its loads and sort, no runs added
    "diag-sort design, sort only": (SORT_SOURCE, [
        (_RUNS, "    if (t == 0) sums[0] = value_of(src[0]);"
                "\n    __syncthreads();\n    continue;\n" + _RUNS)]),
    # its runs added and not stored
    "diag-sort design, no stores": (SORT_SOURCE, [
        (_STORE, "  if (acc == 1234.5f && len == 77) sums[c] = had;")]),
    # one radix pass whatever the cells
    "diag-sort design, one pass": (SORT_SOURCE, [
        (_PASSES, "  s.passes = 1;")]),
}
# name -> (lanes, cells, cells hit): a number of cells, None for uniform
# over the cells, or LEARNER for the learner's own step (LEARNER_STEPS).
LEARNER = "learner"
CASES = {"one cell": (65536, 19025, 1),
         "minimax table": (8192, 19025, None),
         "3 cells": (8192, 3, 3),
         "learner step 1": (8192, 19025, LEARNER),
         "learner step 64": (8192, 19025, LEARNER)}
LEARNER_STEPS = {"learner step 1": 1, "learner step 64": 64}
# Cases checked and not timed: "tiles", TILE_CASE's lanes uniform over its
# cells but for one cell on both sides of every multiple of TILE (the
# kernel's largest tile) and another on the lanes RUN_LANES (longer than a
# tile), bar those; and "one lane".
TILE, TILE_CASE, RUN_LANES = 8192, (65536, 19025), (10000, 30001)
EDGE_CELL, RUN_CELL = 7, 11
# The values' magnitudes span 10**MAGNITUDES, with random signs.
MAGNITUDES = (-6, 2)
# The entry point's learner (examples/train_minimax.py at its defaults:
# 8192 envs, 2000 steps, threefry.key(0)) on the 5x4 board, slip 0.2.
LEARNER_RECIPE = dict(lr=0.3, eps=0.3, resolve_every=64, solver_iters=200,
                      lr_halflife=2000 // 5, eps_halflife=2000 // 3)
GRAPH_CALLS = 100


def crafted_inputs(np, lanes: int, n_cells: int, hit, seed: int = 0):
    """(idx int64 [lanes], values float32 [lanes]): ``lanes`` lanes over
    ``hit`` cells of ``n_cells`` drawn at random (uniform over all of them
    when ``hit`` is None), values of magnitudes 10**MAGNITUDES with random
    signs; from ``seed``."""
    rng = np.random.default_rng(seed)
    if hit is None:
        idx = rng.integers(0, n_cells, lanes)
    else:
        idx = rng.choice(n_cells, hit, replace=False)[
            rng.integers(0, hit, lanes)]
    mag = 10.0 ** rng.uniform(*MAGNITUDES, lanes)
    values = (mag * rng.choice((-1.0, 1.0), lanes)).astype(np.float32)
    return idx.astype(np.int64), values


@functools.lru_cache(maxsize=None)
def learner_inputs(lanes: int = 8192, steps: tuple = (1, 64)) -> dict:
    """{step: (idx int64 [lanes], values float32 [lanes], n_cells)}: the
    cells and TDs the port's ``minimax_train`` hands ``scatter_add`` at
    each of ``steps``, on the CPU, at the entry point's recipe
    (`LEARNER_RECIPE`, 5x4, slip 0.2, ``threefry.key(0)``)."""
    import torch

    from ..agents import learners
    from ..config import EnvConfig
    from ..core import threefry
    from . import scatter_kernel
    cfg = EnvConfig(5, 4, 0.2)
    state = learners.minimax_init(cfg, threefry.key(0), lanes,
                                  torch.device("cpu"))
    seen = []
    committed = scatter_kernel.scatter_add

    def capture(idx, values, n_cells):
        seen.append((idx.numpy().copy(), values.numpy().copy(), n_cells))
        return committed(idx, values, n_cells)

    scatter_kernel.scatter_add = capture
    try:
        learners.minimax_train(cfg, learners.MinimaxQConfig(**LEARNER_RECIPE),
                               state, max(steps) + 1)
    finally:
        scatter_kernel.scatter_add = committed
    return {s: seen[s] for s in steps}


def case_inputs(np, case: str, seed: int = 0):
    """(idx, values, n_cells) of ``case``: one of `CASES`, "tiles" or
    "one lane"."""
    if case == "tiles":
        lanes, n_cells = TILE_CASE
        idx, values = crafted_inputs(np, lanes, n_cells, None, seed)
        idx[slice(*RUN_LANES)] = RUN_CELL
        edges = np.arange(TILE, lanes, TILE)
        idx[np.concatenate([edges - 1, edges])] = EDGE_CELL
        return idx, values, n_cells
    if case == "one lane":
        return (*crafted_inputs(np, 1, 19025, 1, seed), 19025)
    lanes, n_cells, hit = CASES[case]
    if hit == LEARNER:
        idx, values, n = learner_inputs(lanes)[LEARNER_STEPS[case]]
        return idx.copy(), values.copy(), n
    return (*crafted_inputs(np, lanes, n_cells, hit, seed), n_cells)


def variant_source(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches applied; ValueError if a
    patched text does not occur exactly once."""
    for old, new in VARIANTS[name][1]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: its patch matches "
                             f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def build_variant(name: str):
    """Compile variant ``name`` beside the port's build, unless a build of
    the same source and flags exists; its path."""
    from . import _build
    out_dir = _build.BUILD_DIR / "scatter_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = variant_source(name, (_build.CSRC / VARIANTS[name][0]).read_text())
    digest = hashlib.sha256(
        (" ".join(_build.NVCC_FLAGS) + text).encode()).hexdigest()[:16]
    stem = "scatter_kernel-" + re.sub(r"\W+", "-", name).strip("-")
    out = out_dir / f"{stem}-{digest}.so"
    if out.exists():
        return out
    src = out_dir / f"{stem}-{digest}.cu"
    src.write_text(text)
    return _build.compile_sources([src], out)


@functools.lru_cache(maxsize=None)
def load(name: str):
    """Variant ``name`` built and loaded, its launch declared."""
    lib = ctypes.CDLL(str(build_variant(name)))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gst_scatter_add.argtypes = [i32, vp, vp, i32, i64, vp, vp]
    lib.gst_scatter_add.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


def scatter_add(name: str, idx, values, n_cells: int):
    """(sums, counts) of variant ``name`` on CUDA tensors, launched as the
    wrapper launches the kernel, after a zero fill where the design needs
    one (not counted in the wrapper's launches)."""
    import torch
    lib = load(name)
    dev = idx.device
    rows, fill = OUTPUT[VARIANTS[name][0]]
    out = (torch.zeros if fill else torch.empty)(
        (rows, n_cells), dtype=torch.float32, device=dev)
    rc = lib.gst_scatter_add(
        dev.index, idx.data_ptr(), values.data_ptr(), idx.shape[0], n_cells,
        out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"scatter_variants {name}: launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    return out[0], out[1]


def graph_ms(fn, calls: int = GRAPH_CALLS) -> float:
    """Device ms a call of ``fn``: a CUDA graph of ``calls`` calls, its
    replays timed (``parity_variants._time``)."""
    import torch

    from . import parity_variants
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return parity_variants._time(graph.replay) / calls


def main() -> int:
    import numpy as np
    import torch

    from . import parity_variants
    from . import scatter_kernel as sc

    if not torch.cuda.is_available():
        print("scatter_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    dev = torch.device("cuda", 0)
    inputs = {}
    for case in CASES:
        idx, v, n = case_inputs(np, case)
        want = sc.scatter_add_plain(torch.from_numpy(idx),
                                    torch.from_numpy(v), n)
        inputs[case] = (torch.from_numpy(idx).to(dev),
                        torch.from_numpy(v).to(dev), n, want)
    ok = True
    for name, path in built.items():
        regs = re.findall(r"Used (\d+) registers",
                          path.with_suffix(".log").read_text())
        timed, same = [], []
        for case, (gi, gv, n, want) in inputs.items():
            got = scatter_add(name, gi, gv, n)
            same.append(all(torch.equal(a.cpu().view(torch.int32),
                                        b.view(torch.int32))
                            for a, b in zip(got, want)))

            def call(gi=gi, gv=gv, n=n):
                scatter_add(name, gi, gv, n)
            timed.append(f"{case} {parity_variants._time(call)} ms/call, "
                         f"device {graph_ms(call)} ms")
        diag = name.startswith("diag-")
        ok &= diag or all(same)
        equal = ("diagnostic, not compared" if diag else
                 "bit-equal to the plain version" if all(same) else
                 "DIFFERS from the plain version")
        print(f"[variant] A1 {name}: " + "; ".join(timed)
              + f"; registers {regs}; {equal} | {card}", flush=True)
    cycles_report(inputs, card)
    return 0 if ok else 1


def cycles_report(inputs, card) -> None:
    """Each warp's clock64 cycles in tile 0's ordering and adding steps
    of the block that keeps the most lanes, by the CYCLES diagnostic, on
    the cases whose tile 0 keeps many lanes there (ordered by cell), with
    the cycles a kept lane of the busiest warp's adding step."""
    import numpy as np

    from . import scatter_kernel as sc
    for case in ("one cell", "3 cells"):
        gi, gv, n, _ = inputs[case]
        idx = gi.cpu().numpy()
        shape = sc.launch_shape(len(idx), n)
        per = shape["cells"]
        block = int(np.bincount(idx // per).argmax())
        lo, hi = block * per, min(block * per + per, n)
        head = idx[:shape["tile"]]
        kept = int(((head >= lo) & (head < hi)).sum())
        sums, counts = (x.cpu().numpy() for x in scatter_add(CYCLES, gi, gv,
                                                             n))
        warps = min(shape["threads"] // 32, hi - lo)
        ordering, adding = sums[lo:lo + warps], counts[lo:lo + warps]
        print(f"[cycles] A1 {case}: block {block} keeps {kept} of tile 0's "
              f"lanes; each warp's clock64 cycles ordering them "
              f"{ordering.tolist()} and adding its runs {adding.tolist()}; "
              f"the busiest adds {adding.max() / max(kept, 1)} cycles a "
              f"kept lane | {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
