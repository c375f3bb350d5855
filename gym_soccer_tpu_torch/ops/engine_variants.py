"""Time kernel S1 and T1's keyed entry against S1's previous design and a
launch's floor on a CUDA card.

The kernels are ``csrc/engine_kernel.cu`` (S1: the board's reset from the
host, one table read after the draws, the draws' two stages written around
the lane's own work) and ``csrc/threefry_kernel.cu``'s ``keyed_kernel``
(one element a thread, ``threefry_kernel.LANES_PER_BLOCK`` threads a
block), launched through their wrappers, and builds of S1's source with
its ``kThreads`` set to each other shape of `SHAPES` (`build_shape`).
S1's previous design, ``csrc/engine_prev_kernel.cu`` (blocks of 256 lanes,
the reset's thresholds, entry and observation read from the card after the
draws), and the empty kernel of ``mixed_alt_variants``
(``csrc/launch_floor_kernel.cu``), launched with the grid and block of
each design, are built by this module alone, beside the port's own build.
`engine_step_on` launches an S1 design by name, and the wrapper's launch
count does not count it.

Each design runs S1's step (5x4 slip 0.2, autoreset, int64 actions) or the
keyed uniform draw on `CASES`: S1 at the entry point's 8192 lanes
(threefry), the best-response gate's ``greedy_win_share`` 2048 (counter
rng), ``eval_episode_stats``' 1024 and the learning checks' 512
(threefry); the keyed entry at the evaluation's 2 x 1024 and at 2 x 8192.
Every design's outputs must equal the plain version's
(``batch.step_plain``, ``keyed_uniform_plain``) bit for bit; they are
checked so.

    python -m gym_soccer_tpu_torch.ops.engine_variants

prints one line per case: each design's and each floor's device ms a call
by the replay of a CUDA graph, timed in four turns (every call in one
order, then in the other: ``mixed_alt_variants.time_in_turns``), as the
mean and the range of the turns, and each design's time above the floor
at its own launch shape, turn by turn; the plain version's once; then
each build's registers, and the card's name and power limit.  Exits 1 if
a design differs.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import ctypes
import functools
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from . import mixed_alt_variants as mv

KERNEL_SOURCE = "engine_kernel.cu"
PREV_SOURCE = "engine_prev_kernel.cu"
FOLDER = "engine_variants"
PREVIOUS = "previous design"
PREV_THREADS = 256   # the previous design's lanes a block
SHAPES = (32, 64, 128, 256)   # S1's lanes a block
# The line `build_shape` sets.
THREADS_LINE = "constexpr int kThreads = {};   // lanes a block"
# name -> ("engine_step", rng, lanes) or ("keyed", None, shape)
CASES = {"S1 8192 lanes, threefry (entry point)": (
             "engine_step", "threefry", 8192),
         "S1 2048 lanes, counter (greedy_win_share)": (
             "engine_step", "counter", 2048),
         "S1 1024 lanes, threefry (eval_episode_stats)": (
             "engine_step", "threefry", 1024),
         "S1 512 lanes, threefry (learning checks)": (
             "engine_step", "threefry", 512),
         "keyed 2 x 1024 (evaluation draw)": ("keyed", None, (2, 1024)),
         "keyed 2 x 8192": ("keyed", None, (2, 8192))}
BOARD = (5, 4, 0.2)
KEYED_INDEX = 399   # the evaluation's last draw
# The instances whose registers `registers` reports: S1's threefry and
# counter steps (autoreset, int64 actions) and the keyed entry's two.
INSTANCES = ("engine_step_kernelILi0ELb1ELb1E",
             "engine_step_kernelILi1ELb1ELb1E", "keyed_kernelILb0E",
             "keyed_kernelILb1E")


def _source(name: str):
    from . import _build
    return (_build.CSRC / name).read_text()


def shape_source(threads: int) -> str:
    """S1's source with ``threads`` lanes a block; ValueError if its
    kThreads line is not the one `THREADS_LINE` names."""
    from . import engine_kernel as ek
    have = THREADS_LINE.format(ek.LANES_PER_BLOCK)
    text = _source(KERNEL_SOURCE)
    if text.count(have) != 1:
        raise ValueError(f"{KERNEL_SOURCE}: no line {have!r}")
    return text.replace(have, THREADS_LINE.format(threads))


def build_shape(threads: int):
    """S1 built with ``threads`` lanes a block; its path."""
    return mv.compile_text(f"engine_kernel-{threads}-lanes",
                           shape_source(threads), FOLDER)


def build_previous():
    """S1's previous design, built; its path."""
    return mv.compile_text("engine_prev_kernel", _source(PREV_SOURCE), FOLDER)


def builders() -> list:
    """Every build this module makes, as calls: S1's previous design, the
    empty kernel, S1 at each shape but the wrapper's."""
    from . import engine_kernel as ek
    return [build_previous, mv.build_floor,
            *(functools.partial(build_shape, t) for t in SHAPES
              if t != ek.LANES_PER_BLOCK)]


def designs() -> list:
    """S1's designs besides "kernel": each other shape, the previous one."""
    from . import engine_kernel as ek
    return [*(f"kernel, {t} lanes a block" for t in SHAPES
              if t != ek.LANES_PER_BLOCK), PREVIOUS]


def threads_of(design: str) -> int:
    """The threads a block of a design: "kernel", "keyed", `PREVIOUS`, or
    one named by `designs`."""
    from . import engine_kernel as ek
    from . import threefry_kernel as tk
    fixed = {"kernel": ek.LANES_PER_BLOCK, PREVIOUS: PREV_THREADS,
             "keyed": tk.LANES_PER_BLOCK}
    if design in fixed:
        return fixed[design]
    return int(re.search(r"\d+", design).group())


def floor_name(design: str) -> str:
    """The floor a design's time stands above: the empty kernel at the
    design's threads a block."""
    return f"floor, {threads_of(design)} threads a block"


@functools.lru_cache(maxsize=None)
def library(design: str):
    """A build of S1 loaded and declared: `PREVIOUS`, or the kernel at a
    shape ("kernel, T lanes a block"); its lanes a block checked."""
    from . import engine_kernel as ek
    threads = threads_of(design)
    if design == PREVIOUS:
        lib = ctypes.CDLL(str(build_previous()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        # device, ptrs, params, lanes, rng, autoreset, act64, stream
        lib.gst_engine_step.argtypes = [i32, vp, vp, i32, i32, i32, i32, vp]
        lib.gst_engine_step.restype = i32
        lib.gst_engine_shape.argtypes = [vp]
        lib.gst_error_string.argtypes = [i32]
        lib.gst_error_string.restype = ctypes.c_char_p
    else:
        lib = ctypes.CDLL(str(build_shape(threads)))
        ek.declare(lib)
    shape = (ctypes.c_int32 * 3)()
    lib.gst_engine_shape(ctypes.addressof(shape))
    if shape[0] != threads:
        raise RuntimeError(f"{design}: {shape[0]} lanes a block")
    return lib


def engine_step_on(design: str, cfg, state, actions_a, actions_b,
                   autoreset: bool, rng: str):
    """``batch.step`` on `library`'s ``design``, not counted: the same
    arguments and outputs.  The previous design reads the board's ISD from
    ``batch.device_maps``, the kernel takes ``batch.reset_table``'s in its
    arguments."""
    from ..core import batch
    from . import engine_kernel as ek
    maps = batch.device_maps(cfg, state.key.device)
    dev, lanes, ins, act64 = ek.check_step(cfg, state[:7], state.key,
                                           actions_a, actions_b,
                                           maps.raw_to_dense, rng)
    out = ek.outputs(lanes, dev)
    if lanes:
        prm, rst = ek.board_args(cfg, maps.raw_to_dense.shape[0])
        if design == PREVIOUS:
            ptrs = (*ins, maps.raw_to_dense, maps.isd_fields, maps.isd_cum,
                    *out)
            args = (ctypes.addressof(prm),)
        else:
            ptrs = (*ins, maps.raw_to_dense, *out)
            args = (ctypes.addressof(prm), ctypes.addressof(rst))
        ek.launch(library(design), dev, ptrs, *args, lanes, ek.RNG_IDS[rng],
                  bool(autoreset), act64)
    return batch.step_result(state, *out)


def case_state(case: str, dev, seed: int = 0):
    """The inputs of ``case`` on ``dev``.  S1: (cfg, state, actions_a,
    actions_b), the state after 8 plain steps without autoreset from
    random key words (some lanes in goal states), every 5th counter at
    2**31 - 3 and every 7th clock one step from truncation, int64 actions
    from a numpy seed.  Keyed: (key, i, shape)."""
    import numpy as np
    import torch

    from ..config import EnvConfig
    from ..core import batch, threefry
    kind, rng, size = CASES[case]
    if kind == "keyed":
        return threefry.key(5 + seed, dev), KEYED_INDEX, size
    cfg = EnvConfig(*BOARD)
    gen = np.random.default_rng(seed)

    def acts():
        return torch.as_tensor(gen.integers(0, 5, size), device=dev)

    words = gen.integers(0, 2 ** 32, (size, 2), dtype=np.uint64)
    st = batch.init_from_keys(cfg, words, dev, rng=rng)
    for _ in range(8):
        st, _ = batch.step_plain(cfg, st, acts(), acts(), autoreset=False,
                                 rng=rng)
    n, t = st.n.clone(), st.t.clone()
    n[::5] = 2 ** 31 - 3
    t[1::7] = cfg.max_steps - 1
    return cfg, st._replace(n=n, t=t), acts(), acts()


def case_calls(case: str, dev, seed: int = 0) -> dict:
    """{name: a call on ``case``}: the kernel through its wrapper
    ("kernel": ``batch.step``; "keyed": ``keyed_uniform``), each other S1
    design, the plain version, and the empty kernel at each design's
    launch shape (`floor_name`).  Each call returns the step's (state,
    StepOut) or the draw, but the floors' (None)."""
    from ..core import batch
    from . import threefry_kernel as tk
    kind, rng, size = CASES[case]
    ins = case_state(case, dev, seed)
    if kind == "keyed":
        key, i, shape = ins
        numel = shape[0] * shape[1]
        calls = {"keyed": lambda: tk.keyed_uniform(key, i, shape),
                 "plain": lambda: tk.keyed_uniform_plain(key, i, shape)}
    else:
        cfg, st, aa, ab = ins
        numel = size
        calls = {"kernel": lambda: batch.step(cfg, st, aa, ab, True, rng),
                 **{d: functools.partial(engine_step_on, d, cfg, st, aa, ab,
                                         True, rng) for d in designs()},
                 "plain": lambda: batch.step_plain(cfg, st, aa, ab, True,
                                                   rng)}
    for name in [n for n in calls if n != "plain"]:
        calls.setdefault(floor_name(name), functools.partial(
            mv.launch_floor, numel, threads_of(name), dev))
    return calls


def outputs(res) -> list:
    """The tensors a design computes: a step's new state fields (not its
    key) and its StepOut, or a draw."""
    if isinstance(res, tuple):
        return [*res[0][:7], *res[1]]
    return [res]


def registers(path) -> dict:
    """{instance: registers} of `INSTANCES` in a build's ptxas report."""
    regs, name = {}, None
    for line in path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((i for i in INSTANCES if i in m.group(1)), None)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def main() -> int:
    import torch

    from . import _build, scatter_variants
    if not torch.cuda.is_available():
        print("engine_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    jobs = [lambda: _build.build("engine_kernel"),
            lambda: _build.build("threefry_kernel"), *builders()]
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc each
        built = list(pool.map(lambda f: f(), jobs))
    dev = torch.device("cuda", 0)
    ok = True
    for case in CASES:
        calls = case_calls(case, dev)
        want = outputs(calls["plain"]())
        same = {name: all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in zip(outputs(fn()), want, strict=True))
                for name, fn in calls.items()
                if not name.startswith("floor") and name != "plain"}
        ok &= all(same.values())
        ms, above = mv.summary(
            mv.time_in_turns(calls, scatter_variants.graph_ms), floor_name)
        print(f"[variant] {case}: device ms a call (mean, min, max of "
              f"{mv.ROUNDS} turns) {ms}; above the floor at the same launch "
              f"shape, turn by turn {above}; bit-equal to the plain version "
              f"{same} | {card}", flush=True)
    for path in built:
        print(f"[variant] {path.name}: registers {registers(path)} | {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
