"""Time kernels S2 and S3 against their previous design and a launch's
floor on a CUDA card.

The kernels are ``csrc/mixed_alt_kernel.cu`` (no table read waits on
S3's draw and one on S2's), launched through their wrappers at
``mixed_alt_kernel.LANES_PER_BLOCK`` lanes a block, and builds of the
same source with its ``kThreads`` set to each other shape of `SHAPES`
(`build_shape`).  The previous design, ``csrc/mixed_alt_prev_kernel.cu``
(blocks of 256 lanes, the observations' and the reset's table reads after
the draws), and an empty kernel, ``csrc/launch_floor_kernel.cu``, launched
with the grid and block of each shape, are built by this module alone,
beside the port's own build.  `multigrid_step_on` / `alt_step_on` launch
a design by name (the previous design's S3 takes the board's ISD from the
card, the kernel's from the host), and the wrappers' launch counts do not
count them.  Each design runs the learners'
step (autoreset, the observations, int64 actions) on `CASES`: S3 on 5x4
at the 8192 lanes of phase 51's timing, the turn-based Q learner's 256
and ``alt_policy_rollout``'s 128; S2 at 8192 lanes on tools/bench_all's
mixture, and at the mixture check's 512 on its 5x4 + 6x4 and on the bench
mixture.  Every design's outputs must equal the plain version's
(``multigrid.step_obs_plain``, ``alt_step_obs_plain``) bit for bit; they
are checked so.

    python -m gym_soccer_tpu_torch.ops.mixed_alt_variants

prints one line per case: each design's and each floor's device ms a
call by the replay of a CUDA graph of `GRAPH_CALLS` calls, timed in
`ROUNDS` turns (every call in one order, then in the other), as the mean
and the range of the turns, and each design's time above the floor at
its shape, turn by turn; the plain version's (`PLAIN_GRAPH_CALLS` calls a
graph, once); then each library's registers, and the card's name and
power limit.  Exits 1 if a design differs.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

KERNEL_SOURCE = "mixed_alt_kernel.cu"
PREV_SOURCE = "mixed_alt_prev_kernel.cu"
FLOOR_SOURCE = "launch_floor_kernel.cu"
PREVIOUS = "previous design"
PREV_THREADS = 256   # the previous design's lanes a block (its kThreads)
SHAPES = (32, 64, 128, 256)
# The kernel source's lanes a block, which `build_shape` sets.
THREADS_LINE = "constexpr int kThreads = {};   // lanes a block"
# name -> (kernel, boards as (width, height, slip), lanes)
CASES = {"S3 5x4, 8192 lanes": ("alt_step", ((5, 4, 0.2),), 8192),
         "S3 5x4, 256 lanes (turn-based Q check)": (
             "alt_step", ((5, 4, 0.2),), 256),
         "S3 5x4, 128 lanes (alt_policy_rollout)": (
             "alt_step", ((5, 4, 0.2),), 128),
         "S2 bench mixture, 8192 lanes": (
             "multigrid_step", ((5, 4, 0.2), (6, 5, 0.1), (9, 6, 0.3)), 8192),
         "S2 5x4+6x4, 512 lanes (mixture check)": (
             "multigrid_step", ((5, 4, 0.2), (6, 4, 0.1)), 512),
         "S2 bench mixture, 512 lanes": (
             "multigrid_step", ((5, 4, 0.2), (6, 5, 0.1), (9, 6, 0.3)), 512)}
GRAPH_CALLS, PLAIN_GRAPH_CALLS = 100, 10
ROUNDS = 4
# The learners' instances (autoreset, S2's observations, int64 actions),
# as their mangled names end, and the empty kernel.
LEARNERS_INSTANCES = ("ILb1ELb1ELb1E", "alt_step_kernelILb1ELb1E",
                      "empty_kernel")


def compile_text(stem: str, text: str, folder: str = "mixed_alt_variants"):
    """``text``, a source of csrc/ (its includes pointed there), built into
    ``folder`` beside the port's build unless a build of the same text,
    headers and flags exists; its path (ops/engine_variants builds its
    designs so too)."""
    from . import _build
    out_dir = _build.BUILD_DIR / folder
    h = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + text).encode())
    for header in ("game.cuh", "threefry.cuh"):
        text = text.replace(f'#include "{header}"',
                            f'#include "{_build.CSRC / header}"')
        h.update((_build.CSRC / header).read_bytes())
    stem = f"{stem}-{h.hexdigest()[:16]}"
    out = out_dir / f"{stem}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{stem}.cu"
    src.write_text(text)
    return _build.compile_sources([src], out)


def shape_source(threads: int) -> str:
    """The kernel's source with ``threads`` lanes a block; ValueError if
    its kThreads line is not the one `THREADS_LINE` names."""
    from . import _build
    from . import mixed_alt_kernel as mk
    text = (_build.CSRC / KERNEL_SOURCE).read_text()
    line = THREADS_LINE.format(mk.LANES_PER_BLOCK)
    if text.count(line) != 1:
        raise ValueError(f"{KERNEL_SOURCE}: no line {line!r}")
    return text.replace(line, THREADS_LINE.format(threads))


def build_shape(threads: int):
    """The kernel built with ``threads`` lanes a block; its path."""
    return compile_text(f"mixed_alt_kernel-{threads}-lanes",
                        shape_source(threads))


def build_previous():
    """The previous design's library, built; its path."""
    from . import _build
    return compile_text("mixed_alt_prev_kernel",
                        (_build.CSRC / PREV_SOURCE).read_text())


def build_floor():
    """The empty kernel's library, built; its path."""
    from . import _build
    return compile_text("launch_floor_kernel",
                        (_build.CSRC / FLOOR_SOURCE).read_text())


def builders() -> list:
    """Every build this module makes, as calls: the previous design, the
    empty kernel, the kernel at each shape but the wrapper's."""
    from . import mixed_alt_kernel as mk
    return [build_previous, build_floor,
            *(functools.partial(build_shape, t) for t in SHAPES
              if t != mk.LANES_PER_BLOCK)]


@functools.lru_cache(maxsize=None)
def library(design: str):
    """A build of S2/S3 loaded and declared: `PREVIOUS`, or the kernel at
    a shape ("kernel, T lanes a block"); its lanes a block checked."""
    from . import mixed_alt_kernel as mk
    prev = design == PREVIOUS
    threads = PREV_THREADS if prev else shape_of(design)
    lib = ctypes.CDLL(str(build_previous() if prev else build_shape(threads)))
    mk.declare(lib)
    if prev:   # its S3 takes no AltReset
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        # device, ptrs, params, lanes, autoreset, act64, stream
        lib.gst_alt_step.argtypes = [i32, vp, vp, i32, i32, i32, vp]
    shape = (ctypes.c_int32 * 3)()
    lib.gst_mixed_alt_shape(ctypes.addressof(shape))
    if shape[0] != threads:
        raise RuntimeError(f"{design}: {shape[0]} lanes a block")
    return lib


def shape_of(design: str) -> int:
    """The lanes a block of "kernel, T lanes a block" or "floor, T lanes
    a block"."""
    return int(design.split(", ")[1].split()[0])


@functools.lru_cache(maxsize=None)
def _floor():
    """The empty kernel's library loaded, its launch declared."""
    lib = ctypes.CDLL(str(build_floor()))
    declare_floor(lib)
    return lib


def declare_floor(lib) -> None:
    """Declares the empty kernel's C signatures on the library ``lib``."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # device, lanes, threads, stream
    lib.gst_launch_floor.argtypes = [i32, i32, i32, vp]
    lib.gst_launch_floor.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p


def _check(lib, name, rc):
    if rc:
        raise RuntimeError(f"mixed_alt_variants {name}: launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")


def _stream(torch, dev):
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _refuse_cpu(name, dev):
    if dev.type != "cuda":
        raise ValueError(f"mixed_alt_variants {name}: no kernel for device "
                         f"{dev}")


def launch_floor(lanes: int, threads: int, dev) -> None:
    """The empty kernel over ``lanes`` lanes, ``threads`` a block, on
    ``dev``'s current stream."""
    import torch
    _refuse_cpu("empty kernel", dev)
    lib = _floor()
    _check(lib, "empty kernel", lib.gst_launch_floor(
        dev.index, lanes, threads, _stream(torch, dev)))


def _outputs(torch, dev, rows, lanes):
    return (torch.empty((rows, lanes), dtype=torch.int32, device=dev),
            torch.empty(lanes, dtype=torch.float32, device=dev),
            torch.empty((2, lanes), dtype=torch.bool, device=dev))


def multigrid_step_on(design: str, fields, key, actions_a, actions_b, geo,
                      max_steps: int, autoreset: bool, codec_maps=None):
    """``mixed_alt_kernel.multigrid_step`` on `library`'s ``design``, not
    counted: the same arguments and outputs."""
    import torch

    from . import mixed_alt_kernel as mk
    dev, lanes, (aa, ab), act64 = mk._check_lanes(
        "multigrid_step", fields, 7, key, (actions_a, actions_b))
    _refuse_cpu("multigrid_step", dev)
    obs = codec_maps is not None
    ins = [t.contiguous() for t in (*fields, key, aa, ab, *geo)]
    maps = [t.contiguous() for t in codec_maps] if obs else [None, None]
    out = _outputs(torch, dev, 9 if obs else 7, lanes)
    ptrs = [*ins, *maps, *out]
    arr = (ctypes.c_void_p * len(ptrs))(*(
        None if t is None else t.data_ptr() for t in ptrs))
    lib = library(design)
    _check(lib, "multigrid_step", lib.gst_multigrid_step(
        dev.index, ctypes.addressof(arr), lanes, int(max_steps),
        maps[0].shape[1] if obs else 0, bool(autoreset), obs, act64,
        _stream(torch, dev)))
    return out


def alt_step_on(design: str, cfg, fields, key, action, autoreset: bool):
    """``mixed_alt_kernel.alt_step`` on `library`'s ``design``, not
    counted, with the engine's tables: the previous design reads the
    board's ISD from ``batch.device_maps``, the kernel takes
    ``alt_reset_table``'s in its arguments."""
    import torch

    from ..core import batch
    from ..envs import soccer_alternating_env as alt
    from . import mixed_alt_kernel as mk
    from .engine_kernel import params
    dev, lanes, (act,), act64 = mk._check_lanes("alt_step", fields, 8, key,
                                                (action,))
    _refuse_cpu("alt_step", dev)
    prev = design == PREVIOUS
    r2d = alt.alt_device_maps(cfg, dev)
    maps = batch.device_maps(cfg, dev)
    tables = (r2d, maps.isd_fields, maps.isd_cum) if prev else (r2d,)
    ins = [t.contiguous() for t in (*fields, key, act, *tables)]
    out = _outputs(torch, dev, 10, lanes)
    ptrs = [*ins, *out]
    arr = (ctypes.c_void_p * len(ptrs))(*(t.data_ptr() for t in ptrs))
    prm = params(cfg, r2d.shape[0], maps.isd_fields.shape[0])
    reset = () if prev else (ctypes.addressof(
        mk._alt_reset(alt.alt_reset_table(cfg))),)
    lib = library(design)
    _check(lib, "alt_step", lib.gst_alt_step(
        dev.index, ctypes.addressof(arr), ctypes.addressof(prm), *reset,
        lanes, bool(autoreset), act64, _stream(torch, dev)))
    return out


def case_state(case: str, dev, seed: int = 0):
    """(step, inputs) of ``case`` on ``dev``: the case's engine state after
    8 plain steps without autoreset from ``key(seed)`` (some lanes in goal
    states) and its int64 actions from a numpy seed."""
    import numpy as np
    import torch

    from ..config import EnvConfig
    from ..core import multigrid as mg
    from ..core import threefry
    from ..envs import soccer_alternating_env as alt
    kernel, boards, lanes = CASES[case]
    cfgs = tuple(EnvConfig(*b) for b in boards)
    rng = np.random.default_rng(seed)

    def acts():
        return torch.as_tensor(rng.integers(0, 5, lanes), device=dev)

    if kernel == "alt_step":
        st = alt.alt_init(cfgs[0], threefry.key(seed), lanes, 0, dev)
        for _ in range(8):
            st, _ = alt.alt_step_plain(cfgs[0], st, acts(), autoreset=False)
        return kernel, (cfgs[0], st, acts())
    st = mg.init(cfgs, threefry.key(seed), lanes, dev)
    for _ in range(8):
        st, _ = mg.step_plain(st, acts(), acts(), autoreset=False)
    return kernel, (mg.build_codec(cfgs), st, acts(), acts())


def designs() -> list:
    """The designs `case_calls` runs besides "kernel": the kernel at each
    shape but the wrapper's, and the previous design."""
    from . import mixed_alt_kernel as mk
    return [*(f"kernel, {t} lanes a block" for t in SHAPES
              if t != mk.LANES_PER_BLOCK), PREVIOUS]


def case_calls(case: str, dev, seed: int = 0) -> dict:
    """{name: a call of the learners' observing step on ``case``}: the
    kernel through ``step_obs`` / ``alt_step_obs`` ("kernel"), each of
    `designs`, the plain version, and the empty kernel at each of `SHAPES`
    ("floor, T lanes a block", the previous design's 256 among them).
    Each call returns the step's (state, outputs, observations) but the
    floor's (None)."""
    from ..core import multigrid as mg
    from ..envs import soccer_alternating_env as alt
    kernel, ins = case_state(case, dev, seed)
    lanes = CASES[case][2]
    if kernel == "alt_step":
        cfg, st, a = ins

        def on(design):
            def call():
                ints, rew, flags = alt_step_on(design, cfg, st[:8], st.key, a,
                                               True)
                *f, o, fo = ints.unbind()
                return alt.AltEnvState(*f, st.key), (rew, *flags), (o, fo)
            return call

        calls = {"kernel": lambda: alt.alt_step_obs(cfg, st, a),
                 **{d: on(d) for d in designs()},
                 "plain": lambda: alt.alt_step_obs_plain(cfg, st, a)}
    else:
        codec, st, aa, ab = ins
        geo = st.geo
        planes = (geo.H, geo.W, geo.glo, geo.ghi, geo.vid, geo.slip)
        maps = mg._codec_on(codec.cfgs, dev)

        def on(design):
            def call():
                ints, rew, flags = multigrid_step_on(
                    design, st[:7], st.key, aa, ab, planes, geo.max_steps,
                    True, maps)
                *f, o, fo = ints.unbind()
                return (mg.MultiGridState(*f, key=st.key, geo=geo),
                        (rew, *flags), (o, fo))
            return call

        calls = {"kernel": lambda: mg.step_obs(codec, st, aa, ab),
                 **{d: on(d) for d in designs()},
                 "plain": lambda: mg.step_obs_plain(codec, st, aa, ab)}
    for t in SHAPES:
        calls[f"floor, {t} lanes a block"] = (
            lambda t=t: launch_floor(lanes, t, dev))
    return calls


def outputs(res) -> list:
    """The tensors a step computes: the new state's fields (not its key
    or geometry), the step's outputs and the observations."""
    n_fields = 8 if hasattr(res[0], "turn") else 7
    return [*res[0][:n_fields], *res[1], *res[2]]


def floor_name(design: str) -> str:
    """The floor a design's time stands above: the empty kernel at the
    design's lanes a block."""
    from . import mixed_alt_kernel as mk
    t = {"kernel": mk.LANES_PER_BLOCK, PREVIOUS: PREV_THREADS}.get(design)
    return f"floor, {t or shape_of(design)} lanes a block"


def time_in_turns(calls: dict, graph_ms, rounds: int = ROUNDS) -> dict:
    """{name: [device ms a call, one a turn]}: every call of ``calls``
    but "plain" timed by ``graph_ms(fn, GRAPH_CALLS)``, ``rounds`` times,
    in their order and then in the other, so that a design and its floor
    are timed in the same turns; "plain", the yardstick a hundred times
    slower, once after them, by ``graph_ms(fn, PLAIN_GRAPH_CALLS)``."""
    names = [name for name in calls if name != "plain"]
    turns = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            turns[name].append(graph_ms(calls[name], GRAPH_CALLS))
    if "plain" in calls:
        turns["plain"] = [graph_ms(calls["plain"], PLAIN_GRAPH_CALLS)]
    return turns


def summary(turns: dict, floor_of=floor_name) -> tuple:
    """({name: (mean, min, max) ms}, {design: (mean, min, max) ms above
    its floor ``floor_of(design)``, turn by turn}) of `time_in_turns`'s
    readings."""
    def stats(xs):
        return statistics.mean(xs), min(xs), max(xs)

    ms = {name: stats(t) for name, t in turns.items()}
    above = {name: stats([x - f for x, f in zip(t, turns[floor_of(name)])])
             for name, t in turns.items()
             if not name.startswith("floor") and name != "plain"}
    return ms, above


def registers(path) -> dict:
    """{instance: registers} of the learners' instances (and the empty
    kernel) in a build's ptxas report."""
    regs, name = {}, None
    for line in path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '\S*?((?:alt_step|"
                      r"multigrid_step|empty)_kernel\w*?)(?:EEvNS|Ev)", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and name.endswith(LEARNERS_INSTANCES):
            regs[name] = int(m.group(1))
    return regs


def main() -> int:
    import torch

    from . import _build, scatter_variants
    if not torch.cuda.is_available():
        print("mixed_alt_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    jobs = [lambda: _build.build("mixed_alt_kernel"), *builders()]
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc each
        built = list(pool.map(lambda f: f(), jobs))
    dev = torch.device("cuda", 0)
    ok = True
    for case in CASES:
        calls = case_calls(case, dev)
        want = outputs(calls["plain"]())
        same = {name: all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in zip(outputs(fn()), want))
                for name, fn in calls.items()
                if not name.startswith("floor") and name != "plain"}
        ok &= all(same.values())
        ms, above = summary(time_in_turns(calls, scatter_variants.graph_ms))
        print(f"[variant] {case}: device ms a call (mean, min, max of "
              f"{ROUNDS} turns) {ms}; above the floor at the same lanes a "
              f"block, turn by turn {above}; bit-equal to the plain "
              f"version {same} | {card}", flush=True)
    for path in built:
        print(f"[variant] {path.name}: registers {registers(path)} | {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
