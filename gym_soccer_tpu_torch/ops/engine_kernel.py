"""The batched engine's step on the card: CUDA kernel S1.

``core/batch.step`` on CUDA tensors calls ``engine_step``, which launches
S1 (``csrc/engine_kernel.cu``: one thread a lane, `LANES_PER_BLOCK` lanes
a block, the transition's and the reset's draws inside it, threefry from
``csrc/threefry.cuh`` or the counter hash) and returns the new state's
and the ``StepOut``'s tensors.  Its plain version is
``core/batch.step_plain``, which is what ``batch.step`` runs on CPU
tensors; there is no fallback from one to the other.  The host constants
here are the board's geometry and the slip's float32 thresholds, computed
once a configuration, and the board's ISD with each entry's observation
(``batch.reset_table``, as `EngineReset`), which ride in the launch's
arguments; the one table the kernel reads, ``raw_to_dense``, is
``batch.device_maps``', cached once a device.

The launch reads nothing back to the host, allocates its outputs with
torch and runs on the current stream, so a CUDA graph can capture it
(the HBM-table learners' replays, ``ops/dispatch.run``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..config import EnvConfig

# Launches of S1 in this process, counted by the wrapper where it launches
# and nowhere else.
launch_counts = {"engine_step": 0}

RNG_IDS = {"threefry": 0, "counter": 1}
N_PTRS = 14
# The lanes a block (csrc/engine_kernel.cu kThreads): the fastest build at
# the entry point's 8192 lanes (ops/engine_variants, phase 52 of
# chip_smoke.py).
LANES_PER_BLOCK = 32
MAX_ISD = 4   # game.cuh kMaxIsd


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class EngineParams(ctypes.Structure):
    """csrc/engine_kernel.cu's ``Params``, field for field."""
    _fields_ = [("H", ctypes.c_int), ("W", ctypes.c_int),
                ("glo", ctypes.c_int), ("ghi", ctypes.c_int),
                ("max_steps", ctypes.c_int), ("n_raw", ctypes.c_int),
                ("nI", ctypes.c_int), ("keep", ctypes.c_float),
                ("first", ctypes.c_float), ("slip", ctypes.c_float)]


class EngineReset(ctypes.Structure):
    """csrc/engine_kernel.cu's ``Reset`` (and csrc/mixed_alt_kernel.cu's
    ``AltReset``), field for field: a board's ISD entries, their
    cumulative thresholds (+inf past the last) and their observations."""
    _fields_ = [("isd", (ctypes.c_int * 5) * MAX_ISD),
                ("cum", ctypes.c_float * MAX_ISD),
                ("obs", ctypes.c_int * MAX_ISD)]


@functools.lru_cache(maxsize=None)
def reset_struct(table, name: str = "engine_step") -> EngineReset:
    """``table`` (``batch.reset_table`` or ``alt_reset_table``: fields,
    thresholds, observations) as the kernels' `EngineReset`, its thresholds
    past the last entry +inf; ValueError (naming the caller ``name``)
    unless it holds 1 to MAX_ISD entries of five fields, a threshold and an
    observation each."""
    fields, cum, obs = table
    n = len(fields)
    if not 1 <= n <= MAX_ISD or len(cum) != n or len(obs) != n or any(
            len(f) != 5 for f in fields):
        raise ValueError(f"{name}: 1 to {MAX_ISD} ISD entries of five "
                         "fields, a threshold and an observation each")
    rst = EngineReset()
    for k in range(MAX_ISD):
        rst.cum[k] = cum[k] if k < n else math.inf
        if k < n:
            rst.isd[k][:] = fields[k]
            rst.obs[k] = obs[k]
    return rst


def slip_constants(q: float) -> tuple[float, float, float]:
    """The float32 values ``batch.step_plain`` compares and multiplies
    with: ``f32(1 - q)`` (the intended move's threshold and probability),
    ``f32(1 - q / 2)`` (the first orthogonal slip's threshold) and
    ``f32(q / 2)`` (an orthogonal slip's probability), each rounded once
    from the float64 value as JAX rounds a weak-typed scalar."""
    return tuple(float(np.float32(v)) for v in (1.0 - q, 1.0 - q * 0.5,
                                                q * 0.5))


@functools.lru_cache(maxsize=None)
def params(cfg: EnvConfig, n_raw: int, n_isd: int) -> EngineParams:
    """The kernel's constants of ``cfg`` (its maps' sizes given)."""
    lo, hi = cfg.goal_row_bounds
    return EngineParams(cfg.H, cfg.W, lo, hi, cfg.max_steps, n_raw, n_isd,
                        *slip_constants(cfg.slip_prob))


def engine_step(cfg: EnvConfig, fields, key: torch.Tensor,
                actions_a: torch.Tensor, actions_b: torch.Tensor, maps,
                autoreset: bool, rng: str):
    """One step of every lane by S1.

    ``fields``: the seven int32 [B] state fields (rows_a, cols_a, rows_b,
    cols_b, poss, t, n); ``key``: int64 [B, 2]; the actions: integer [B]
    (int32 and int64 are read as they are, other types cast to int32 first);
    ``maps``: ``batch.device_maps(cfg, device)``, of which the kernel reads
    ``raw_to_dense``; the board's ISD comes from ``batch.reset_table(cfg)``
    in the launch's arguments.  Returns (int32 [9, B]: the new rows_a,
    cols_a, rows_b, cols_b, poss, t, n, then obs and final_obs; float32
    [2, B]: reward_a, prob; bool [2, B]: done, truncated)."""
    dev, lanes, ins, act64 = check_step(cfg, fields, key, actions_a,
                                        actions_b, maps.raw_to_dense, rng)
    out = outputs(lanes, dev)
    if lanes:
        prm, rst = board_args(cfg, maps.raw_to_dense.shape[0])
        launch(_library(), dev, (*ins, maps.raw_to_dense.contiguous(), *out),
               ctypes.addressof(prm), ctypes.addressof(rst), lanes,
               RNG_IDS[rng], bool(autoreset), act64)
        launch_counts["engine_step"] += 1
    return out


@functools.lru_cache(maxsize=None)
def board_args(cfg: EnvConfig, n_raw: int) -> tuple[EngineParams,
                                                    EngineReset]:
    """S1's `EngineParams` and `EngineReset` of ``cfg`` (``n_raw`` its
    ``raw_to_dense``'s size), once a configuration: the board's ISD, its
    size too, from ``batch.reset_table(cfg)`` alone."""
    from ..core import batch
    table = batch.reset_table(cfg)
    return params(cfg, n_raw, len(table.fields)), reset_struct(table)


def check_step(cfg: EnvConfig, fields, key, actions_a, actions_b,
               raw_to_dense, rng: str):
    """The checks every S1 launcher makes: (device, lanes, the inputs as
    the kernel reads them (the seven fields, the key words, the two action
    arrays, each contiguous), whether the actions are int64); ValueError
    where the tensors are not on a CUDA device or not what the kernel
    takes."""
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"engine_step: no kernel for device {dev}")
    if rng not in RNG_IDS:
        raise ValueError(f"unknown rng mode {rng!r} "
                         "(expected 'threefry' or 'counter')")
    lanes = key.shape[0]
    if key.shape != (lanes, 2) or key.dtype != torch.int64:
        raise ValueError(f"engine_step: key int64 [B, 2], got {key.dtype} "
                         f"{tuple(key.shape)}")
    if len(fields) != 7 or any(
            f.shape != (lanes,) or f.dtype != torch.int32 or f.device != dev
            for f in fields):
        raise ValueError("engine_step: seven int32 [B] state fields on "
                         f"{dev}")
    if any(a.shape != (lanes,) or a.device != dev
           for a in (actions_a, actions_b)):
        raise ValueError(f"engine_step: actions [B] on {dev}, got "
                         f"{tuple(actions_a.shape)} on {actions_a.device}, "
                         f"{tuple(actions_b.shape)} on {actions_b.device}")
    if raw_to_dense.dim() != 1 or raw_to_dense.dtype != torch.int32 or \
            raw_to_dense.device != dev:
        raise ValueError(f"engine_step: raw_to_dense int32 [n_raw] on {dev}")
    act = actions_a.dtype
    if act not in (torch.int32, torch.int64) or actions_b.dtype != act:
        actions_a, actions_b = (actions_a.to(torch.int32),
                                actions_b.to(torch.int32))
        act = torch.int32
    ins = [f.contiguous() for f in (*fields, key, actions_a, actions_b)]
    return dev, lanes, ins, act == torch.int64


def outputs(lanes: int, dev):
    """S1's output tensors: int32 [9, B], float32 [2, B], bool [2, B]."""
    return (torch.empty((9, lanes), dtype=torch.int32, device=dev),
            torch.empty((2, lanes), dtype=torch.float32, device=dev),
            torch.empty((2, lanes), dtype=torch.bool, device=dev))


def launch(lib, dev, ptrs, *args) -> None:
    """``lib``'s ``gst_engine_step`` (this module's library or a build of
    an S1 design, ops/engine_variants) on ``ptrs`` and ``args`` (its C
    arguments between the pointers and the stream) on the current stream,
    not counted; raises if the launch failed."""
    arr = (ctypes.c_void_p * len(ptrs))(*(t.data_ptr() for t in ptrs))
    rc = lib.gst_engine_step(dev.index, ctypes.addressof(arr), *args,
                             torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError("engine_step: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")


@functools.lru_cache(maxsize=None)
def _library():
    """The built S1 library with its C signatures declared, its lanes a
    block and its Params and Reset layouts checked against
    LANES_PER_BLOCK, ``EngineParams`` and ``EngineReset``."""
    from . import _build
    lib = _build.load("engine_kernel")
    declare(lib)
    shape = (ctypes.c_int32 * 3)()
    lib.gst_engine_shape(ctypes.addressof(shape))
    want = (LANES_PER_BLOCK, ctypes.sizeof(EngineParams),
            ctypes.sizeof(EngineReset))
    if tuple(shape) != want:
        raise RuntimeError(f"engine_kernel: the library's (lanes a block, "
                           f"Params, Reset) are {tuple(shape)}, here {want}")
    return lib


def declare(lib) -> None:
    """Declares the C signatures of ``lib``: this module's library, or a
    build of the same source (ops/engine_variants)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # device, ptrs, params, reset, lanes, rng, autoreset, act64, stream
    lib.gst_engine_step.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.gst_engine_step.restype = i32
    lib.gst_engine_shape.argtypes = [vp]
    lib.gst_engine_shape.restype = None
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
