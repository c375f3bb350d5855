"""The batched engine's step on the card: CUDA kernel S1.

``core/batch.step`` on CUDA tensors calls ``engine_step``, which launches
S1 (``csrc/engine_kernel.cu``: one thread a lane, the transition's and the
reset's draws inside it, threefry from ``csrc/threefry.cuh`` or the
counter hash) and returns the new state's and the ``StepOut``'s tensors.
Its plain version is ``core/batch.step_plain``, which is what
``batch.step`` runs on CPU tensors; there is no fallback from one to the
other.  The host constants here are the board's geometry and the slip's
float32 thresholds, computed once a configuration; the lookup tables are
``batch.device_maps``, cached once a device.

The launch reads nothing back to the host, allocates its outputs with
torch and runs on the current stream, so a CUDA graph can capture it
(the HBM-table learners' replays, ``ops/dispatch.run``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import EnvConfig

# Launches of S1 in this process, counted by the wrapper where it launches
# and nowhere else.
launch_counts = {"engine_step": 0}

RNG_IDS = {"threefry": 0, "counter": 1}
N_PTRS = 16


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
    ``maps``: ``batch.device_maps(cfg, device)``.  Returns (int32 [9, B]:
    the new rows_a, cols_a, rows_b, cols_b, poss, t, n, then obs and
    final_obs; float32 [2, B]: reward_a, prob; bool [2, B]: done,
    truncated)."""
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
    act = actions_a.dtype
    if act not in (torch.int32, torch.int64) or actions_b.dtype != act:
        actions_a, actions_b = (actions_a.to(torch.int32),
                                actions_b.to(torch.int32))
        act = torch.int32
    ins = [f.contiguous() for f in (*fields, key, actions_a, actions_b)]
    out_i = torch.empty((9, lanes), dtype=torch.int32, device=dev)
    out_f = torch.empty((2, lanes), dtype=torch.float32, device=dev)
    out_b = torch.empty((2, lanes), dtype=torch.bool, device=dev)
    if lanes:
        ptrs = (ctypes.c_void_p * N_PTRS)(*(t.data_ptr() for t in (
            *ins, maps.raw_to_dense, maps.isd_fields, maps.isd_cum, out_i,
            out_f, out_b)))
        prm = params(cfg, maps.raw_to_dense.shape[0],
                     maps.isd_fields.shape[0])
        lib = _library()
        rc = lib.gst_engine_step(
            dev.index, ctypes.addressof(ptrs), ctypes.addressof(prm), lanes,
            RNG_IDS[rng], bool(autoreset), act == torch.int64,
            torch._C._cuda_getCurrentRawStream(dev.index))
        if rc:
            raise RuntimeError("engine_step: kernel launch failed: "
                               f"{lib.gst_error_string(rc).decode()} ({rc})")
        launch_counts["engine_step"] += 1
    return out_i, out_f, out_b


@functools.lru_cache(maxsize=None)
def _library():
    """The built S1 library with its C signatures declared, its Params
    layout checked against ``EngineParams``."""
    from . import _build
    lib = _build.load("engine_kernel")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # device, ptrs, params, lanes, rng, autoreset, act64, stream
    lib.gst_engine_step.argtypes = [i32, vp, vp, i32, i32, i32, i32, vp]
    lib.gst_engine_step.restype = i32
    lib.gst_engine_shape.argtypes = [vp]
    lib.gst_engine_shape.restype = None
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    shape = (ctypes.c_int32 * 2)()
    lib.gst_engine_shape(ctypes.addressof(shape))
    if shape[1] != ctypes.sizeof(EngineParams):
        raise RuntimeError(f"engine_kernel: Params is {shape[1]} B in the "
                           f"library, {ctypes.sizeof(EngineParams)} here")
    return lib
