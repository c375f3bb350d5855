"""The mixed-geometry and alternating-turn engines' steps on the card:
CUDA kernels S2 and S3.

``core/multigrid.step`` / ``step_obs`` on CUDA tensors call
``multigrid_step``, which launches S2 (``csrc/mixed_alt_kernel.cu``: one
thread a lane on the lane's own board, the transition's and the reset's
threefry draws inside it); ``envs/soccer_alternating_env.alt_step`` /
``alt_step_obs`` call ``alt_step``, which launches S3.  Their plain
versions are ``multigrid.step_plain`` and ``alt_step_plain``, which the
engines run on CPU tensors; there is no fallback from one to the other.
The lookup tables (the codec's ``raw_to_dense`` and ``offsets``, the
alternating tables' ``raw_to_dense``) are tensors cached once a device by
the engines' modules; S3's board ISD, with each entry's observation, is
``alt_reset_table``'s host tuple, passed in the launch's arguments
(`AltReset`).  The lanes a block are `LANES_PER_BLOCK`.

The launches read nothing back to the host, allocate their outputs with
torch and run on the current stream, so a CUDA graph can capture them
(the HBM-table learners' replays, ``ops/dispatch.run``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..config import EnvConfig
from .engine_kernel import MAX_ISD  # noqa: F401 (the ISD bound S3 shares)
from .engine_kernel import EngineParams, EngineReset, params, reset_struct

# Launches of S2 and S3 in this process, counted by the wrappers where
# they launch and nowhere else.
launch_counts = {"multigrid_step": 0, "alt_step": 0}

# The device pointers each C entry reads.
N_PTRS = {"multigrid_step": 21, "alt_step": 14}
# The lanes a block (csrc/mixed_alt_kernel.cu kThreads), at every width:
# 32 times 2-5 % under 64 and 128 from 128 to 8192 lanes, 256 slower
# from 256 lanes up (ops/mixed_alt_variants, phase 51 of chip_smoke.py).
LANES_PER_BLOCK = 32


# S3's ISD argument (csrc/mixed_alt_kernel.cu AltReset) has S1's layout.
AltReset = EngineReset


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_lanes(name: str, fields, n_fields: int, key: torch.Tensor,
                 actions) -> tuple:
    """The launch's device and lanes, after the shape and type checks
    every wrapper makes; the actions as the kernel reads them (int32 or
    int64, other types cast to int32) and whether they are int64."""
    dev = key.device
    lanes = key.shape[0]
    if key.shape != (lanes, 2) or key.dtype != torch.int64:
        raise ValueError(f"{name}: key int64 [B, 2], got {key.dtype} "
                         f"{tuple(key.shape)}")
    if len(fields) != n_fields or any(
            f.shape != (lanes,) or f.dtype != torch.int32 or f.device != dev
            for f in fields):
        raise ValueError(f"{name}: {n_fields} int32 [B] state fields on "
                         f"{dev}")
    if any(a.shape != (lanes,) or a.device != dev for a in actions):
        raise ValueError(f"{name}: actions [B] on {dev}, got "
                         + ", ".join(f"{tuple(a.shape)} on {a.device}"
                                     for a in actions))
    act = actions[0].dtype
    if act not in (torch.int32, torch.int64) or any(
            a.dtype != act for a in actions):
        actions = tuple(a.to(torch.int32) for a in actions)
        act = torch.int32
    return dev, lanes, actions, act == torch.int64


def _on_card(name: str, dev: torch.device) -> None:
    """Raises where the tensors are not on a CUDA device: the kernel has no
    other, and the wrapper no plain fallback."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def _launch(name: str, dev: torch.device, ptrs, *args) -> None:
    """Launches the library's ``gst_<name>`` on the current stream and
    counts it; raises if the launch failed."""
    lib = _library()
    assert len(ptrs) == N_PTRS[name], (name, len(ptrs))
    arr = (ctypes.c_void_p * len(ptrs))(*(
        None if t is None else t.data_ptr() for t in ptrs))
    rc = getattr(lib, "gst_" + name)(
        dev.index, ctypes.addressof(arr), *args,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} "
                           f"({rc})")
    launch_counts[name] += 1


def multigrid_step(fields, key: torch.Tensor, actions_a: torch.Tensor,
                   actions_b: torch.Tensor, geo, max_steps: int,
                   autoreset: bool, codec_maps=None):
    """One step of every lane by S2.

    ``fields``: the seven int32 [B] state fields (rows_a, cols_a, rows_b,
    cols_b, poss, t, n); ``key``: int64 [B, 2]; the actions: integer [B];
    ``geo``: the lanes' int32 planes (H, W, glo, ghi, vid) and float32 slip,
    [B] each; ``codec_maps``: None, or the codec's (raw_to_dense int32
    [V, max_raw], offsets int32 [V]) on the device, to write the
    observations.  Returns (int32 [7, B] the new fields, or [9, B] with
    obs and final_obs after them; float32 [B] reward_a; bool [2, B] goal,
    truncated)."""
    dev, lanes, (aa, ab), act64 = _check_lanes(
        "multigrid_step", fields, 7, key, (actions_a, actions_b))
    *planes, slip = geo
    if len(planes) != 5 or any(
            g.shape != (lanes,) or g.dtype != torch.int32 or g.device != dev
            for g in planes) or slip.shape != (lanes,) or \
            slip.dtype != torch.float32 or slip.device != dev:
        raise ValueError("multigrid_step: int32 [B] H, W, glo, ghi, vid and "
                         f"float32 [B] slip on {dev}")
    obs = codec_maps is not None
    r2d, offsets = codec_maps if obs else (None, None)
    if obs and (r2d.dim() != 2 or r2d.dtype != torch.int32
                or offsets.shape != (r2d.shape[0],)
                or offsets.dtype != torch.int32 or r2d.device != dev
                or offsets.device != dev):
        raise ValueError("multigrid_step: the codec's raw_to_dense int32 "
                         f"[V, max_raw] and offsets int32 [V] on {dev}")
    _on_card("multigrid_step", dev)
    ins = [t.contiguous() for t in (*fields, key, aa, ab, *planes, slip)]
    out_i = torch.empty((9 if obs else 7, lanes), dtype=torch.int32,
                        device=dev)
    out_f = torch.empty(lanes, dtype=torch.float32, device=dev)
    out_b = torch.empty((2, lanes), dtype=torch.bool, device=dev)
    if lanes:
        maps = (r2d.contiguous(), offsets.contiguous()) if obs else (None,
                                                                     None)
        _launch("multigrid_step", dev, (*ins, *maps, out_i, out_f, out_b),
                lanes, int(max_steps),
                r2d.shape[1] if obs else 0, bool(autoreset), obs, act64)
    return out_i, out_f, out_b


def alt_step(cfg: EnvConfig, fields, key: torch.Tensor,
             action: torch.Tensor, raw_to_dense: torch.Tensor, reset,
             autoreset: bool):
    """One tick of every lane by S3.

    ``fields``: the eight int32 [B] state fields (rows_a, cols_a, rows_b,
    cols_b, poss, turn, t, n); ``key``: int64 [B, 2]; ``action``: integer
    [B], the mover's; ``raw_to_dense``: the alternating tables' int32
    [n_raw * 2]; ``reset``: ``alt_reset_table(cfg)`` (the board's ISD on
    the host: fields, cumulative thresholds, observations at turn 0).
    The board's constants are S1's (``engine_kernel.params``): the slip's
    thresholds rounded once from the float64 value, as
    ``batch._slip_variant`` rounds them.
    Returns (int32 [10, B]: the new fields, then obs and final_obs;
    float32 [B] reward_a; bool [2, B] goal, truncated)."""
    dev, lanes, (act,), act64 = _check_lanes("alt_step", fields, 8, key,
                                             (action,))
    if raw_to_dense.dim() != 1 or raw_to_dense.dtype != torch.int32 \
            or raw_to_dense.device != dev:
        raise ValueError(f"alt_step: raw_to_dense int32 [n_raw * 2] on {dev}")
    rst = _alt_reset(reset)
    _on_card("alt_step", dev)
    ins = [t.contiguous() for t in (*fields, key, act, raw_to_dense)]
    out_i = torch.empty((10, lanes), dtype=torch.int32, device=dev)
    out_f = torch.empty(lanes, dtype=torch.float32, device=dev)
    out_b = torch.empty((2, lanes), dtype=torch.bool, device=dev)
    if lanes:
        prm = params(cfg, raw_to_dense.shape[0], len(reset.fields))
        _launch("alt_step", dev, (*ins, out_i, out_f, out_b),
                ctypes.addressof(prm), ctypes.addressof(rst), lanes,
                bool(autoreset), act64)
    return out_i, out_f, out_b


def _alt_reset(reset) -> AltReset:
    """``reset`` (an ``alt_reset_table``) as the kernel's `AltReset`
    (``engine_kernel.reset_struct``)."""
    return reset_struct(reset, "alt_step")


@functools.lru_cache(maxsize=None)
def _library():
    """The built S2/S3 library with its C signatures declared, its lanes a
    block and its Params and AltReset layouts checked against
    LANES_PER_BLOCK, ``EngineParams`` and `AltReset`."""
    from . import _build
    lib = _build.load("mixed_alt_kernel")
    declare(lib)
    shape = (ctypes.c_int32 * 3)()
    lib.gst_mixed_alt_shape(ctypes.addressof(shape))
    if tuple(shape) != (LANES_PER_BLOCK, ctypes.sizeof(EngineParams),
                        ctypes.sizeof(AltReset)):
        raise RuntimeError(f"mixed_alt_kernel: the library's (lanes a block, "
                           f"Params, AltReset) are {tuple(shape)}, here "
                           f"({LANES_PER_BLOCK}, "
                           f"{ctypes.sizeof(EngineParams)}, "
                           f"{ctypes.sizeof(AltReset)})")
    return lib


def declare(lib) -> None:
    """Declares the C signatures of ``lib``: this module's library, or a
    build of the same source (ops/mixed_alt_variants)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # device, ptrs, lanes, max_steps, max_raw, autoreset, obs, act64, stream
    lib.gst_multigrid_step.argtypes = [i32, vp, i32, i32, i32, i32, i32, i32,
                                       vp]
    lib.gst_multigrid_step.restype = i32
    # device, ptrs, params, reset, lanes, autoreset, act64, stream
    lib.gst_alt_step.argtypes = [i32, vp, vp, vp, i32, i32, i32, vp]
    lib.gst_alt_step.restype = i32
    lib.gst_mixed_alt_shape.argtypes = [vp]
    lib.gst_mixed_alt_shape.restype = None
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
