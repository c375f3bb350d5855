"""Threefry uniforms on the card: CUDA kernel T1 and its plain versions.

``threefry_uniforms(key, n, count, salt)`` gives lane i's ``count``
float32 uniforms of ``fold_in(fold_in(key_i, n_i), salt)`` (the second
fold_in only when ``salt`` != 0): the JAX package's
``batch.per_env_uniforms(state, count, salt, rng="threefry")``, bit for
bit.  ``keyed_uniform(key, i, shape)`` and ``keyed_randint(key, i, shape,
lo, hi)`` are T1's keyed entry: ``threefry.uniform`` / ``randint`` of
``fold_in(key, i)`` for one key [2], the single-key draws of the
policies (``jax.random.uniform(jax.random.fold_in(key, i), shape)``).

On CPU tensors each runs its plain version, the composition of
core/threefry's functions; on CUDA tensors it launches T1
(``csrc/threefry_kernel.cu``: one thread a lane, or an output element,
every round in registers, `LANES_PER_BLOCK` lanes or elements a block;
the rounds in ``csrc/threefry.cuh``, which kernels S1, S2 and S3 share).
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import threefry

# Launches of T1 in this process (its per-lane and its keyed entry),
# counted by the wrappers where they launch and nowhere else.
launch_counts = {"threefry_uniforms": 0, "threefry_keyed": 0}
# Lanes (or the keyed entry's elements) a block: csrc/threefry_kernel.cu
# kThreads.
LANES_PER_BLOCK = 256


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(key: torch.Tensor, n: torch.Tensor, count: int, salt: int):
    if key.dim() != 2 or key.shape[1] != 2 or n.shape != key.shape[:1]:
        raise ValueError(f"threefry_uniforms: key [B, 2] and n [B], got "
                         f"{tuple(key.shape)} and {tuple(n.shape)}")
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    if not 0 <= salt <= threefry.M32:
        raise ValueError(f"salt must be a uint32, got {salt}")


def threefry_uniforms(key: torch.Tensor, n: torch.Tensor, count: int,
                      salt: int = 0) -> torch.Tensor:
    """float32 [B, count] uniforms of lane i's key ``key[i]`` (int64 [B, 2]
    uint32 words) at draw counter ``n[i]`` (int32 [B]) under ``salt``."""
    _check(key, n, count, salt)
    if key.device.type == "cpu":
        return threefry_uniforms_plain(key, n, count, salt)
    return _launch(key, n, count, salt)


def threefry_uniforms_plain(key: torch.Tensor, n: torch.Tensor, count: int,
                            salt: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``threefry_uniforms``, on any device."""
    _check(key, n, count, salt)
    sub = threefry.fold_in(key, n)
    if salt:
        sub = threefry.fold_in(sub, salt)
    return threefry.uniform(sub, (count,))


def _launch(key: torch.Tensor, n: torch.Tensor, count: int, salt: int):
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"threefry_uniforms: no kernel for device {dev}")
    if key.dtype != torch.int64 or n.dtype != torch.int32 or \
            n.device != dev:
        raise ValueError("threefry_uniforms: the kernel takes int64 key "
                         f"words and int32 counters on one device; got "
                         f"{key.dtype} on {dev}, {n.dtype} on {n.device}")
    key, n = key.contiguous(), n.contiguous()
    lanes = key.shape[0]
    out = torch.empty((lanes, count), dtype=torch.float32, device=dev)
    if lanes:
        lib = _library()
        rc = lib.gst_threefry_uniforms(
            dev.index, key.data_ptr(), n.data_ptr(), lanes, count, salt,
            out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
        if rc:
            raise RuntimeError("threefry_uniforms: kernel launch failed: "
                               f"{lib.gst_error_string(rc).decode()} ({rc})")
        launch_counts["threefry_uniforms"] += 1
    return out


def _check_key(key: torch.Tensor):
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"keyed draw: one key, int64 [2], got {key.dtype} "
                         f"{tuple(key.shape)}")


def keyed_uniform(key: torch.Tensor, i: int, shape) -> torch.Tensor:
    """float32 ``uniform(fold_in(key, i), shape)`` for one key (int64 [2]
    uint32 words) and an int ``i``, where ``key`` lies."""
    _check_key(key)
    if key.device.type == "cpu":
        return keyed_uniform_plain(key, i, shape)
    return _launch_keyed(key, i, shape, None)


def keyed_uniform_plain(key: torch.Tensor, i: int, shape) -> torch.Tensor:
    """Plain PyTorch version of ``keyed_uniform``, on any device."""
    return threefry.uniform(threefry.fold_in(key, i), shape)


def keyed_randint(key: torch.Tensor, i: int, shape, minval: int,
                  maxval: int) -> torch.Tensor:
    """int32 ``randint(fold_in(key, i), shape, minval, maxval)`` for one
    key (int64 [2]) and an int ``i``, where ``key`` lies."""
    _check_key(key)
    if key.device.type == "cpu":
        return keyed_randint_plain(key, i, shape, minval, maxval)
    return _launch_keyed(key, i, shape,
                         (minval, *threefry.randint_span(minval, maxval)))


def keyed_randint_plain(key: torch.Tensor, i: int, shape, minval: int,
                        maxval: int) -> torch.Tensor:
    """Plain PyTorch version of ``keyed_randint``, on any device."""
    return threefry.randint(threefry.fold_in(key, i), shape, minval, maxval)


def _launch_keyed(key: torch.Tensor, i: int, shape, randint):
    """T1's keyed entry: ``randint`` None for uniforms, else (minval, span,
    multiplier)."""
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"keyed draw: no kernel for device {dev}")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    numel = math.prod(shape)
    if numel >= 2 ** 31:
        raise ValueError(f"keyed draw: {numel} elements do not fit int32")
    key = key.contiguous()
    dtype = torch.float32 if randint is None else torch.int32
    out = torch.empty(shape, dtype=dtype, device=dev)
    minval, span, mult = (0, 1, 0) if randint is None else randint
    if numel:
        lib = _library()
        rc = lib.gst_threefry_keyed(
            dev.index, key.data_ptr(), int(i) & threefry.M32,
            numel, randint is not None, minval & threefry.M32, span, mult,
            out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
        if rc:
            raise RuntimeError("keyed draw: kernel launch failed: "
                               f"{lib.gst_error_string(rc).decode()} ({rc})")
        launch_counts["threefry_keyed"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _library():
    """The built T1 library with its C signatures declared, its lanes a
    block checked against LANES_PER_BLOCK."""
    from . import _build
    lib = _build.load("threefry_kernel")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # device, key, n, lanes, count, salt, out, stream
    lib.gst_threefry_uniforms.argtypes = [i32, vp, vp, i32, i32,
                                          ctypes.c_uint32, vp, vp]
    lib.gst_threefry_uniforms.restype = i32
    u32 = ctypes.c_uint32
    # device, key, i, numel, randint, minval, span, mult, out, stream
    lib.gst_threefry_keyed.argtypes = [i32, vp, u32, i32, i32, u32, u32, u32,
                                       vp, vp]
    lib.gst_threefry_keyed.restype = i32
    lib.gst_threefry_block.argtypes = []
    lib.gst_threefry_block.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    if lib.gst_threefry_block() != LANES_PER_BLOCK:
        raise RuntimeError(f"threefry_kernel: {lib.gst_threefry_block()} "
                           f"lanes a block in the library, "
                           f"{LANES_PER_BLOCK} here")
    return lib
