"""Scatter-add in lane order on the card: CUDA kernel A1 and its plain
version.

``scatter_add(idx, values, n_cells)`` gives the float32 sums of
``values`` at the flat cells ``idx`` and the number of lanes at each cell,
the sums added in lane order from 0: XLA's scatter-add on the CPU
(``jnp.zeros(n).at[idx].add(values)``), bit for bit, which the JAX
package's HBM-table learners use for their updates
(gym_soccer_tpu/agents/learners.py:193-196, :343-344, :506-507).

On CPU tensors it runs its plain version, ``index_add_`` (which on the
CPU adds in lane order); on CUDA tensors it launches A1
(``csrc/scatter_kernel.cu``: the cells cut into ranges, one a block; each
block takes the lanes of its range in tiles of up to 8192 and a thread a
cell adds its cell's values in lane order with round-to-nearest float32
additions, picking them from a lane-order list where the tile keeps few
lanes and from its cell's run where it keeps many, ordered by cell with a
stable counting sort in shared memory; then the block writes its range's
sums and counts, every cell).  There is no fallback from one to the
other.  ``index_add_`` on a CUDA tensor adds by atomics in no fixed
order, which is why the card needs A1.  The launch reads nothing back and
sizes nothing from the data, so a CUDA graph can capture it (the
learners' replays, ``ops/dispatch.run``); a call is one device
operation, the launch: the kernel writes every cell, so there is no zero
fill.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# Launches of A1 in this process, counted by the wrapper where it
# launches and nowhere else.
launch_counts = {"scatter_add": 0}
# A cell's count is a float32, exact below 2**24 lanes; cells are int64
# below 2**31.
MAX_LANES = 2 ** 24
MAX_CELLS = 2 ** 31
# The kernel's launch (csrc/scatter_kernel.cu): ITEMS lanes a thread a
# tile, at most MAX_WARPS warps a block; the cells cut into ranges of a
# multiple of 32, each about n / BLOCKS, one cell a thread.
ITEMS, MAX_WARPS, BLOCKS = 8, 32, 132


def launch_shape(lanes: int, n_cells: int) -> dict:
    """A1's launch at ``lanes`` lanes over ``n_cells`` cells, as the .cu's
    ``shape_of`` computes it: threads of a block (a power of two of warps,
    enough for its cells, one a thread, and for the lanes of a tile, 256 a
    warp), lanes a
    tile, bytes of dynamic shared memory (a tile's values in cell order; a
    count of each (cell, warp) pair, a row of warps + 1 words a cell; 33
    words of the block scan; cells + 1 run starts), blocks, cells a block,
    and the bits of a cell's index in its block's range."""
    per = -(-n_cells // BLOCKS)
    per = min(max(-(-per // 32) * 32, 32), 32 * MAX_WARPS)
    warp_lanes = 32 * ITEMS
    want = min(lanes, MAX_WARPS * warp_lanes)
    warps = 1   # a power of two, for the lanes and the cells
    while warps * warp_lanes < want or 32 * warps < per:
        warps *= 2
    tile = warps * warp_lanes
    return {"threads": 32 * warps, "tile": tile,
            "smem": 4 * (tile + per * (warps + 1) + 33 + per + 1),
            "blocks": -(-n_cells // per), "cells": per,
            "cell_bits": (per - 1).bit_length()}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(idx: torch.Tensor, values: torch.Tensor, n_cells: int):
    if idx.dim() != 1 or values.shape != idx.shape:
        raise ValueError(f"scatter_add: idx [B] and values [B], got "
                         f"{tuple(idx.shape)} and {tuple(values.shape)}")
    if idx.dtype != torch.int64 or values.dtype != torch.float32:
        raise ValueError(f"scatter_add: int64 idx and float32 values, got "
                         f"{idx.dtype} and {values.dtype}")
    if values.device != idx.device:
        raise ValueError(f"scatter_add: idx on {idx.device}, values on "
                         f"{values.device}")
    if n_cells < 0:
        raise ValueError(f"n_cells must be >= 0, got {n_cells}")


def scatter_add(idx: torch.Tensor, values: torch.Tensor, n_cells: int):
    """(sums, counts): float32 [n_cells] each, views of one [2, n_cells]
    tensor on ``idx``'s device; ``sums[c]`` adds the ``values`` of the
    lanes i with ``idx[i] == c`` in increasing i, from 0, and
    ``counts[c]`` counts them.  ``idx``: int64 [B] in [0, n_cells);
    ``values``: float32 [B]."""
    _check(idx, values, n_cells)
    if idx.device.type == "cpu":
        return scatter_add_plain(idx, values, n_cells)
    return _launch(idx, values, n_cells)


def scatter_add_plain(idx: torch.Tensor, values: torch.Tensor,
                      n_cells: int):
    """Plain PyTorch version of ``scatter_add``: ``index_add_`` on the
    CPU, which adds in lane order.  Tensors on another device are summed
    on a CPU copy (``index_add_`` there adds by atomics in no fixed order)
    and the result is returned on their device."""
    _check(idx, values, n_cells)
    out = torch.zeros((2, n_cells), dtype=torch.float32)
    idx_cpu = idx.cpu()
    out[0].index_add_(0, idx_cpu, values.cpu())
    out[1].index_add_(0, idx_cpu, torch.ones(idx.shape))
    out = out.to(idx.device)
    return out[0], out[1]


def _launch(idx: torch.Tensor, values: torch.Tensor, n_cells: int):
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {dev}")
    lanes = idx.shape[0]
    if lanes >= MAX_LANES or n_cells >= MAX_CELLS:
        raise ValueError(f"scatter_add: the kernel takes fewer than "
                         f"{MAX_LANES} lanes (exact float32 counts) and "
                         f"{MAX_CELLS} cells, got {lanes} and {n_cells}")
    if not lanes or not n_cells:   # nothing to add: no launch
        out = torch.zeros((2, n_cells), dtype=torch.float32, device=dev)
        return out[0], out[1]
    # the sums and the counts: the kernel writes every cell
    out = torch.empty((2, n_cells), dtype=torch.float32, device=dev)
    idx, values = idx.contiguous(), values.contiguous()
    lib = _library()
    rc = lib.gst_scatter_add(
        dev.index, idx.data_ptr(), values.data_ptr(), lanes, n_cells,
        out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError("scatter_add: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    launch_counts["scatter_add"] += 1
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _library():
    """The built A1 library with its C signatures declared."""
    from . import _build
    lib = _build.load("scatter_kernel")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # device, idx, values, lanes, n_cells, out, stream
    lib.gst_scatter_add.argtypes = [i32, vp, vp, i32, i64, vp, vp]
    lib.gst_scatter_add.restype = i32
    # lanes, n_cells, shape: int32 [6]: threads, lanes a tile, shared
    # memory bytes, blocks, cells a block, bits of a cell's index
    lib.gst_scatter_shape.argtypes = [i32, i64, vp]
    lib.gst_scatter_shape.restype = None
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib
