"""Mixed-geometry batches: per-lane board geometry and the observation
codec over a mixture of boards.

The port of gym_soccer_tpu/core/multigrid.py's host and codec parts.  A
mixture is a tuple of EnvConfigs; each lane plays on its own variant, and
its geometry (height, width, goal rows, slip) is per-lane data that
core/rules takes where it takes an EnvConfig.  ``build_codec`` gives each
variant's dense state index and its block in tables concatenated over the
variants; ``dense_obs`` and ``global_obs`` map lanes' state fields to them.

Not ported yet: the threefry-driven engine, ``init``, ``uniforms``,
``reset_where``, ``step`` and ``rollout`` (ROADMAP Queue 1 item 16).  JAX's
``multigrid.step`` draws its uniforms from per-instance threefry keys with
no counter switch (``uniforms`` passes no ``rng``, so
``batch.per_env_uniforms`` takes its threefry default), and the port has
no threefry yet, so those functions have no bit oracle.  The fused
mixed-geometry kernels (ops/step_kernel ``multigrid_rollout``,
ops/learner_kernel's tuple configs) use the counter PRNG and are ported.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import EnvConfig
from . import rules, tables


class LaneGeometry(NamedTuple):
    """Per-lane geometry tensors, a stand-in for EnvConfig in core/rules."""
    H: torch.Tensor      # int32 [B]
    W: torch.Tensor      # int32 [B] (internal width incl. goal columns)
    glo: torch.Tensor    # int32 [B] first goal row
    ghi: torch.Tensor    # int32 [B] last goal row
    slip: torch.Tensor   # float32 [B] slip probability
    vid: torch.Tensor    # int32 [B] variant id (index into the cfgs tuple)
    max_steps: int

    @property
    def goal_row_bounds(self):
        return self.glo, self.ghi


def lane_geometry(cfgs: Sequence[EnvConfig], batch_size: int,
                  max_steps: int = 100, device="cuda") -> LaneGeometry:
    """Variants assigned to lanes round-robin (lane i -> cfgs[i % nV])."""
    idx = np.arange(batch_size) % len(cfgs)

    def plane(values, dtype):
        return torch.as_tensor(np.asarray(values, dtype)[idx], device=device)

    return LaneGeometry(
        H=plane([c.H for c in cfgs], np.int32),
        W=plane([c.W for c in cfgs], np.int32),
        glo=plane([c.goal_row_bounds[0] for c in cfgs], np.int32),
        ghi=plane([c.goal_row_bounds[1] for c in cfgs], np.int32),
        slip=plane([c.slip_prob for c in cfgs], np.float32),
        vid=torch.as_tensor(idx.astype(np.int32), device=device),
        max_steps=max_steps)


class MultiGridCodec(NamedTuple):
    """Per-variant dense observation codec over a mixed-geometry batch (the
    reference's dense indexing for one geometry, soccer_simultaneous_env.py
    :63-106, applied per variant).  Host numpy arrays."""
    cfgs: tuple                 # tuple[EnvConfig, ...]
    nS: tuple                   # per-variant dense state counts
    offsets: np.ndarray         # [V] int32: variant base in the global index
    nS_total: int               # sum of per-variant counts
    raw_to_dense: np.ndarray    # [V, max_nraw] int32 (0-padded)


@functools.lru_cache(maxsize=None)
def build_codec(cfgs: tuple) -> MultiGridCodec:
    """Build (cached) the mixed-batch observation codec."""
    spaces = [tables.build_statespace(c) for c in cfgs]
    nS = tuple(int(s.nS) for s in spaces)
    offsets = np.concatenate([[0], np.cumsum(nS[:-1])]).astype(np.int32)
    max_raw = max(s.raw_to_dense.shape[0] for s in spaces)
    r2d = np.zeros((len(cfgs), max_raw), np.int32)
    for v, s in enumerate(spaces):
        r2d[v, :s.raw_to_dense.shape[0]] = s.raw_to_dense
    return MultiGridCodec(cfgs=tuple(cfgs), nS=nS, offsets=offsets,
                          nS_total=int(sum(nS)), raw_to_dense=r2d)


@functools.lru_cache(maxsize=None)
def _codec_on(cfgs: tuple, device: torch.device):
    codec = build_codec(cfgs)
    return (torch.as_tensor(codec.raw_to_dense, device=device),
            torch.as_tensor(codec.offsets, device=device))


def dense_obs(codec: MultiGridCodec, fields, geo: LaneGeometry):
    """Per-lane dense observation under the lane's own variant (goal -> 0,
    reachable -> enumeration-order index).  ``fields``: (ra, ca, rb, cb, p)
    int32 [B] tensors; ``geo``: their lanes' geometry."""
    ra, ca, rb, cb, p = fields[:5]
    raw = rules.raw_encode(torch, ra, ca, rb, cb, p, geo)
    r2d, _ = _codec_on(codec.cfgs, raw.device)
    return r2d[geo.vid.long(), raw.long()]


def global_obs(codec: MultiGridCodec, fields, geo: LaneGeometry):
    """``offsets[vid] + dense_obs``: the index into learner tables
    concatenated over the variants."""
    _, offsets = _codec_on(codec.cfgs, geo.vid.device)
    return offsets[geo.vid.long()] + dense_obs(codec, fields, geo)


def _isd_fields(geo: LaneGeometry, u: torch.Tensor):
    """Per-lane initial state from float32 uniforms ``u`` [B] (reference
    _generate_isd): even-H boards pick one of 2 row swaps x 2 possessions,
    odd-H boards the middle row x 2 possessions; columns 2 and W - 3."""
    even = (geo.H % 2) == 0
    n_entries = torch.where(even, 4, 2).to(torch.int32)
    idx = torch.minimum((u * n_entries).to(torch.int32), n_entries - 1)
    mid_hi = geo.H // 2
    mid_lo = (geo.H - 1) // 2
    swap = (idx // 2) == 1
    row_a = torch.where(even, torch.where(swap, mid_hi, mid_lo), geo.H // 2)
    row_b = torch.where(even, torch.where(swap, mid_lo, mid_hi), geo.H // 2)
    poss = idx % 2
    return row_a, torch.full_like(row_a, 2), row_b, geo.W - 3, poss
