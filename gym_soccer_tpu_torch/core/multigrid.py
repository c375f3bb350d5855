"""Mixed-geometry batches: a mixture of board geometries in one batch.

The port of gym_soccer_tpu/core/multigrid.py.  A mixture is a tuple of
EnvConfigs; each lane plays on its own variant, and its geometry (height,
width, goal rows, slip) is per-lane data that core/rules takes where it
takes an EnvConfig.  ``build_codec`` gives each variant's dense state
index and its block in tables concatenated over the variants;
``dense_obs`` and ``global_obs`` map lanes' state fields to them.

The engine (``MultiGridState``, ``init``, ``uniforms``, ``reset_where``,
``step``, ``rollout``) draws from per-instance keys with JAX's threefry by
default, and equals the JAX package's bit for bit.  On CUDA tensors
``step`` (and ``step_obs``, which also writes the learners'
observations) is kernel S2 (ops/mixed_alt_kernel): the whole step, its
transition and reset draws included, in one launch; ``step_plain`` is its
plain version, which ``step`` runs on CPU tensors.  ``uniforms`` passes its
``rng`` to ``batch.per_env_uniforms`` (kernel T1 on a CUDA tensor): the
policies' draws and ``init``'s reset.
The fused mixed-geometry kernels (ops/step_kernel ``multigrid_rollout``,
ops/learner_kernel's tuple configs) use the counter PRNG.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import EnvConfig
from ..ops import mixed_alt_kernel
from . import batch as corebatch
from . import rules, tables, threefry


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


class MultiGridState(NamedTuple):
    """The mixed-geometry engine's state: the batch engine's eight leaves
    (int32 [B] fields, int64 [B, 2] key words) and the lanes' geometry."""
    rows_a: torch.Tensor
    cols_a: torch.Tensor
    rows_b: torch.Tensor
    cols_b: torch.Tensor
    poss: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor
    key: torch.Tensor
    geo: LaneGeometry


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


def dense_obs(codec: MultiGridCodec, fields, geo: LaneGeometry = None):
    """Per-lane dense observation under the lane's own variant (goal -> 0,
    reachable -> enumeration-order index).  ``fields``: a MultiGridState,
    or (ra, ca, rb, cb, p) int32 [B] tensors with ``geo`` their lanes'
    geometry."""
    if geo is None:
        geo = fields.geo
    ra, ca, rb, cb, p = fields[:5]
    raw = rules.raw_encode(torch, ra, ca, rb, cb, p, geo)
    r2d, _ = _codec_on(codec.cfgs, raw.device)
    return r2d[geo.vid.long(), raw.long()]


def global_obs(codec: MultiGridCodec, fields, geo: LaneGeometry = None):
    """``offsets[vid] + dense_obs``: the index into learner tables
    concatenated over the variants."""
    if geo is None:
        geo = fields.geo
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


def init(cfgs: Sequence[EnvConfig], key: torch.Tensor, batch_size: int,
         device="cuda") -> MultiGridState:
    """Lanes round-robin over ``cfgs`` on ``device``, lane i's key
    ``fold_in(key, i)``, every lane reset with threefry."""
    geo = lane_geometry(cfgs, batch_size, device=device)
    key = threefry.wrap_key_data(key, device)
    keys = threefry.fold_in(key, torch.arange(batch_size, device=key.device))
    zeros = torch.zeros(batch_size, dtype=torch.int32, device=key.device)
    st = MultiGridState(zeros, zeros, zeros, zeros, zeros, t=zeros, n=zeros,
                        key=keys, geo=geo)
    return _reset_where(st, torch.ones_like(zeros, dtype=torch.bool))


def uniforms(st: MultiGridState, count: int, salt: int = 0,
             rng: str = "threefry") -> torch.Tensor:
    """Per-lane uniforms; ``salt`` separates consumer streams (a policy
    sampling actions must use a nonzero salt, or its choices correlate
    with the transition's draws, salt 0)."""
    return corebatch.per_env_uniforms(corebatch.EnvState(*st[:8]), count,
                                      salt=salt, rng=rng)


def _reset_where(st: MultiGridState, mask: torch.Tensor) -> MultiGridState:
    u = uniforms(st, 1)[:, 0]
    ra, ca, rb, cb, p = _isd_fields(st.geo, u)
    pick = lambda new, old: torch.where(mask, new, old)  # noqa: E731
    return st._replace(
        rows_a=pick(ra, st.rows_a), cols_a=pick(ca, st.cols_a),
        rows_b=pick(rb, st.rows_b), cols_b=pick(cb, st.cols_b),
        poss=pick(p, st.poss), t=pick(torch.zeros_like(st.t), st.t),
        n=st.n + 1)


def reset_where(st: MultiGridState, mask: torch.Tensor) -> MultiGridState:
    """Re-sample masked lanes (one draw, batch-aligned), for learners that
    need the pre-reset state (the same stream as autoreset)."""
    return _reset_where(st, mask)


def step(st: MultiGridState, actions_a: torch.Tensor,
         actions_b: torch.Tensor, autoreset: bool = True):
    """core/batch.step with per-lane geometry: ``step_plain`` on CPU
    tensors; on CUDA tensors one launch of kernel S2, which computes the
    same outputs bit for bit and raises if it cannot launch.  Returns
    (state, (reward_a, goal, truncated))."""
    if st.key.device.type == "cpu":
        return step_plain(st, actions_a, actions_b, autoreset)
    return _step_on_card(st, actions_a, actions_b, autoreset, None)[:2]


def step_obs(codec: MultiGridCodec, st: MultiGridState,
             actions_a: torch.Tensor, actions_b: torch.Tensor,
             autoreset: bool = True):
    """``step`` that also observes: returns (state, (reward_a, goal,
    truncated), (obs, final_obs)), ``obs`` the ``global_obs`` of the new
    state and ``final_obs`` that of the state before the reset (the
    terminal observation the learners bootstrap from).  ``step_obs_plain``
    on CPU tensors; on CUDA tensors one launch of S2."""
    if st.key.device.type == "cpu":
        return step_obs_plain(codec, st, actions_a, actions_b, autoreset)
    return _step_on_card(st, actions_a, actions_b, autoreset,
                         _codec_on(codec.cfgs, st.key.device))


def step_obs_plain(codec: MultiGridCodec, st: MultiGridState,
                   actions_a: torch.Tensor, actions_b: torch.Tensor,
                   autoreset: bool = True):
    """Plain version of ``step_obs``, on any device: ``step_plain``
    without reset, the observation, then ``reset_where`` on the lanes that
    ended (the stream of ``step_plain``'s autoreset)."""
    mid, out = step_plain(st, actions_a, actions_b, autoreset=False)
    final_obs = global_obs(codec, mid)
    new = _reset_where(mid, out[1] | out[2]) if autoreset else mid
    return new, out, (global_obs(codec, new), final_obs)


def _step_on_card(st, actions_a, actions_b, autoreset, codec_maps):
    geo = st.geo
    ints, reward, flags = mixed_alt_kernel.multigrid_step(
        st[:7], st.key, actions_a, actions_b,
        (geo.H, geo.W, geo.glo, geo.ghi, geo.vid, geo.slip), geo.max_steps,
        autoreset, codec_maps)
    ra, ca, rb, cb, poss, t, n, *obs = ints.unbind()
    new = MultiGridState(ra, ca, rb, cb, poss, t, n, key=st.key, geo=geo)
    return new, (reward, flags[0], flags[1]), tuple(obs)


def step_plain(st: MultiGridState, actions_a: torch.Tensor,
               actions_b: torch.Tensor, autoreset: bool = True):
    """Plain PyTorch version of ``step``, on any device."""
    geo = st.geo
    u = uniforms(st, 4)
    actions_a = actions_a.to(torch.int32)
    actions_b = actions_b.to(torch.int32)

    q = geo.slip  # per-lane slip probability, float32
    var = lambda uu: torch.where(  # noqa: E731
        uu < 1.0 - q, 0, torch.where(uu < 1.0 - q * 0.5, 1, 2)
    ).to(torch.int32)
    mca, mra = corebatch._slipped_move_arith(actions_a, var(u[:, 0]))
    mcb, mrb = corebatch._slipped_move_arith(actions_b, var(u[:, 1]))

    out = rules.resolve_outcomes(
        torch, st.rows_a, st.cols_a, st.rows_b, st.cols_b, st.poss,
        actions_a, actions_b, mca, mra, mcb, mrb, geo)
    wcum = torch.cumsum(out["weight"], dim=-1)
    k = (wcum <= u[:, 2:3]).sum(dim=-1).clamp(0, 3)
    take = lambda a: a.gather(-1, k[:, None])[:, 0]  # noqa: E731
    nra, nca = take(out["rows_a"]), take(out["cols_a"])
    nrb, ncb = take(out["rows_b"]), take(out["cols_b"])
    npz = take(out["poss"])

    # Absorbing goal states: with autoreset=False a terminated lane
    # self-loops and pays 0, like core/batch.step.
    was_goal = rules.is_goal_state(torch, st.rows_a, st.cols_a, st.rows_b,
                                   st.cols_b, st.poss, geo)
    nra = torch.where(was_goal, st.rows_a, nra)
    nca = torch.where(was_goal, st.cols_a, nca)
    nrb = torch.where(was_goal, st.rows_b, nrb)
    ncb = torch.where(was_goal, st.cols_b, ncb)
    npz = torch.where(was_goal, st.poss, npz)

    now_goal = rules.is_goal_state(torch, nra, nca, nrb, ncb, npz, geo)
    ball_col = torch.where(npz == 0, nca, ncb)
    reward_a = torch.where(now_goal & ~was_goal,
                           torch.where(ball_col == geo.W - 1, 1.0, -1.0),
                           0.0).to(torch.float32)
    t_next = st.t + 1
    truncated = t_next >= geo.max_steps
    mid = st._replace(rows_a=nra, cols_a=nca, rows_b=nrb, cols_b=ncb,
                      poss=npz, t=t_next, n=st.n + 1)
    new = _reset_where(mid, now_goal | truncated) if autoreset else mid
    return new, (reward_a, now_goal, truncated)


def rollout(st: MultiGridState, policy_fn, n_steps: int):
    """``policy_fn(state, i) -> (actions_a, actions_b)`` for steps i = 0 ..
    n_steps-1.  Returns the final state and (reward_a, goal, truncated)
    stacked to [T, B]."""
    outs = []
    for i in range(n_steps):
        aa, ab = policy_fn(st, i)
        st, out = step(st, aa, ab)
        outs.append(out)
    return st, tuple(torch.stack(f) for f in zip(*outs))
