"""Batched environment engine on PyTorch tensors.

The port of gym_soccer_tpu/core/batch.py: pure functions over
struct-of-arrays int32 state, stepping thousands of env instances in
lockstep on one device, with automatic reset on termination.

Transitions are computed by the rules (branchless collision chain plus
factored slip sampling), so the engine needs no transition tables, only
the dense-observation lookup.  The factored sampler (slip variant per
player, then outcome slot) draws from the same joint distribution as the
reference's 36-entry categorical.

RNG: each env instance carries its per-instance key as two uint32 key
words (held in int64, core/threefry) and a monotonic draw counter ``n``.
Every function that draws takes JAX's ``rng=`` argument:

* ``"threefry"`` (the default, as in the JAX package): a step's uniforms
  are ``uniform(fold_in(fold_in(key_i, n_i), salt), (count,))``;
* ``"counter"``: a murmur3 hash of (key words, n, word index, salt), the
  stream of the fused kernels.

On CUDA tensors ``step`` is kernel S1 (ops/engine_kernel): the whole step,
its transition and reset draws included, in one launch, under either
``rng``; ``step_plain`` is its plain version, which ``step`` runs on CPU
tensors.  The other draws go through kernel T1 (ops/threefry_kernel):
``per_env_uniforms`` per lane, ``random_policy_fn``'s single-key draw by
its keyed entry.

Given the same key words (``jax.random.key_data`` of the JAX package's
keys) and counters, every function here equals the JAX package's under
the same ``rng`` bit for bit.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import EnvConfig
from ..ops import engine_kernel, threefry_kernel
from ..ops.step_kernel import M32, _fmix32, _mul32
from . import rules, tables, threefry


class EnvState(NamedTuple):
    """Struct-of-arrays batched state; every leaf has leading dim [B]."""
    rows_a: torch.Tensor  # int32
    cols_a: torch.Tensor
    rows_b: torch.Tensor
    cols_b: torch.Tensor
    poss: torch.Tensor    # 0 = A has the ball, 1 = B
    t: torch.Tensor       # steps taken in the current episode (int32)
    n: torch.Tensor       # total draws counter (int32, monotonic)
    key: torch.Tensor     # int64 [B, 2]: the per-instance key's two uint32 words


class StepOut(NamedTuple):
    obs: torch.Tensor        # dense observation index, int32 [B]
    reward_a: torch.Tensor   # player-A-perspective reward, float32 [B]
    done: torch.Tensor       # goal scored this step, bool [B]
    truncated: torch.Tensor  # episode hit max_steps, bool [B]
    final_obs: torch.Tensor  # obs BEFORE autoreset (terminal obs), int32 [B]
    prob: torch.Tensor       # sampled transition probability, float32 [B]


class DeviceMaps(NamedTuple):
    """Small lookup tensors on one device (no transition tables)."""
    raw_to_dense: torch.Tensor  # int32 [nRaw]
    isd_fields: torch.Tensor    # int32 [nI, 5]
    isd_cum: torch.Tensor       # float32 [nI]


@functools.lru_cache(maxsize=None)
def device_maps(cfg: EnvConfig, device: torch.device) -> DeviceMaps:
    ss = tables.build_statespace(cfg)
    return DeviceMaps(
        raw_to_dense=torch.as_tensor(ss.raw_to_dense, device=device),
        isd_fields=torch.as_tensor(tables.isd_fields(cfg), device=device),
        isd_cum=torch.as_tensor(np.cumsum(ss.isd_probs).astype(np.float32),
                                device=device),
    )


class ResetTable(NamedTuple):
    """A board's initial state distribution on the host."""
    fields: tuple   # (ra, ca, rb, cb, poss) of each ISD entry
    cum: tuple      # the float32 cumulative probabilities, as floats
    obs: tuple      # each entry's dense observation


@functools.lru_cache(maxsize=None)
def reset_table(cfg: EnvConfig) -> ResetTable:
    """The ISD of ``cfg``'s board with each entry's dense observation, from
    the host's tables, cached: what kernel S1's reset selects from in its
    launch's arguments, so that it reads no table on the card.  The same
    numbers as ``device_maps``' ``isd_fields`` and ``isd_cum`` and its
    ``raw_to_dense`` of each entry."""
    ss = tables.build_statespace(cfg)
    fields = tables.isd_fields(cfg)
    cum = np.cumsum(ss.isd_probs).astype(np.float32)
    raw = rules.raw_encode(np, *fields.T.astype(np.int64), cfg)
    return ResetTable(tuple(tuple(int(x) for x in f) for f in fields),
                      tuple(float(c) for c in cum),
                      tuple(int(ss.raw_to_dense[r]) for r in raw))


def init(cfg: EnvConfig, key: torch.Tensor, batch: int,
         device="cuda") -> EnvState:
    """Per-instance keys and initial states on ``device``: instance i's
    key is ``fold_in(key, i)`` (``key``: one key, core/threefry), and every
    instance resets with threefry."""
    key = threefry.wrap_key_data(key, device)
    keys = threefry.fold_in(key, torch.arange(batch, device=key.device))
    return init_from_keys(cfg, keys, device)


def init_from_keys(cfg: EnvConfig, key_words, device="cuda",
                   rng: str = "threefry") -> EnvState:
    """Initialize from explicit per-instance key words [B, 2] (uint32
    values: a tensor, or e.g. ``jax.random.key_data`` of the JAX package's
    per-instance keys as numpy), resetting every instance with ``rng``.

    With ``rng="threefry"`` this is the JAX package's
    ``batch.init_from_keys``; with ``"counter"`` its
    ``_reset_where(cfg, state, ones, rng="counter")`` on a zero state
    holding the same keys."""
    key = threefry.wrap_key_data(key_words, device)
    if key.ndim != 2 or key.shape[1] != 2:
        raise ValueError(f"key_words must be [B, 2], got {tuple(key.shape)}")
    zeros = torch.zeros(key.shape[0], dtype=torch.int32, device=key.device)
    st = EnvState(zeros, zeros, zeros, zeros, zeros, t=zeros, n=zeros,
                  key=key)
    return _reset_where(cfg, st, torch.ones_like(zeros, dtype=torch.bool),
                        rng=rng)


def per_env_uniforms(state: EnvState, count: int, salt: int = 0,
                     rng: str = "threefry") -> torch.Tensor:
    """float32 [B, count] uniforms from (key_i, n_i, salt).

    ``salt`` separates independent consumer streams (0 = the env
    transition itself, which ``step`` draws inside kernel S1 on the card;
    learners and policies use nonzero salts).  ``rng="threefry"``:
    ``threefry_kernel.threefry_uniforms`` (kernel T1 on a CUDA tensor);
    ``"counter"``: 24-bit uniforms of a murmur3 hash into which both 32-bit
    key words enter, at separate stages (plain PyTorch on any device)."""
    if rng == "threefry":
        return threefry_kernel.threefry_uniforms(state.key, state.n, count,
                                                 salt)
    if rng != "counter":
        raise ValueError(f"unknown rng mode {rng!r} "
                         "(expected 'threefry' or 'counter')")
    base = state.key[:, 0]
    base2 = _fmix32(state.key[:, 1] ^ 0x3C6EF372)
    n = state.n.to(torch.int64) & M32
    cols = []
    for w in range(count):
        c = (_mul32(n, 0x85EBCA77)
             + ((w * 0xC2B2AE3D + salt * 0x9E3779B9) & M32)) & M32
        bits = _fmix32((_fmix32(base ^ c) + (c ^ base2)) & M32)
        cols.append((bits >> 8).to(torch.float32) * (1.0 / (1 << 24)))
    return torch.stack(cols, dim=-1)


def _sample_isd(cfg: EnvConfig, u: torch.Tensor):
    """Categorical over the initial state distribution (reference
    :146-165/:414): first exceedance over the float32 cumulative sums."""
    maps = device_maps(cfg, u.device)
    i = (maps.isd_cum[None, :] <= u[:, None]).sum(dim=1)
    i = i.clamp(0, maps.isd_fields.shape[0] - 1)
    return maps.isd_fields[i].unbind(-1)


def _reset_where(cfg: EnvConfig, state: EnvState, mask: torch.Tensor,
                 rng: str = "threefry") -> EnvState:
    """Re-sample initial states for masked instances (consumes one draw)."""
    u = per_env_uniforms(state, 1, rng=rng)[:, 0]
    ra, ca, rb, cb, p = _sample_isd(cfg, u)
    pick = lambda new, old: torch.where(mask, new, old)  # noqa: E731
    return EnvState(
        rows_a=pick(ra, state.rows_a), cols_a=pick(ca, state.cols_a),
        rows_b=pick(rb, state.rows_b), cols_b=pick(cb, state.cols_b),
        poss=pick(p, state.poss),
        t=pick(torch.zeros_like(state.t), state.t),
        n=state.n + 1,  # keep draw counters aligned across the batch
        key=state.key,
    )


def observe(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Dense observation index (goal states map to 0, reachable states to
    their enumeration-order index)."""
    raw = rules.raw_encode(torch, state.rows_a, state.cols_a,
                           state.rows_b, state.cols_b, state.poss, cfg)
    return device_maps(cfg, raw.device).raw_to_dense[raw.long()]


def _f32(v: float) -> float:
    """``v`` rounded to float32: a JAX weak-typed Python scalar meeting a
    float32 array is rounded this way before the operation."""
    return float(np.float32(v))


def _slip_variant(cfg: EnvConfig, u: torch.Tensor) -> torch.Tensor:
    """0 = intended move (prob 1-q), 1/2 = the orthogonal slips (q/2 each)."""
    q = cfg.slip_prob
    v = torch.where(u < _f32(1.0 - q), 0,
                    torch.where(u < _f32(1.0 - q * 0.5), 1, 2))
    return v.to(torch.int32)


def _slipped_move_arith(a: torch.Tensor, variant: torch.Tensor):
    """(dcol, drow) of action ``a`` under slip ``variant``, arithmetically."""
    mc0 = (a == 3).to(torch.int32) - (a == 4).to(torch.int32)
    mr0 = (a == 2).to(torch.int32) - (a == 1).to(torch.int32)
    # variant 1 -> (-mr0, mc0); variant 2 -> (mr0, -mc0)  (orthogonal_moves)
    first = variant == 1
    keep = variant == 0
    mc = torch.where(keep, mc0, torch.where(first, -mr0, mr0))
    mr = torch.where(keep, mr0, torch.where(first, mc0, -mc0))
    return mc, mr


def step(cfg: EnvConfig, state: EnvState, actions_a: torch.Tensor,
         actions_b: torch.Tensor, autoreset: bool = True,
         rng: str = "threefry") -> tuple[EnvState, StepOut]:
    """One lockstep transition for the whole batch: ``step_plain`` on CPU
    tensors; on CUDA tensors one launch of kernel S1, which computes the
    same outputs bit for bit and raises if it cannot launch."""
    if state.key.device.type == "cpu":
        return step_plain(cfg, state, actions_a, actions_b, autoreset, rng)
    return step_result(state, *engine_kernel.engine_step(
        cfg, state[:7], state.key, actions_a, actions_b,
        device_maps(cfg, state.key.device), autoreset, rng))


def step_result(state: EnvState, ints: torch.Tensor, floats: torch.Tensor,
                flags: torch.Tensor) -> tuple[EnvState, StepOut]:
    """S1's output tensors (``engine_kernel.engine_step``'s) as the new
    state, which keeps ``state``'s key, and the ``StepOut``."""
    ra, ca, rb, cb, poss, t, n, obs, final_obs = ints.unbind()
    return (EnvState(ra, ca, rb, cb, poss, t, n, key=state.key),
            StepOut(obs=obs, reward_a=floats[0], done=flags[0],
                    truncated=flags[1], final_obs=final_obs,
                    prob=floats[1]))


def step_plain(cfg: EnvConfig, state: EnvState, actions_a: torch.Tensor,
               actions_b: torch.Tensor, autoreset: bool = True,
               rng: str = "threefry") -> tuple[EnvState, StepOut]:
    """Plain PyTorch version of ``step``, on any device.

    Factored sampling: slip variant per player, then one categorical over
    the <=4 collision outcome slots."""
    u = per_env_uniforms(state, 4, rng=rng)
    actions_a = actions_a.to(torch.int32)
    actions_b = actions_b.to(torch.int32)

    va = _slip_variant(cfg, u[:, 0])
    vb = _slip_variant(cfg, u[:, 1])
    mca, mra = _slipped_move_arith(actions_a, va)
    mcb, mrb = _slipped_move_arith(actions_b, vb)

    out = rules.resolve_outcomes(
        torch, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, actions_a, actions_b, mca, mra, mcb, mrb, cfg)

    # One of the 4 outcome slots by weight (first exceedance).
    weight = out["weight"]
    wcum = torch.cumsum(weight, dim=-1)
    k = (wcum <= u[:, 2:3]).sum(dim=-1).clamp(0, 3)
    take = lambda a: a.gather(-1, k[:, None])[:, 0]  # noqa: E731
    nra, nca = take(out["rows_a"]), take(out["cols_a"])
    nrb, ncb = take(out["rows_b"]), take(out["cols_b"])
    npz = take(out["poss"])

    was_goal = rules.is_goal_state(
        torch, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, cfg)
    # Goal states are absorbing self-loops: with autoreset=False a lane
    # that terminated stays frozen in its terminal state.
    nra = torch.where(was_goal, state.rows_a, nra)
    nca = torch.where(was_goal, state.cols_a, nca)
    nrb = torch.where(was_goal, state.rows_b, nrb)
    ncb = torch.where(was_goal, state.cols_b, ncb)
    npz = torch.where(was_goal, state.poss, npz)
    now_goal = rules.is_goal_state(torch, nra, nca, nrb, ncb, npz, cfg)

    # Sampled transition probability (reference info["p"]): the product of
    # the two per-player slip probabilities and the outcome weight.
    q = cfg.slip_prob
    pv = lambda v: torch.where(  # noqa: E731
        v == 0, _f32(1.0 - q), _f32(q * 0.5)).to(torch.float32)
    w_sel = torch.where(was_goal, 1.0, take(weight))
    prob = pv(va) * pv(vb) * w_sel
    # Entering a goal pays the goal reward; starting absorbed in one pays 0.
    ball_col = torch.where(npz == 0, nca, ncb)
    reward_a = torch.where(
        now_goal & ~was_goal,
        torch.where(ball_col == cfg.W - 1, 1.0, -1.0), 0.0
    ).to(torch.float32)

    t_next = state.t + 1
    truncated = t_next >= cfg.max_steps
    done = now_goal

    mid = EnvState(rows_a=nra, cols_a=nca, rows_b=nrb, cols_b=ncb,
                   poss=npz, t=t_next, n=state.n + 1, key=state.key)
    final_obs = observe(cfg, mid)

    new_state = (_reset_where(cfg, mid, done | truncated, rng=rng)
                 if autoreset else mid)
    return new_state, StepOut(obs=observe(cfg, new_state),
                              reward_a=reward_a, done=done,
                              truncated=truncated, final_obs=final_obs,
                              prob=prob)


PolicyFn = Callable[[torch.Tensor, int], tuple[torch.Tensor, torch.Tensor]]


def rollout(cfg: EnvConfig, state: EnvState, policy_fn: PolicyFn,
            n_steps: int, rng: str = "threefry"):
    """``policy_fn(obs, i) -> (actions_a, actions_b)`` for steps
    i = 0 .. n_steps-1 (step i's obs is step i - 1's ``StepOut.obs``, the
    state's observation).  Returns the final state and the StepOut
    trajectory stacked to [T, B] per field."""
    outs = []
    obs = observe(cfg, state)
    for i in range(n_steps):
        aa, ab = policy_fn(obs, i)
        state, out = step(cfg, state, aa, ab, rng=rng)
        outs.append(out)
        obs = out.obs
    return state, StepOut(*(torch.stack(f) for f in zip(*outs)))


class RolloutStats(NamedTuple):
    reward_sum: torch.Tensor  # float32 [] sum of player-A rewards
    goals: torch.Tensor       # int32 [] goal terminations
    truncs: torch.Tensor      # int32 [] truncations


def _accumulate(acc: RolloutStats, out: StepOut) -> RolloutStats:
    return RolloutStats(
        reward_sum=acc.reward_sum + out.reward_a.sum(),
        goals=acc.goals + out.done.sum(dtype=torch.int32),
        truncs=acc.truncs + out.truncated.sum(dtype=torch.int32))


def _zero_stats(device) -> RolloutStats:
    return RolloutStats(torch.zeros((), dtype=torch.float32, device=device),
                        torch.zeros((), dtype=torch.int32, device=device),
                        torch.zeros((), dtype=torch.int32, device=device))


def rollout_stats(cfg: EnvConfig, state: EnvState, policy_fn: PolicyFn,
                  n_steps: int, rng: str = "threefry"):
    """``rollout`` that accumulates summary statistics instead of stacking
    per-step outputs.  Returns (final_state, RolloutStats)."""
    acc = _zero_stats(state.t.device)
    obs = observe(cfg, state)
    for i in range(n_steps):
        aa, ab = policy_fn(obs, i)
        state, out = step(cfg, state, aa, ab, rng=rng)
        acc = _accumulate(acc, out)
        obs = out.obs
    return state, acc


def random_policy_fn(cfg: EnvConfig, key: torch.Tensor, batch: int):
    """Uniform-random joint policy: step i's actions are
    ``randint(fold_in(key, i), (2, batch), 0, 5)`` (int32), on the
    observations' device (one launch of T1's keyed entry on the card)."""
    on = {}   # the key on each device it was asked on

    def fn(obs, i):
        if obs.device not in on:
            on[obs.device] = key.to(obs.device)
        acts = threefry_kernel.keyed_randint(on[obs.device], i, (2, batch),
                                             0, 5)
        return acts[0], acts[1]
    return fn


_POLICY_SALT = 9


def random_rollout_stats(cfg: EnvConfig, state: EnvState, n_steps: int,
                         rng: str = "threefry"):
    """Random-vs-random rollout accumulating stats only: actions come from
    the per-instance stream (salted so they never correlate with the
    transition draws).  Returns (state, RolloutStats)."""
    acc = _zero_stats(state.t.device)
    for _ in range(n_steps):
        u = per_env_uniforms(state, 2, salt=_POLICY_SALT, rng=rng)
        aa = (u[:, 0] * 5).to(torch.int32).clamp(max=4)
        ab = (u[:, 1] * 5).to(torch.int32).clamp(max=4)
        state, out = step(cfg, state, aa, ab, rng=rng)
        acc = _accumulate(acc, out)
    return state, acc
