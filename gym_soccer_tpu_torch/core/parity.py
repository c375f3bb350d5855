"""Reference-RNG parity backend: bit-exact batched reproduction of the
reference environment's trajectories, on tensors.

The port of gym_soccer_tpu/core/parity.py.  The reference consumes exactly
one MT19937 double per reset and per step (soccer_simultaneous_env.py:395,
:414 via gym's categorical_sample) and selects the first transition whose
float64 cumulative sum exceeds it.  This module reproduces that per
batched instance:

* per-instance uniform streams from numpy's ``RandomState(seed_i)``
  (`gen_streams`, through the native generator) or from the tensor
  MT19937 (core/mt19937.py), as the (hi, lo) words of each double's bit
  pattern, held in int64;
* float64 cumulative-sum thresholds from the padded transition tensors
  (byte-identical to the JAX package's, see core/tables);
* the threshold comparison in float64: non-negative doubles order like
  their bit patterns, so ``cum <= u`` on the reassembled doubles is the JAX
  package's (hi, lo) word compare.

A "parity step" mirrors the reference driver loop per instance: if the env
finished last step, consume one reset draw (ISD categorical), then consume
one transition draw.  An "event" (`parity_event_step`) consumes exactly one
draw per lane, on the reset or on the transition, so every lane's stream
cursor moves in lockstep: the form the CUDA parity kernel runs.

Tensors live where the state lies; the functions that create state or
streams take an explicit ``device``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import EnvConfig, N_ACTIONS
from . import tables


def f64_bits(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split float64 array into (hi, lo) uint32 bit-pattern words."""
    bits = np.ascontiguousarray(a, dtype=np.float64).view(np.uint64)
    return (bits >> np.uint64(32)).astype(np.uint32), \
        (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def f64_from_bits(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 words held in int64 -> the float64 they spell."""
    return ((hi.to(torch.int64) << 32) | lo.to(torch.int64)).view(
        torch.float64)


class ParityTables(NamedTuple):
    """Host-side (numpy) arrays, byte-equal to the JAX package's.

    * ``cum_pair`` [nS, R, 36, 2]: float64 cumulative-sum thresholds as
      (hi, lo) uint32 bit-pattern words, by (state, row);
    * ``meta`` [nS, R, 36, 4] int32: (next_raw, done, reward f32 bits,
      prob f32 bits) of each slot.

    The reference's argmax-over-empty fallback slot is not stored: the
    first in-list slot equals the count of zero cumulative sums, so it is
    recomputed from the thresholds.  ``key`` names the (cfg, frozen,
    policy) the tables were built from; it keys their per-device copies.
    """
    nS: int
    n_rows: int                # 25 joint (multiagent) or 5 (single-agent)
    raw_to_dense: np.ndarray   # [nRaw] int32
    cum_pair: np.ndarray       # [nS, R, 36, 2] uint32 (hi, lo)
    meta: np.ndarray           # [nS, R, 36, 4] int32
    isd_cum_hi: np.ndarray     # [nI] uint32
    isd_cum_lo: np.ndarray
    isd_raw: np.ndarray        # [nI] int32
    key: tuple = ()


@functools.lru_cache(maxsize=None)
def _parity_tables_cached(cfg: EnvConfig, frozen: Optional[str],
                          policy_key) -> ParityTables:
    tb = tables.build_tables(cfg)
    if frozen is None:
        arr = {"t_cum": tb.t_cum, "t_next_raw": tb.t_next_raw,
               "t_prob": tb.t_prob, "t_reward": tb.t_reward,
               "t_done": tb.t_done}
    else:
        arr = tables.collapse_single_agent(
            tb, frozen, np.asarray(policy_key, dtype=np.int32))
    cum_hi, cum_lo = f64_bits(arr["t_cum"])
    cum_pair = np.stack([cum_hi, cum_lo], axis=-1)
    meta = np.stack([
        arr["t_next_raw"].astype(np.int32),
        arr["t_done"].astype(np.int32),
        arr["t_reward"].astype(np.float32).view(np.int32),
        arr["t_prob"].astype(np.float32).view(np.int32),
    ], axis=-1)
    isd_hi, isd_lo = f64_bits(np.cumsum(tb.isd_probs))
    return ParityTables(
        nS=tb.nS, n_rows=arr["t_cum"].shape[1],
        raw_to_dense=tb.raw_to_dense,
        cum_pair=cum_pair, meta=meta,
        isd_cum_hi=isd_hi, isd_cum_lo=isd_lo,
        isd_raw=tb.isd_raw.astype(np.int32),
        key=(cfg, frozen, policy_key),
    )


def parity_tables(cfg: EnvConfig, frozen: Optional[str] = None,
                  policy=None) -> ParityTables:
    """Build (cached) parity tables.  ``frozen``/``policy`` mirror the
    facade's single-agent collapse: ``frozen`` is the player that plays
    ``policy`` [nS]."""
    key = None if policy is None else tuple(int(a) for a in np.asarray(policy))
    return _parity_tables_cached(cfg, frozen, key)


class _DeviceTables(NamedTuple):
    cum: torch.Tensor          # [nS, R, 36] float64
    next_raw: torch.Tensor     # [nS, R, 36] int32
    done: torch.Tensor         # [nS, R, 36] bool
    reward: torch.Tensor       # [nS, R, 36] float32
    prob: torch.Tensor         # [nS, R, 36] float32
    raw_to_dense: torch.Tensor  # [nRaw] int32
    isd_cum: torch.Tensor      # [nI] float64
    isd_raw: torch.Tensor      # [nI] int32


@functools.lru_cache(maxsize=8)
def _device_tables_cached(key: tuple, device: torch.device) -> _DeviceTables:
    pt = _parity_tables_cached(*key)
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    bits = (pt.cum_pair[..., 0].astype(np.uint64) << np.uint64(32)) \
        | pt.cum_pair[..., 1].astype(np.uint64)
    meta = pt.meta
    isd = (pt.isd_cum_hi.astype(np.uint64) << np.uint64(32)) \
        | pt.isd_cum_lo.astype(np.uint64)
    return _DeviceTables(
        cum=on(bits.view(np.float64)), next_raw=on(meta[..., 0]),
        done=on(meta[..., 1] != 0),
        reward=on(np.ascontiguousarray(meta[..., 2]).view(np.float32)),
        prob=on(np.ascontiguousarray(meta[..., 3]).view(np.float32)),
        raw_to_dense=on(pt.raw_to_dense), isd_cum=on(isd.view(np.float64)),
        isd_raw=on(pt.isd_raw))


def _device_tables(pt: ParityTables, device: torch.device) -> _DeviceTables:
    if not pt.key:
        raise ValueError("parity tables must come from parity_tables()")
    return _device_tables_cached(pt.key, torch.device(device))


def gen_streams(seeds, n_draws: int, device):
    """Per-instance MT19937 uniform streams as (hi, lo) uint32 bit words
    held in int64, [B, n_draws] each, on ``device``.  seeds[i] seeds
    instance i exactly like the reference's ctor/reset(seed)
    (``RandomState(seed_i)``, on the host).

    Draws through the threaded C++ generator (``native.mt19937_streams``)
    when it builds, else the numpy ``RandomState`` loop: the same bits."""
    from .. import native
    seeds = np.asarray(seeds)
    out = native.mt19937_streams(seeds, n_draws)
    if out is None:
        out = np.empty((len(seeds), n_draws), dtype=np.float64)
        for i, s in enumerate(seeds):
            out[i] = np.random.RandomState(int(s)).random_sample(n_draws)
    return tuple(torch.as_tensor(w.astype(np.int64), device=device)
                 for w in f64_bits(out))


class ParityState(NamedTuple):
    raw: torch.Tensor          # int32 [B] current state raw code
    t: torch.Tensor            # int32 [B] steps taken this episode
    cursor: torch.Tensor       # int32 [B] per-instance stream position
    needs_reset: torch.Tensor  # bool [B]


def parity_init(cfg: EnvConfig, batch_size: int, device) -> ParityState:
    zeros = torch.zeros(batch_size, dtype=torch.int32, device=device)
    return ParityState(raw=zeros, t=zeros, cursor=zeros,
                       needs_reset=torch.ones(batch_size, dtype=torch.bool,
                                              device=device))


class ParityOut(NamedTuple):
    obs: torch.Tensor        # int32 [B] dense observation
    reward_a: torch.Tensor   # float32 [B]
    done: torch.Tensor       # bool [B]
    truncated: torch.Tensor  # bool [B]
    prob: torch.Tensor       # float32 [B] (sampled transition probability)
    was_reset: torch.Tensor  # bool [B] (a reset draw was consumed this step)


def _pick_first_exceedance(cum_row: torch.Tensor, u: torch.Tensor):
    """Index of the first float64 threshold exceeding u.  When none does,
    the reference's argmax-over-empty selects the first in-list slot,
    which equals the count of zero thresholds (see ParityTables), clamped
    into the row like the JAX package's oracle."""
    n = cum_row.shape[-1]
    i = (cum_row <= u[..., None]).sum(-1)
    first = (cum_row == 0).sum(-1).clamp(max=n - 1)
    return torch.where(i >= n, first, i)


def _isd_pick(d: _DeviceTables, u: torch.Tensor) -> torch.Tensor:
    """Raw code of the ISD entry the reset draw ``u`` selects."""
    i = (d.isd_cum[None, :] <= u[:, None]).sum(-1).clamp(
        max=d.isd_raw.shape[0] - 1)
    return d.isd_raw[i]


def _take(stream_hi, stream_lo, cursor):
    bidx = torch.arange(cursor.shape[0], device=cursor.device)
    c = cursor.long()
    return f64_from_bits(stream_hi[bidx, c], stream_lo[bidx, c])


def parity_step(cfg: EnvConfig, pt: ParityTables, state: ParityState,
                row: Optional[torch.Tensor], stream_hi: torch.Tensor,
                stream_lo: torch.Tensor,
                pol_rows: Optional[torch.Tensor] = None
                ) -> tuple[ParityState, ParityOut]:
    """One reference-exact transition per instance.

    ``row``: int32 [B] table row (aa*5+ab joint index, or the learner's
    action in single-agent mode).  ``stream_hi/lo``: [B, n_draws] words
    from `gen_streams` or `mt19937.device_streams`.

    ``pol_rows``: optional int32 [nS] CLOSED-LOOP policy, the table row to
    play at each dense observation (see `policy_rows`).  When given,
    ``row`` is ignored and computed from the post-reset observation, like
    the reference main() driving ``policy[obs['player_a']]``
    (soccer_simultaneous_env.py:588-593).
    """
    d = _device_tables(pt, state.raw.device)

    # ---- optional reset draw (reference reset(), :410-424) ----
    reset_raw = _isd_pick(d, _take(stream_hi, stream_lo, state.cursor))
    was_reset = state.needs_reset
    raw = torch.where(was_reset, reset_raw, state.raw)
    t = torch.where(was_reset, 0, state.t)
    cursor = state.cursor + was_reset.to(torch.int32)

    # ---- transition draw (reference step(), :375-408) ----
    u = _take(stream_hi, stream_lo, cursor)
    s = d.raw_to_dense[raw.long()].long()
    if pol_rows is not None:
        row = pol_rows[s]
    row = row.long()
    i = _pick_first_exceedance(d.cum[s, row], u)
    # Absorbing goal rows point at the class representative; the actual
    # state self-loops (matches facade/reference semantics).
    ns_raw = torch.where(s == 0, raw, d.next_raw[s, row, i])
    t = t + 1
    truncated = t >= cfg.max_steps
    done = d.done[s, row, i]
    new = ParityState(raw=ns_raw, t=t, cursor=cursor + 1,
                      needs_reset=done | truncated)
    return new, ParityOut(obs=d.raw_to_dense[ns_raw.long()],
                          reward_a=d.reward[s, row, i], done=done,
                          truncated=truncated, prob=d.prob[s, row, i],
                          was_reset=was_reset)


def _stack(outs, cls):
    return cls(*(torch.stack(f) for f in zip(*outs)))


def parity_rollout(cfg: EnvConfig, pt: ParityTables, state: ParityState,
                   rows: torch.Tensor, stream_hi: torch.Tensor,
                   stream_lo: torch.Tensor):
    """Scripted rollout: rows [T, B] table-row indices per step.  Returns
    (final state, ParityOut of [T, B] tensors)."""
    outs = []
    for r in rows:
        state, out = parity_step(cfg, pt, state, r, stream_hi, stream_lo)
        outs.append(out)
    return state, _stack(outs, ParityOut)


def joint_row(actions_a, actions_b):
    return actions_a * N_ACTIONS + actions_b


def policy_rows(pt: ParityTables, policy_a=None, policy_b=None,
                device="cuda") -> torch.Tensor:
    """Dense-obs -> table-row map (int32 [nS] on ``device``, the card
    unless the caller asks for the CPU) for closed-loop rollouts.

    * single-agent tables (n_rows == 5, one side collapsed): pass the
      live side's deterministic policy [nS];
    * joint tables (n_rows == 25): pass both policies; the row is the
      joint index pol_a[s]*5 + pol_b[s].
    """
    as_rows = lambda p: torch.as_tensor(np.asarray(p), device=device).to(
        torch.int32)
    if pt.n_rows == N_ACTIONS:
        pol = policy_a if policy_a is not None else policy_b
        if pol is None:
            raise ValueError("single-agent tables need the live policy")
        return as_rows(pol)
    if policy_a is None or policy_b is None:
        raise ValueError("joint tables need both policies")
    return joint_row(as_rows(policy_a), as_rows(policy_b))


def parity_policy_rollout(cfg: EnvConfig, pt: ParityTables,
                          state: ParityState, pol_rows: torch.Tensor,
                          n_steps: int, stream_hi: torch.Tensor,
                          stream_lo: torch.Tensor):
    """Closed loop: the policy plays itself for ``n_steps`` ticks (episodes
    chain through reset draws exactly like the reference main()'s
    `while not all_done` / `env.reset()` loop, :569-597)."""
    pol_rows = pol_rows.to(state.raw.device).long()
    outs = []
    for _ in range(n_steps):
        state, out = parity_step(cfg, pt, state, None, stream_hi, stream_lo,
                                 pol_rows=pol_rows)
        outs.append(out)
    return state, _stack(outs, ParityOut)


def parity_policy_rollout_device(cfg: EnvConfig, pt: ParityTables, seeds,
                                 pol_rows: torch.Tensor, n_steps: int,
                                 device):
    """Closed-loop parity rollout with tensor MT19937 streams made on
    ``device`` (core/mt19937.py): whole policy evaluations, e.g. the
    reference main()'s 1000-episode VI eval, per lane from seeds."""
    from . import mt19937
    hi, lo = mt19937.device_streams(seeds, 2 * n_steps + 2, device)
    state = parity_init(cfg, hi.shape[0], device)
    return parity_policy_rollout(cfg, pt, state, pol_rows, n_steps, hi, lo)


class ParityEventOut(NamedTuple):
    """Per-EVENT outputs (see parity_event_step).  On reset events the
    transition fields (reward/done/truncated) are zeroed and ``was_reset``
    is True; ``obs``/``raw`` always hold the post-event state."""
    obs: torch.Tensor
    raw: torch.Tensor
    reward_a: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    was_reset: torch.Tensor


def parity_event_step(cfg: EnvConfig, pt: ParityTables, state: ParityState,
                      pol_rows: Optional[torch.Tensor], u_hi: torch.Tensor,
                      u_lo: torch.Tensor, row: Optional[torch.Tensor] = None
                      ) -> tuple[ParityState, ParityEventOut]:
    """One reference RNG draw per lane: EVENT time.

    Lanes needing a reset spend the draw ``(u_hi, u_lo)`` [B] on the ISD
    categorical (reference reset(), :410-424), all others on the
    transition categorical (step(), :394-396).  Per-lane draw order is the
    reference's reset/step/step/... sequence, and every lane's stream
    cursor advances in lockstep.  The transition plays ``pol_rows[s]``
    (int32 [nS]), or ``row`` [B] when it is given (a scripted row).
    """
    d = _device_tables(pt, state.raw.device)
    nr = state.needs_reset
    u = f64_from_bits(u_hi, u_lo)

    reset_raw = _isd_pick(d, u)

    s = d.raw_to_dense[state.raw.long()].long()
    if row is None:
        row = pol_rows[s]
    row = row.long()
    i = _pick_first_exceedance(d.cum[s, row], u)
    ns_raw = torch.where(s == 0, state.raw, d.next_raw[s, row, i])
    done = d.done[s, row, i]
    t2 = state.t + 1
    truncated = t2 >= cfg.max_steps

    new_raw = torch.where(nr, reset_raw, ns_raw)
    new = ParityState(raw=new_raw, t=torch.where(nr, 0, t2),
                      cursor=state.cursor + 1,
                      needs_reset=~nr & (done | truncated))
    out = ParityEventOut(
        obs=d.raw_to_dense[new_raw.long()], raw=new_raw,
        reward_a=torch.where(nr, 0.0, d.reward[s, row, i]),
        done=~nr & done, truncated=~nr & truncated, was_reset=nr)
    return new, out


def parity_policy_events(cfg: EnvConfig, pt: ParityTables,
                         state: ParityState, pol_rows: torch.Tensor,
                         n_events: int, stream_hi: torch.Tensor,
                         stream_lo: torch.Tensor):
    """Closed-loop EVENT-time loop: exactly one draw per lane per event
    (streams [B, n_events]).  The same trajectories as
    parity_policy_rollout, re-timed (see parity_event_step)."""
    pol_rows = pol_rows.to(state.raw.device).long()
    outs = []
    for k in range(n_events):
        state, out = parity_event_step(cfg, pt, state, pol_rows,
                                       stream_hi[:, k], stream_lo[:, k])
        outs.append(out)
    return state, _stack(outs, ParityEventOut)


def parity_rollout_device(cfg: EnvConfig, pt: ParityTables, seeds,
                          rows: torch.Tensor, device):
    """Parity rollout with tensor MT19937 streams made on ``device``: seeds
    in, bit-exact reference trajectories out, no host RNG.

    ``rows``: [T, B] table-row indices (see parity_rollout)."""
    from . import mt19937
    rows = torch.as_tensor(rows, device=device)
    hi, lo = mt19937.device_streams(seeds, 2 * rows.shape[0] + 2, device)
    state = parity_init(cfg, hi.shape[0], device)
    return parity_rollout(cfg, pt, state, rows, hi, lo)
