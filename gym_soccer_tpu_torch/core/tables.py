"""Host-side indexing layer of the state space (numpy only).

The port of ``build_isd``, ``build_statespace``, ``build_tables`` and
``collapse_single_agent`` from gym_soccer_tpu/core/tables.py, copied so
that their arrays are byte-identical to the JAX package's (pinned by
tests/test_torch_tables.py, tests/test_torch_evaluation.py and
tests/test_torch_parity.py).  ``build_tables`` has the JAX package's two
backends, the threaded C++ builder (``native``) and the vectorized numpy
one, which give byte-identical tensors (tests/test_torch_native.py).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from ..config import (COMBO_VARIANT_A, COMBO_VARIANT_B, MAX_TRANSITIONS,
                      MOVES, N_ACTIONS, N_COMBOS, EnvConfig, orthogonal_moves)
from . import rules


@dataclasses.dataclass
class GameTables:
    cfg: EnvConfig
    nS: int
    # Raw mixed-radix code <-> dense observation index
    raw_to_dense: np.ndarray      # [nRaw] int32; -1 unreachable, 0 goal
    dense_to_raw: np.ndarray      # [nS] int32; s=0 holds a goal representative
    fields: np.ndarray            # [nS, 5] int32 (xa, ya, xb, yb, p)
    goal_mask_raw: np.ndarray     # [nRaw] bool
    goal_reward_raw: np.ndarray   # [nRaw] float64 (A-perspective)
    unreachable_raw: np.ndarray   # enumeration-ordered raw codes
    goal_raw: np.ndarray          # enumeration-ordered raw codes of goals
    # Initial state distribution (reference _generate_isd, :146-165)
    isd_probs: np.ndarray         # [nI] float64
    isd_raw: np.ndarray           # [nI] int32
    # Padded transition tensors, joint-action-major: ja = aa * nA + ab
    t_prob: np.ndarray            # [nS, nA*nA, 36] float64
    t_cum: np.ndarray             # [nS, nA*nA, 36] float64 cumulative sums
    t_next_raw: np.ndarray        # [nS, nA*nA, 36] int32
    t_next_dense: np.ndarray      # [nS, nA*nA, 36] int32
    t_reward: np.ndarray          # [nS, nA*nA, 36] float64 (A-perspective)
    t_done: np.ndarray            # [nS, nA*nA, 36] bool
    t_mask: np.ndarray            # [nS, nA*nA, 36] bool
    t_first: np.ndarray           # [nS, nA*nA] int32: first in-list slot

    @property
    def n_goal(self) -> int:
        return int(self.goal_raw.size)

    @property
    def n_unreachable(self) -> int:
        return int(self.unreachable_raw.size)


def _move_variants():
    """[nA, 3, 2] array: per action, the (dcol, drow) of the intended move
    and its two orthogonal slips, in the reference's order (:203-206)."""
    out = np.zeros((N_ACTIONS, 3, 2), dtype=np.int32)
    for a, m in enumerate(MOVES):
        o0, o1 = orthogonal_moves(m)
        out[a, 0] = m
        out[a, 1] = o0
        out[a, 2] = o1
    return out


def build_isd(cfg: EnvConfig):
    """Initial state distribution, reference order (:146-165)."""
    col_a, col_b = 2, cfg.W - 3
    entries = []
    gr = cfg.goal_rows
    if len(gr) % 2 == 0:
        mid = len(gr) // 2
        row_options = [gr[mid - 1], gr[mid]]
        for row_a in row_options:
            row_b = row_options[1] if row_a == row_options[0] else row_options[0]
            for possession in range(2):
                entries.append((0.25, (row_a, col_a, row_b, col_b, possession)))
    else:
        middle_row = gr[len(gr) // 2]
        for possession in range(2):
            entries.append((0.5, (middle_row, col_a, middle_row, col_b, possession)))
    probs = np.array([e[0] for e in entries], dtype=np.float64)
    raws = np.array(
        [rules.raw_encode(np, *np.array(e[1], dtype=np.int64), cfg)
         for e in entries], dtype=np.int32)
    return probs, raws


def isd_fields(cfg: EnvConfig) -> np.ndarray:
    """The ISD entries' state fields (xa, ya, xb, yb, p), int32 [nI, 5]."""
    _, raws = build_isd(cfg)
    return np.stack([np.array(rules.raw_decode(np, int(r), cfg), np.int32)
                     for r in raws])


@dataclasses.dataclass
class StateSpace:
    """The cheap indexing layer alone: O(n_raw) memory, no transition
    tensors.  Enough for the batched engine (dense observations, ISD)."""
    cfg: EnvConfig
    nS: int
    raw_to_dense: np.ndarray
    dense_to_raw: np.ndarray
    fields: np.ndarray
    goal_mask_raw: np.ndarray
    goal_reward_raw: np.ndarray
    unreachable_raw: np.ndarray
    goal_raw: np.ndarray
    isd_probs: np.ndarray
    isd_raw: np.ndarray


@functools.lru_cache(maxsize=None)
def build_statespace(cfg: EnvConfig) -> StateSpace:
    n_raw = cfg.n_raw
    raw = np.arange(n_raw, dtype=np.int32)
    xa, ya, xb, yb, p = rules.raw_decode(np, raw, cfg)

    unreach = rules.is_unreachable(np, xa, ya, xb, yb, p, cfg)
    goal = ~unreach & rules.is_goal_state(np, xa, ya, xb, yb, p, cfg)
    reach = ~unreach & ~goal

    raw_to_dense = np.full(n_raw, -1, dtype=np.int32)
    # Dense indices assigned in enumeration order starting at 1 (:64-106).
    raw_to_dense[reach] = np.cumsum(reach)[reach].astype(np.int32)
    raw_to_dense[goal] = 0
    nS = int(reach.sum()) + 1

    goal_raw = raw[goal].astype(np.int32)
    unreachable_raw = raw[unreach].astype(np.int32)

    dense_to_raw = np.zeros(nS, dtype=np.int32)
    dense_to_raw[raw_to_dense[reach]] = raw[reach]
    # s=0 representative: the LAST goal state in enumeration order, matching
    # the reference's repeated overwrite of P[0] (:182-184).
    dense_to_raw[0] = goal_raw[-1]

    goal_reward_raw = np.where(
        goal, rules.goal_reward_a(np, xa, ya, xb, yb, p, cfg), 0.0)

    fxa, fya, fxb, fyb, fp = rules.raw_decode(np, dense_to_raw, cfg)
    fields = np.stack([fxa, fya, fxb, fyb, fp], axis=-1).astype(np.int32)

    isd_probs, isd_raw = build_isd(cfg)
    return StateSpace(
        cfg=cfg, nS=nS, raw_to_dense=raw_to_dense,
        dense_to_raw=dense_to_raw, fields=fields, goal_mask_raw=goal,
        goal_reward_raw=goal_reward_raw, unreachable_raw=unreachable_raw,
        goal_raw=goal_raw, isd_probs=isd_probs, isd_raw=isd_raw)


def build_tables(cfg: EnvConfig, backend: str | None = None) -> GameTables:
    """The full padded transition tensors [nS, 25, 36]: 9 slip combos x 4
    outcome slots per joint action, in the reference's list order
    (:167-293), with probability 0 on invalid slots and dropped combos.

    ``backend``: 'native' (the C++ threaded builder), 'numpy' (vectorized
    broadcast), or None = the GYM_SOCCER_TPU_TABLES environment variable,
    by default 'auto' (native when g++ builds it, else numpy).  Both give
    byte-identical tensors.  'native' raises RuntimeError when the library
    cannot be built; an unknown backend raises ValueError.  The variable
    is the JAX package's own, read the same way, so a deployment that
    sets it there keeps its choice after moving to the port: 'native' in
    CI, where a missing compiler should fail the run rather than fall back
    silently, or 'numpy' where no compiler may be started."""
    ss = build_statespace(cfg)
    if backend is None:
        backend = os.environ.get("GYM_SOCCER_TPU_TABLES", "auto")
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown tables backend {backend!r} "
                         "(expected 'auto', 'native' or 'numpy')")
    if backend in ("auto", "native"):
        tb = _build_tables_native(cfg, ss)
        if tb is not None:
            return tb
        if backend == "native":
            raise RuntimeError("native table builder unavailable "
                               "(g++ missing or build failed)")
    return _build_tables_numpy(cfg, ss)


def _from_parts(cfg: EnvConfig, ss: StateSpace, parts: dict) -> GameTables:
    return GameTables(
        cfg=cfg, nS=ss.nS,
        raw_to_dense=ss.raw_to_dense, dense_to_raw=ss.dense_to_raw,
        fields=ss.fields, goal_mask_raw=ss.goal_mask_raw,
        goal_reward_raw=ss.goal_reward_raw,
        unreachable_raw=ss.unreachable_raw, goal_raw=ss.goal_raw,
        isd_probs=ss.isd_probs, isd_raw=ss.isd_raw, **parts)


def _build_tables_native(cfg: EnvConfig, ss: StateSpace) -> GameTables | None:
    from .. import native

    lo, hi = cfg.goal_row_bounds
    parts = native.build_tables_arrays(
        cfg.W, cfg.H, lo, hi, cfg.combo_probs(), ss.dense_to_raw,
        ss.raw_to_dense, ss.goal_mask_raw, ss.goal_reward_raw)
    if parts is None:
        return None
    return _from_parts(cfg, ss, parts)


def _build_tables_numpy(cfg: EnvConfig, ss: StateSpace) -> GameTables:
    nS = ss.nS
    raw_to_dense = ss.raw_to_dense
    dense_to_raw = ss.dense_to_raw
    goal_mask_raw = ss.goal_mask_raw
    goal_reward_raw = ss.goal_reward_raw
    fields = ss.fields
    fxa, fya, fxb, fyb, fp = (fields[:, i] for i in range(5))

    # ---- joint transition tensors -------------------------------------
    mv = _move_variants()  # [nA, 3, 2]
    va = np.array(COMBO_VARIANT_A)  # [9]
    vb = np.array(COMBO_VARIANT_B)
    # Effective (dcol, drow) per (action, combo): [nA, 9]
    a_mc, a_mr = mv[:, va, 0], mv[:, va, 1]
    b_mc, b_mr = mv[:, vb, 0], mv[:, vb, 1]

    # Broadcast layout: [nS, aa, ab, combo]
    sxa = fxa[:, None, None, None]
    sya = fya[:, None, None, None]
    sxb = fxb[:, None, None, None]
    syb = fyb[:, None, None, None]
    sp = fp[:, None, None, None]
    aa = np.arange(N_ACTIONS, dtype=np.int32)[None, :, None, None]
    ab = np.arange(N_ACTIONS, dtype=np.int32)[None, None, :, None]
    mca = a_mc.reshape(1, N_ACTIONS, 1, N_COMBOS)
    mra = a_mr.reshape(1, N_ACTIONS, 1, N_COMBOS)
    mcb = b_mc.reshape(1, 1, N_ACTIONS, N_COMBOS)
    mrb = b_mr.reshape(1, 1, N_ACTIONS, N_COMBOS)

    out = rules.resolve_outcomes(np, sxa, sya, sxb, syb, sp, aa, ab,
                                 mca, mra, mcb, mrb, cfg)
    # Outcome arrays: [nS, nA, nA, 9, 4]
    ns_raw = rules.raw_encode(np, out["rows_a"], out["cols_a"],
                              out["rows_b"], out["cols_b"], out["poss"], cfg)

    mp = np.array(cfg.combo_probs(), dtype=np.float64)  # [9]
    prob = out["weight"] * mp[None, None, None, :, None]
    mask = (out["weight"] > 0) & (mp[None, None, None, :, None] != 0.0)
    prob = np.where(mask, prob, 0.0)

    st_raw = dense_to_raw[:, None, None, None, None]
    done = goal_mask_raw[ns_raw]
    reward = np.where(done & (ns_raw != st_raw), goal_reward_raw[ns_raw], 0.0)
    # Absorbing goal rows: done=True, reward=0 (:235-236) — covered, since
    # their only outcome is ns == st.

    shape = (nS, N_ACTIONS * N_ACTIONS, MAX_TRANSITIONS)
    t_prob = np.ascontiguousarray(prob.reshape(shape))
    t_next_raw = np.ascontiguousarray(ns_raw.reshape(shape)).astype(np.int32)
    t_next_dense = raw_to_dense[t_next_raw]
    t_reward = np.ascontiguousarray(reward.reshape(shape))
    t_done = np.ascontiguousarray(done.reshape(shape))
    t_mask = np.ascontiguousarray(mask.reshape(shape))
    t_cum = np.cumsum(t_prob, axis=-1)
    t_first = np.argmax(t_mask, axis=-1).astype(np.int32)

    return _from_parts(cfg, ss, dict(
        t_prob=t_prob, t_cum=t_cum, t_next_raw=t_next_raw,
        t_next_dense=t_next_dense, t_reward=t_reward, t_done=t_done,
        t_mask=t_mask, t_first=t_first))


def collapse_single_agent(tb: GameTables, frozen: str, policy: np.ndarray):
    """Collapse the joint tensors to single-agent tables by substituting the
    frozen player's policy at build time (reference :187-188) and flipping
    rewards when the learner is player B (:242-244).

    ``frozen`` is 'player_a' or 'player_b' (the one WITH the policy);
    ``policy`` is an int array [nS] of that player's action per dense state.

    Returns dict of [nS, nA, 36] arrays plus the recomputed cumsums.
    """
    nA = N_ACTIONS
    pol = np.asarray(policy, dtype=np.int64).reshape(tb.nS)
    shape5 = (tb.nS, nA, nA, MAX_TRANSITIONS)

    def pick(arr):
        a5 = arr.reshape(shape5)
        if frozen == "player_b":
            # learner A chooses aa; ab = pol[s]
            return np.take_along_axis(
                a5, pol[:, None, None, None], axis=2)[:, :, 0, :]
        # learner B chooses ab; aa = pol[s]
        return np.take_along_axis(
            a5, pol[:, None, None, None], axis=1)[:, 0, :, :]

    reward = pick(tb.t_reward)
    if frozen == "player_a":
        reward = -1 * reward  # learner is B: sign flip at build time (:242-244)
    out = {
        "t_prob": pick(tb.t_prob),
        "t_next_raw": pick(tb.t_next_raw),
        "t_next_dense": pick(tb.t_next_dense),
        "t_reward": reward,
        "t_done": pick(tb.t_done),
        "t_mask": pick(tb.t_mask),
    }
    out["t_cum"] = np.cumsum(out["t_prob"], axis=-1)
    out["t_first"] = np.argmax(out["t_mask"], axis=-1).astype(np.int32)
    return out
