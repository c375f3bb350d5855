"""Host-side indexing layer of the state space (numpy only).

The port of ``build_isd`` and ``build_statespace`` from
gym_soccer_tpu/core/tables.py, copied so that their arrays are
byte-identical to the JAX package's (pinned by tests/test_torch_tables.py).
The full transition tensors (``build_tables``) and the native builder are
not on the device path and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..config import EnvConfig
from . import rules


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
