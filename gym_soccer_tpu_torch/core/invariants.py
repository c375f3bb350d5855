"""Invariant checks over batched runtime state: the port of
gym_soccer_tpu/core/invariants.py.

The reference guards its dynamics with plain asserts (probability sums
:285-287, no co-location :325-359, goal-state sanity :100-101) that only
run during table construction.  Here the equivalents run over batched
state:

* `state_invariants(cfg, state)` — boolean tensors [B] per invariant, all
  True on a healthy state;
* `assert_invariants(cfg, state)` — raises AssertionError naming the first
  broken invariant and its lanes;
* `checked_step(cfg)` — a batched step that checks the invariants before
  and after and the actions' range, and raises ValueError naming the
  broken one (the JAX package's ``checkify`` wrapper, as explicit checks:
  one device read a check; the production path stays check-free).
"""
from __future__ import annotations

import torch

from ..config import EnvConfig, N_ACTIONS
from . import batch, rules


def state_invariants(cfg: EnvConfig, state: batch.EnvState) -> dict:
    """Boolean tensors [B], all True on a healthy state."""
    in_rows = lambda x: (x >= 0) & (x < cfg.H)  # noqa: E731
    in_cols = lambda y: (y >= 0) & (y < cfg.W)  # noqa: E731
    bounds = (in_rows(state.rows_a) & in_cols(state.cols_a) &
              in_rows(state.rows_b) & in_cols(state.cols_b))
    distinct = ~((state.rows_a == state.rows_b) &
                 (state.cols_a == state.cols_b))
    poss_ok = (state.poss == 0) | (state.poss == 1)
    t_ok = (state.t >= 0) & (state.t < cfg.max_steps)
    # live states are never terminal (autoreset) nor unreachable
    unreach = rules.is_unreachable(
        torch, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, cfg)
    goal = rules.is_goal_state(
        torch, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, cfg)
    return {
        "in_bounds": bounds,
        "players_distinct": distinct,
        "possession_binary": poss_ok,
        "timestep_in_range": t_ok,
        "reachable": ~unreach,
        "not_absorbed": ~goal,
    }


def assert_invariants(cfg: EnvConfig, state: batch.EnvState) -> None:
    """Host-side hard assertion (tests, debugging)."""
    for name, ok in state_invariants(cfg, state).items():
        bad = torch.nonzero(~ok).flatten()
        assert bad.numel() == 0, \
            f"invariant {name} violated at lanes {bad[:8].tolist()}"


def _check(cond: torch.Tensor, msg: str) -> None:
    if not bool(cond.all()):
        raise ValueError(msg)


def checked_step(cfg: EnvConfig, rng: str = "threefry"):
    """A batched step ``stepper(state, aa, ab) -> (state, StepOut)`` that
    raises ValueError naming the first violated invariant: the state's
    before the step, the actions' range, the state's after it."""
    def stepper(state, aa, ab):
        for name, ok in state_invariants(cfg, state).items():
            _check(ok, f"pre-step invariant {name} violated")
        _check((aa >= 0) & (aa < N_ACTIONS) & (ab >= 0) & (ab < N_ACTIONS),
               "actions out of range")
        new, out = batch.step(cfg, state, aa, ab, rng=rng)
        for name, ok in state_invariants(cfg, new).items():
            _check(ok, f"post-step invariant {name} violated")
        return new, out

    return stepper
