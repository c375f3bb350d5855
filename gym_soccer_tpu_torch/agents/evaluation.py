"""Markov-game solution tools: Shapley iteration and exploitability.

The port of gym_soccer_tpu/agents/evaluation.py, in plain PyTorch on any
device:

* `shapley_iteration` — equilibrium value iteration for the
  simultaneous-move game: V(s) <- value(Q_V(s, ., .)), with the 5x5
  zero-sum matrix game of every state solved by RM+ (agents/learners);
* `best_response_value` — the value of the optimal counter-strategy to a
  FIXED (possibly mixed) opponent policy, by single-agent value iteration
  on the induced MDP;
* `exploitability` — BR_A(pi_b) + BR_B(pi_a) at the initial state
  distribution; 0 exactly at a Nash equilibrium;
* `greedy_win_share` / `win_share` — the JAX package's best-response gate
  score (tests/test_learner_kernel.py:478-486): two deterministic policies
  played on the batched engine, player A's share of the ended episodes.

All operate on the padded joint transition tensors [nS, 5, 5, 36]
(core/tables.build_tables).  The iterations loop on the host and read the
convergence test every ``segment_sweeps``/``segment_iters`` sweeps (every
sweep when 0); ``max_iters`` caps the sweeps without overshoot, as in the
JAX package.  ``joint_tensors`` and ``shapley_iteration`` run on
``device="cuda"`` unless the caller passes "cpu"; the best-response
functions run where their policy tensors lie.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import EnvConfig, N_ACTIONS
from ..core import batch, tables
from .learners import _fma_dot, solve_matrix_games


class JointTensors(NamedTuple):
    prob: torch.Tensor        # [nS, 5, 5, K] float32
    next_dense: torch.Tensor  # [nS, 5, 5, K] int64
    reward: torch.Tensor      # [nS, 5, 5, K] float32
    done: torch.Tensor        # [nS, 5, 5, K] bool
    isd_probs: torch.Tensor   # [nI] float32
    isd_obs: torch.Tensor     # [nI] int64


def joint_tensors(cfg: EnvConfig, device="cuda") -> JointTensors:
    """The joint transition tensors on ``device`` (built once for each)."""
    return _joint_tensors(cfg, torch.device(device))


@functools.lru_cache(maxsize=None)
def _joint_tensors(cfg: EnvConfig, device: torch.device) -> JointTensors:
    tb = tables.build_tables(cfg)
    shape = (tb.nS, N_ACTIONS, N_ACTIONS, tb.t_prob.shape[-1])

    def put(a, dtype):
        return torch.as_tensor(a.reshape(shape) if a.ndim == 3 else a,
                               device=device).to(dtype)

    return JointTensors(
        prob=put(tb.t_prob, torch.float32),
        next_dense=put(tb.t_next_dense, torch.int64),
        reward=put(tb.t_reward, torch.float32),
        done=put(tb.t_done, torch.bool),
        isd_probs=put(tb.isd_probs, torch.float32),
        isd_obs=put(tb.raw_to_dense[tb.isd_raw], torch.int64),
    )


def _joint_backup(jt: JointTensors, V, gamma):
    """Q[s, aa, ab] = sum_k p * (r + gamma * V[ns] * !done)."""
    cont = torch.where(jt.done, 0.0, V[jt.next_dense])
    return (jt.prob * (jt.reward + gamma * cont)).sum(-1)


def _sweeps(step, V, theta: float, max_iters: int, segment: int):
    """Apply ``step`` (V -> (V', aux)) until the last sweep of a segment
    moves V by less than ``theta`` in max norm, or ``max_iters`` sweeps.
    Returns (V, aux of the last sweep or None, sweep count)."""
    cc, aux = 0, None
    seg = max(segment, 1)
    while cc < max_iters:
        n = min(seg, max_iters - cc)   # the last segment never overshoots
        for _ in range(n):
            newV, aux = step(V)
            delta = (newV - V).abs().max()
            V = newV
        cc += n
        if float(delta) < theta:
            break
    return V, aux, cc


def shapley_iteration(cfg: EnvConfig, gamma: float = 0.99,
                      theta: float = 1e-6, max_iters: int = 2000,
                      solver_iters: int = 200, segment_sweeps: int = 0,
                      device="cuda"):
    """Equilibrium solve of the zero-sum Markov game (to RM+ tolerance).
    Returns (V, pi_a, pi_b, Q, iterations).

    With ``segment_sweeps`` == 0 the returned V and strategies are the
    last sweep's; with ``segment_sweeps`` > 0 the states' games are solved
    once more from the final V, as in the JAX package's two editions."""
    jt = joint_tensors(cfg, device)
    nS = jt.prob.shape[0]
    V = torch.zeros(nS, dtype=torch.float32, device=jt.prob.device)
    pi0 = torch.full((nS, N_ACTIONS), 1.0 / N_ACTIONS, dtype=torch.float32,
                     device=V.device)

    def sweep(V):
        newV, x, y = solve_matrix_games(_joint_backup(jt, V, gamma),
                                        iters=solver_iters)
        return newV, (x, y)

    V, pis, cc = _sweeps(sweep, V, theta, max_iters, segment_sweeps)
    pi_a, pi_b = pis if pis is not None else (pi0, pi0)
    Q = _joint_backup(jt, V, gamma)
    if segment_sweeps > 0:
        V, pi_a, pi_b = solve_matrix_games(Q, iters=solver_iters)
    return V, pi_a, pi_b, Q, cc


def best_response_value(cfg: EnvConfig, pi_opp, side: str,
                        gamma: float = 0.99, theta: float = 1e-6,
                        max_iters: int = 5000, segment_iters: int = 0,
                        device=None):
    """Value of the optimal deterministic counter-strategy for ``side``
    ('player_a' or 'player_b') against a fixed mixed opponent policy
    pi_opp [nS, 5], on pi_opp's device (or ``device``).  Rewards are from
    ``side``'s perspective (B maximizes -reward_a).  Returns
    (V_br [nS], pi_br [nS])."""
    if side not in ("player_a", "player_b"):
        raise ValueError(f"side must be 'player_a' or 'player_b', got {side!r}")
    pi_opp = torch.as_tensor(pi_opp, dtype=torch.float32, device=device)
    jt = joint_tensors(cfg, pi_opp.device)
    pi64 = pi_opp.double()

    def backup(V):
        if side == "player_a":   # A picks rows against B's mixture
            q = _joint_backup(jt, V, gamma)
            return _fma_dot(q.double(), pi64)
        q = _joint_backup(jt, -V, gamma)   # B picks columns against A's
        return -_fma_dot(q.transpose(-1, -2).double(), pi64)

    V = torch.zeros(jt.prob.shape[0], dtype=torch.float32,
                    device=pi_opp.device)
    V, _, _ = _sweeps(lambda V: (backup(V).max(-1).values, None), V, theta,
                      max_iters, segment_iters)
    return V, backup(V).argmax(-1)


def start_value(cfg: EnvConfig, V) -> float:
    """Expectation of V over the initial state distribution."""
    jt = joint_tensors(cfg, V.device)
    return float((jt.isd_probs * V[jt.isd_obs]).sum())


def exploitability(cfg: EnvConfig, pi_a, pi_b, gamma: float = 0.99,
                   segment_iters: int = 0, device=None) -> float:
    """BR_A(pi_b) + BR_B(pi_a) at the ISD; >= 0, and 0 iff (pi_a, pi_b)
    is a Nash equilibrium of the discounted game."""
    va, _ = best_response_value(cfg, pi_b, "player_a", gamma,
                                segment_iters=segment_iters, device=device)
    vb, _ = best_response_value(cfg, pi_a, "player_b", gamma,
                                segment_iters=segment_iters, device=device)
    return start_value(cfg, va) + start_value(cfg, vb)


def win_share(out: batch.StepOut) -> float:
    """Player A's wins over the episodes that ended in a rollout's stacked
    StepOut: ``((reward_a > 0) & done).sum() / (done | truncated).sum()``,
    as the JAX package's best-response gate counts them."""
    wins = int(((out.reward_a > 0) & out.done).sum())
    return wins / int((out.done | out.truncated).sum())


def greedy_win_share(cfg: EnvConfig, pol_a, pol_b, lanes: int = 2048,
                     steps: int = 400, seed: int = 9,
                     device="cuda") -> float:
    """``win_share`` of the deterministic int [nS] policies ``pol_a`` and
    ``pol_b`` played against each other for ``steps`` steps on ``lanes``
    lanes of the counter-RNG batched engine (core/batch.rollout, with
    autoreset).  The lanes' key words come from numpy's
    ``default_rng(seed)``; the JAX gate plays its threefry engine from
    ``key(seed)``, so this is a statistical twin of its score, not a bit
    twin."""
    device = torch.device(device)
    key_words = np.random.default_rng(seed).integers(
        0, 2 ** 32, (lanes, 2), dtype=np.uint64)
    state = batch.init_from_keys(cfg, key_words, device, rng="counter")
    pa = torch.as_tensor(pol_a, device=device).long()
    pb = torch.as_tensor(pol_b, device=device).long()
    _, out = batch.rollout(cfg, state,
                           lambda obs, i: (pa[obs.long()], pb[obs.long()]),
                           steps, rng="counter")
    return win_share(out)
