"""Batched zero-sum matrix-game solver and the alternating game's greedy
policy (plain PyTorch).

The port of ``solve_matrix_games`` and ``altq_greedy_policy`` from
gym_soccer_tpu/agents/learners.py.  The JAX package's generic learners
(IQL, minimax-Q and alternating Q over the batched engine) are not ported
yet; the fused trainers in ops/learner_kernel.py and the evaluation tools
use this solver.
"""
from __future__ import annotations

import torch


def _fma_dot(P64, Z64):
    """sum_j P[..., i, j] * Z[..., j] as a chain of float32 fused
    multiply-adds in j order, starting from 0: how XLA on the CPU lowers
    the JAX package's small einsum contractions.  ``P64``/``Z64`` hold
    float32 values in float64, where each product is exact; the sum with
    the float32 accumulator is rounded once more to float32 (it differs
    from a true FMA only when the float64 sum is inexact and lands on a
    float32 rounding midpoint)."""
    prod = P64 * Z64.unsqueeze(-2)
    acc = prod[..., 0].float()
    for j in range(1, prod.shape[-1]):
        acc = (prod[..., j] + acc.double()).float()
    return acc


def _seq_sum(a):
    """Sum over the last axis in index order (XLA's CPU reduction order)."""
    s = a[..., 0]
    for j in range(1, a.shape[-1]):
        s = s + a[..., j]
    return s


def solve_matrix_games(M: torch.Tensor, iters: int = 100):
    """Approximately solve max_x min_y x^T M y for a batch of float32
    zero-sum games M [..., nA, nA] by Regret Matching+ self-play with
    linear averaging, ``iters`` iterations.

    Returns (value, x, y): the game values [...] and the averaged mixed
    strategies of the row maximizer and the column minimizer [..., nA].

    RM+ amplifies rounding differences (one ulp grows to ~1e-3 in the
    strategies over a hundred iterations), so the arithmetic follows the
    JAX package's on the CPU operation for operation: contractions are
    FMA chains (``_fma_dot``), sums run in index order.  The row and
    column players are stacked on a leading axis of size 2, so that each
    iteration is one set of tensor operations for both (the loop is
    launch-bound on a GPU); every element sees the same arithmetic as in
    the unstacked form, since -(a - b) == b - a exactly.
    """
    nA = M.shape[-1]
    # P[0] = M (row payoffs M @ y), P[1] = M^T (column payoffs x @ M)
    P64 = torch.stack([M, M.transpose(-1, -2)]).double()
    uniform = torch.full((2,) + M.shape[:-1], 1.0 / nA, dtype=M.dtype,
                         device=M.device)
    sign = torch.tensor([1.0, -1.0], dtype=M.dtype, device=M.device).reshape(
        (2,) + (1,) * (M.dim() - 1))
    R = torch.zeros_like(uniform)   # cumulative regrets (rx, ry)
    S = torch.zeros_like(uniform)   # weighted strategy sums (sx, sy)

    for t in range(iters):
        s = _seq_sum(R).unsqueeze(-1)
        X = torch.where(s > 0, R / s.clamp_min(1e-30), uniform)   # (x, y)
        pay = _fma_dot(P64, X.flip(0).double())       # (M @ y, x @ M)
        vx = _seq_sum(X[0] * pay[0]).unsqueeze(-1)    # x . (M @ y)
        # RM+: rx += my - vx, ry += vx - xm, truncated at zero
        R = (R + (pay - vx) * sign).clamp_min(0.0)
        # linear averaging, S += (t + 1) * X as an FMA
        S = (X.double() * float(t + 1) + S.double()).float()
    X = S / _seq_sum(S).unsqueeze(-1)
    x, y = X[0], X[1]
    xm = _fma_dot(P64[1], x.double())
    value = _seq_sum(xm * y)
    return value, x, y


def altq_greedy_policy(cfg, q) -> torch.Tensor:
    """The mover's greedy policy per dense state of the alternating game:
    argmax at A-to-move states, argmin at B-to-move states (``q`` [nS, 5]
    is A-perspective), the lowest index on a tie; int32 [nS] on ``q``'s
    device."""
    from ..envs.soccer_alternating_env import build_alt_tables
    q = torch.as_tensor(q)
    turn = torch.as_tensor(build_alt_tables(cfg).turn, device=q.device)
    return torch.where(turn == 0, q.argmax(-1), q.argmin(-1)).to(torch.int32)
