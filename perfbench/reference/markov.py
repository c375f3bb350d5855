"""Plain reference of the zero-sum Markov game's model, of RM+ on its 5x5
stage games and of best-response value iteration.

The model is built here from the published rules, not taken from the
program: the dense state index (goal states merged into index 0, the other
reachable states numbered from 1 in raw-code order), each joint action's
outcomes over the nine slip combinations and the collision chain's
outcome slots with their probabilities, rewards and terminal flags, and
the initial-state distribution.  Value iteration and RM+ are plain
PyTorch, in float64 by default; ``dtype`` selects another precision (the
control's bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

from .game import MOVES, Board


def _fields_of(b: Board, raw):
    p = raw % 2
    x = raw // 2
    cb = x % b.W
    x = x // b.W
    rb = x % b.H
    x = x // b.H
    return x // b.W, x % b.W, rb, cb, p


def _goal_state(b: Board, ra, ca, rb, cb, p):
    ga = (p == 0) & (ra >= b.glo) & (ra <= b.ghi) & ((ca == 0) | (ca == b.W - 1))
    gb = (p == 1) & (rb >= b.glo) & (rb <= b.ghi) & ((cb == 0) | (cb == b.W - 1))
    return ga | gb


def _unreachable(b: Board, ra, ca, rb, cb, p):
    in_a = (ra >= b.glo) & (ra <= b.ghi)
    in_b = (rb >= b.glo) & (rb <= b.ghi)
    edge_a = (ca == 0) | (ca == b.W - 1)
    edge_b = (cb == 0) | (cb == b.W - 1)
    corner = (edge_a & ~in_a) | (edge_b & ~in_b)
    goal_no_ball = (in_a & edge_a & (p != 0)) | (in_b & edge_b & (p != 1))
    return corner | goal_no_ball | ((ra == rb) & (ca == cb))


class StateSpace:
    """raw code -> dense index (-1 unreachable, 0 every goal state)."""

    def __init__(self, b: Board):
        raw = np.arange(b.n_raw, dtype=np.int64)
        f = _fields_of(b, raw)
        unreach = _unreachable(b, *f)
        goal = ~unreach & _goal_state(b, *f)
        reach = ~unreach & ~goal
        self.raw_to_dense = np.full(b.n_raw, -1, np.int64)
        self.raw_to_dense[reach] = np.arange(1, int(reach.sum()) + 1)
        self.raw_to_dense[goal] = 0
        self.nS = int(reach.sum()) + 1
        self.dense_raw = np.concatenate([[raw[goal][-1]], raw[reach]])
        self.goal_raw = goal
        self.isd_dense = np.array([self.raw_to_dense[b.raw_code(*e[1])]
                                   for e in b.isd])
        self.isd_probs = np.array([e[0] for e in b.isd])


def _np_next_cell(b: Board, r, c, dc, dr, ball):
    nr = np.clip(r + dr, 0, b.H - 1)
    nc = c + dc
    edge = (nc == 0) | (nc == b.W - 1)
    scores = edge & (nr >= b.glo) & (nr <= b.ghi) & ball
    return nr, np.where(edge & ~scores, c, nc)


def build_model(b: Board):
    """Joint outcome arrays [nS, 5, 5, 36] (9 slip combinations x 4
    collision slots): probability, next dense state, player A's reward,
    terminal flag; and the StateSpace."""
    ss = StateSpace(b)
    q = b.slip_prob
    # a move and its two orthogonal slips, with their probabilities
    var = np.array([[m, (-m[1], m[0]), (m[1], -m[0])] for m in MOVES])
    var_p = np.array([1 - q, q / 2, q / 2])
    S = ss.dense_raw[:, None, None, None, None]
    ra, ca, rb, cb, p = _fields_of(b, S)
    aa = np.arange(5)[None, :, None, None, None]
    ab = np.arange(5)[None, None, :, None, None]
    va = np.arange(3)[None, None, None, :, None]
    vb = np.arange(3)[None, None, None, None, :]
    nra, nca = _np_next_cell(b, ra, ca, var[aa, va, 0], var[aa, va, 1],
                             p == 0)
    nrb, ncb = _np_next_cell(b, rb, cb, var[ab, vb, 0], var[ab, vb, 1],
                             p == 1)
    c1 = ((ra == rb) & (np.abs(ca - cb) == 1) & (nca == cb) & (ncb == ca)) | \
         ((ca == cb) & (np.abs(ra - rb) == 1) & (nra == rb) & (nrb == ra))
    c2 = ~c1 & (((nra == rb) & (nca == cb) & (ab == 0)) |
                ((nrb == ra) & (ncb == ca) & (aa == 0)))
    c3 = ~c1 & ~c2 & (
        ((ra == nra) & (ca == nca) & (aa != 0) & (nrb == ra) & (ncb == ca)) |
        ((rb == nrb) & (cb == ncb) & (ab != 0) & (nra == rb) & (nca == cb)))
    c4 = ~c1 & ~c2 & ~c3 & (nra == nrb) & (nca == ncb)
    c5 = ~c1 & ~c2 & ~c3 & ~c4
    shape = np.broadcast_shapes(nra.shape, nrb.shape, c1.shape)
    bc = lambda x: np.broadcast_to(x, shape)  # noqa: E731
    # slots: (A moves?, B moves?, possession, weight)
    #   c1, c3: nobody moves, the ball to either player (1/2 each)
    #   c2: nobody moves, the ball changes hands
    #   c4: one of the two advances (1/2 each), the ball to either (1/2)
    #   c5: both move, the ball stays
    slots = [
        (c5, c4 | c5, np.where(c2, 1 - p, np.where(c5, p, 0)),
         np.where(c1 | c3, 0.5, np.where(c4, 0.25, 1.0))),
        (False, c4, 1, np.where(c4, 0.25, np.where(c1 | c3, 0.5, 0.0))),
        (True, False, 0, np.where(c4, 0.25, 0.0)),
        (True, False, 1, np.where(c4, 0.25, 0.0)),
    ]
    outs = []
    for a_go, b_go, poss, w in slots:
        xa = np.where(a_go, nra, ra)
        ya = np.where(a_go, nca, ca)
        xb = np.where(b_go, nrb, rb)
        yb = np.where(b_go, ncb, cb)
        outs.append([bc(v) for v in (xa, ya, xb, yb, bc(poss) * 1, w)])
    xa, ya, xb, yb, pp, w = (np.stack([o[k] for o in outs], -1)
                             for k in range(6))
    # a goal state is absorbing: itself, with probability 1
    g = _goal_state(b, ra, ca, rb, cb, p)[..., None]
    first = np.arange(4) == 0
    xa, ya, xb, yb, pp = (np.where(g, np.broadcast_to(f[..., None], xa.shape),
                                   x) for f, x in
                          zip((ra, ca, rb, cb, p), (xa, ya, xb, yb, pp)))
    w = np.where(g, np.broadcast_to(first * 1.0, w.shape), w)
    prob = w * (var_p[va] * var_p[vb])[..., None]
    nraw = b.raw_code(xa, ya, xb, yb, pp)
    done = ss.goal_raw[nraw]
    ball_col = np.where(pp == 0, ya, yb)
    reward = np.where(done & (nraw != S[..., None]),
                      np.where(ball_col == b.W - 1, 1.0, -1.0), 0.0)
    nS = ss.nS
    flat = lambda x: x.reshape(nS, 5, 5, 36)  # noqa: E731
    return (flat(prob), flat(ss.raw_to_dense[nraw]), flat(reward),
            flat(done)), ss


class Model:
    """The model on a device, in ``dtype``, for value iteration."""

    def __init__(self, b: Board, device, dtype=torch.float64):
        (prob, nxt, rew, done), self.ss = build_model(b)
        put = lambda x, t: torch.as_tensor(np.ascontiguousarray(x),  # noqa
                                           device=device).to(t)
        self.prob, self.rew = put(prob, dtype), put(rew, dtype)
        self.cont = put(~done, dtype)
        self.next = put(nxt, torch.int64)
        self.isd_dense = torch.as_tensor(self.ss.isd_dense, device=device)
        self.isd_probs = put(self.ss.isd_probs, dtype)
        self.dtype = dtype

    def joint_q(self, V, gamma: float):
        """Q[s, aa, ab] = sum over outcomes of p * (r + gamma * V[s'])."""
        return (self.prob * (self.rew + gamma * self.cont * V[self.next])
                ).sum(-1)


def best_response_value(m: Model, pi_opp, side: str, gamma: float = 0.99,
                        tol: float = 1e-11, max_sweeps: int = 20000,
                        check_every: int = 50):
    """The value [nS] of the best counter-strategy of ``side`` ('a' or
    'b') to the fixed mixed policy ``pi_opp`` [nS, 5] of the other player,
    by value iteration from 0 until a sweep moves V by less than ``tol``
    (read every ``check_every`` sweeps).  Rewards are ``side``'s own: B
    receives -r."""
    pi = torch.as_tensor(pi_opp).to(device=m.prob.device, dtype=m.dtype)
    sign = 1.0 if side == "a" else -1.0
    V = torch.zeros(m.ss.nS, dtype=m.dtype, device=m.prob.device)
    for sweep in range(1, max_sweeps + 1):
        q = m.joint_q(sign * V, gamma) * sign
        if side == "a":       # A's rows against B's mixture
            new = (q * pi[:, None, :]).sum(-1).max(-1).values
        else:                 # B's columns against A's mixture
            new = (q * pi[:, :, None]).sum(-2).max(-1).values
        if sweep % check_every == 0 or sweep == max_sweeps:
            delta = float((new - V).abs().max())
            V = new
            if delta < tol:
                break
        else:
            V = new
    return V


def exploitability(m: Model, pi_a, pi_b, gamma: float = 0.99, **kw) -> float:
    """BR_A(pi_b) + BR_B(pi_a), each weighted by the initial-state
    distribution: 0 exactly at an equilibrium of the discounted game."""
    va = best_response_value(m, pi_b, "a", gamma, **kw)
    vb = best_response_value(m, pi_a, "b", gamma, **kw)
    start = lambda v: float((m.isd_probs * v[m.isd_dense]).sum())  # noqa
    return start(va) + start(vb)


def rmplus(M, iters: int, dtype=torch.float64):
    """Regret Matching+ self-play with linear averaging on the zero-sum
    games M [G, 5, 5] (row player maximises x^T M y), ``iters`` rounds in
    ``dtype``.  Returns (value, x, y) of the averaged strategies."""
    M = M.to(dtype)
    G, nA = M.shape[0], M.shape[-1]
    uniform = torch.full((G, nA), 1.0 / nA, dtype=dtype, device=M.device)
    rx, ry = torch.zeros_like(uniform), torch.zeros_like(uniform)
    sx, sy = torch.zeros_like(uniform), torch.zeros_like(uniform)
    for t in range(iters):
        tx, ty = rx.sum(-1, keepdim=True), ry.sum(-1, keepdim=True)
        x = torch.where(tx > 0, rx / tx.clamp_min(1e-30), uniform)
        y = torch.where(ty > 0, ry / ty.clamp_min(1e-30), uniform)
        my = (M * y[:, None, :]).sum(-1)          # row payoffs M y
        xm = (M * x[:, :, None]).sum(-2)          # column payoffs x M
        v = (x * my).sum(-1, keepdim=True)
        rx = (rx + my - v).clamp_min(0)
        ry = (ry + v - xm).clamp_min(0)
        sx = sx + (t + 1) * x
        sy = sy + (t + 1) * y
    x = sx / sx.sum(-1, keepdim=True)
    y = sy / sy.sum(-1, keepdim=True)
    return game_value(M, x, y), x, y


def game_value(M, x, y):
    """x^T M y for each game, in M's precision."""
    x, y = x.to(M.dtype), y.to(M.dtype)
    return ((M * x[:, :, None]).sum(-2) * y).sum(-1)
