"""Plain reference of one chunk of the minimax-Q learner and of its
schedules, written from the recipe as the JAX package documents it
(gym_soccer_tpu/ops/learner_kernel.py ``fused_minimax_train``).

A chunk runs ``chunk_len`` steps on every lane.  Each step draws three
counter random words keyed on the chunk's seed (seed * 1_000_003 + k,
as uint32) and the step within the chunk; word 0's low and high 16 bits
sample A's and B's actions from the behaviour policies at the lane's
state, words 1 and 2 drive the game (``game.transition``,
``game.autoreset``).  The behaviour policy of chunk k is each player's
policy mixed with uniform exploration at the previous chunk's epsilon,
pi * (1 - eps) + eps * 0.2 rounded once to float32 and then to bfloat16
(the packed table's layout), and an action is the first column whose
running float32 sum, in index order, exceeds u * total (u the 16-bit
uniform over 65536).  Every lane-step adds its TD error r + gamma * cont *
v(s') - q(s, a, b) to its cell (cont 0 where the episode ended, v(s') at
the state after the reset); after the chunk each visited cell moves by lr
times its mean TD error.  Schedules are computed in float64 from the
recipe and rounded to float32.

Only the sampling keeps float32, the precision that defines the
behaviour; the TD errors, their sums and the update are in ``dtype``
(float64 by default, the control's bfloat16).  Imports nothing of the
program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from .game import M32, Board, autoreset, random_word, transition

SEED_MUL = 1_000_003


def chunk_seed(seed: int, k: int) -> int:
    return (seed * SEED_MUL + k) & M32


def _decay(base: float, halflife: float, k: int, chunk_len: int,
           floor: float = 0.0) -> float:
    return max(base * (0.5 ** (k * chunk_len / halflife) if halflife else 1.0),
               floor)


def lr_at(recipe: dict, k: int) -> float:
    """Chunk k's learning rate, rounded to float32."""
    d = _decay(recipe["lr"], recipe.get("lr_halflife", 0), k,
               recipe["chunk_len"])
    if recipe.get("lr_anneal_tau", 0) > 0:
        over = max(k - recipe.get("lr_anneal_start", 0), 0)
        d *= (1.0 + over / recipe["lr_anneal_tau"]) ** (
            -recipe.get("lr_anneal_pow", 1.0))
    return float(np.float32(d))


def eps_at(recipe: dict, k: int) -> float:
    """Chunk k's exploration, rounded to float32: the behaviour of chunk
    k + 1."""
    return float(np.float32(_decay(recipe["eps"], recipe.get("eps_halflife",
                                                             0),
                                   k, recipe["chunk_len"],
                                   recipe.get("eps_min", 0.0))))


def behaviour_eps(recipe: dict, k: int) -> float:
    """The exploration chunk k acts with: the recipe's for the first."""
    return (float(np.float32(recipe["eps"])) if k == 0
            else eps_at(recipe, k - 1))


def mix(pi, eps: float):
    """pi * (1 - eps) + eps / 5 with one rounding to float32 (1 - eps and
    eps * 0.2 themselves float32), then rounded to bfloat16."""
    e = np.float32(eps)
    e1 = float(np.float32(1.0) - e)
    e2 = float(e * np.float32(0.2))
    return (pi.double() * e1 + e2).float().to(torch.bfloat16).float()


def sample(pi, u):
    """The first of the five columns of ``pi`` [n, 5] (float32) whose
    running sum exceeds u * total, all in float32."""
    c = pi.unbind(1)
    total = c[0] + c[1] + c[2] + c[3] + c[4]
    target = u * total
    s = c[0]
    a = (s <= target).long()
    for k in range(1, 4):
        s = s + c[k]
        a += (s <= target).long()
    return a


def chunk(b: Board, raw_to_dense, state: dict, seed: int, k: int,
          recipe: dict, dtype=torch.float64):
    """Chunk ``k`` of the trainer seeded ``seed`` from ``state`` (q [nS, 5,
    5], v [nS], pi_a, pi_b [nS, 5], fields: six int [batch]).  Returns (q
    after the update in ``dtype``, the chunk's visit counts int64 [nS, 5,
    5], the fields after the chunk, int64)."""
    q = state["q"]
    dev = q.device
    nS = q.shape[0]
    r2d = torch.as_tensor(np.asarray(raw_to_dense), device=dev)
    ra, ca, rb, cb, p, t = (f.long() for f in state["fields"])
    lanes = torch.arange(ra.shape[0], dtype=torch.int64, device=dev)
    eps = behaviour_eps(recipe, k)
    ma, mb = mix(state["pi_a"], eps), mix(state["pi_b"], eps)
    qd = q.to(dtype).reshape(-1)
    vd = state["v"].to(dtype)
    gamma = torch.tensor(recipe["gamma"], dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    sums = torch.zeros(nS * 25, dtype=dtype, device=dev)
    cnt = torch.zeros(nS * 25, dtype=torch.int64, device=dev)
    seed_k = chunk_seed(seed, k)
    s = (ra, ca, rb, cb, p)
    for i in range(recipe["chunk_len"]):
        w0, w1, w2 = (random_word(seed_k, i, j, lanes) for j in range(3))
        here = r2d[b.raw_code(*s)]
        aa = sample(ma[here], (w0 & 0xFFFF).float() / 65536.0)
        ab = sample(mb[here], ((w0 >> 16) & 0xFFFF).float() / 65536.0)
        s, goal, r = transition(b, s, aa, ab, w1, w2)
        s, t, trunc, _ = autoreset(b, s, t, goal, w2)
        cont = torch.where(goal | trunc, zero, gamma)
        cell = here * 25 + aa * 5 + ab
        td = r.to(dtype) + cont * vd[r2d[b.raw_code(*s)]] - qd[cell]
        sums.index_add_(0, cell, td)
        cnt.index_add_(0, cell, torch.ones_like(cell))
    lr = torch.tensor(lr_at(recipe, k), dtype=dtype, device=dev)
    q_new = qd + lr * sums / cnt.clamp_min(1).to(dtype)
    return (q_new.reshape(nS, 5, 5), cnt.reshape(nS, 5, 5), (*s, t))
