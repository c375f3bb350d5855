"""The port's rules (gym_soccer_tpu_torch.core.rules, run on torch
tensors) against the JAX package's (run on jax.numpy), on the same
numpy-seeded random states and actions.  Tolerance: exact equality, for
the integer outputs and for the float32 outcome weights alike."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import rules as jrules
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import rules

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BOARDS = [(5, 4), (11, 7)]
N = 4096


def _cfgs(board):
    w, h = board
    return JaxConfig(width=w, height=h, slip_prob=0.2), \
        EnvConfig(width=w, height=h, slip_prob=0.2)


def _random_states(cfg, rng, n=N):
    """Valid, non-co-located states drawn uniformly over the board."""
    xa = rng.integers(0, cfg.H, n)
    xb = rng.integers(0, cfg.H, n)
    ya = rng.integers(1, cfg.W - 1, n)
    yb = rng.integers(1, cfg.W - 1, n)
    same = (xa == xb) & (ya == yb)
    yb[same] = np.where(ya[same] == 1, 2, ya[same] - 1)
    p = rng.integers(0, 2, n)
    return [a.astype(np.int32) for a in (xa, ya, xb, yb, p)]


def _goal_states(cfg, n=64):
    """States with the ball carrier in a goal column on a goal row."""
    lo, hi = cfg.goal_row_bounds
    rng = np.random.default_rng(1)
    xa = rng.integers(lo, hi + 1, n)
    ya = np.where(rng.integers(0, 2, n) == 0, 0, cfg.W - 1)
    xb = rng.integers(0, cfg.H, n)
    yb = rng.integers(1, cfg.W - 1, n)
    return [a.astype(np.int32) for a in (xa, ya, xb, yb, np.zeros(n))]


def _moves(rng, n):
    aa = rng.integers(0, 5, n).astype(np.int32)
    ab = rng.integers(0, 5, n).astype(np.int32)
    m = rng.integers(-1, 2, (4, n)).astype(np.int32)
    return aa, ab, *m


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int32))


@pytest.mark.parametrize("board", BOARDS)
def test_resolve_outcomes_matches_jax(board):
    jcfg, cfg = _cfgs(board)
    rng = np.random.default_rng(0)
    st = [np.concatenate([a, g]) for a, g in
          zip(_random_states(cfg, rng), _goal_states(cfg))]
    args = st + list(_moves(rng, st[0].size))
    jout = jrules.resolve_outcomes(jnp, *map(jnp.asarray, args), jcfg)
    tout = rules.resolve_outcomes(torch, *map(_t, args), cfg)
    for k, v in jout.items():
        got = tout[k].numpy()
        assert got.dtype == np.asarray(v).dtype, k
        assert np.array_equal(got, np.asarray(v)), k


@pytest.mark.parametrize("board", BOARDS)
def test_next_cell_and_goal_state_match_jax(board):
    jcfg, cfg = _cfgs(board)
    rng = np.random.default_rng(2)
    xa, ya, xb, yb, p = _random_states(cfg, rng)
    _, _, mc, mr, _, _ = _moves(rng, xa.size)
    ball = rng.integers(0, 2, xa.size).astype(bool)
    jnx, jny = jrules.next_cell(jnp, jnp.asarray(xa), jnp.asarray(ya),
                                jnp.asarray(mc), jnp.asarray(mr),
                                jnp.asarray(ball), jcfg)
    nx, ny = rules.next_cell(torch, _t(xa), _t(ya), _t(mc), _t(mr),
                             torch.as_tensor(ball), cfg)
    assert np.array_equal(nx.numpy(), np.asarray(jnx))
    assert np.array_equal(ny.numpy(), np.asarray(jny))
    # every cell of the board, goal columns included
    raw = np.arange(cfg.n_raw, dtype=np.int32)
    f = rules.raw_decode(torch, _t(raw), cfg)
    jf = jrules.raw_decode(jnp, jnp.asarray(raw), jcfg)
    assert np.array_equal(rules.is_goal_state(torch, *f, cfg).numpy(),
                          np.asarray(jrules.is_goal_state(jnp, *jf, jcfg)))


@pytest.mark.parametrize("board", BOARDS)
def test_raw_codec_matches_jax(board):
    jcfg, cfg = _cfgs(board)
    raw = np.arange(cfg.n_raw, dtype=np.int32)
    f = rules.raw_decode(torch, _t(raw), cfg)
    jf = jrules.raw_decode(jnp, jnp.asarray(raw), jcfg)
    for a, b in zip(f, jf):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(rules.raw_encode(torch, *f, cfg).numpy(), raw)


@pytest.mark.parametrize("board", BOARDS)
def test_cellpair_encode_matches_jax(board):
    jcfg, cfg = _cfgs(board)
    rng = np.random.default_rng(3)
    st = [np.concatenate([a, g]) for a, g in
          zip(_random_states(cfg, rng), _goal_states(cfg))]
    got = rules.cellpair_encode(torch, *map(_t, st), cfg)
    want = jrules.cellpair_encode(jnp, *map(jnp.asarray, st), jcfg)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rules.n_cells(cfg) == jrules.n_cells(jcfg)
    assert rules.n_cellpairs(cfg) == jrules.n_cellpairs(jcfg)
    assert int(got.min()) >= 0 and int(got.max()) < rules.n_cellpairs(cfg)
