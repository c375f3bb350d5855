"""The port's host tables, RM+ solver and Markov-game evaluation
(gym_soccer_tpu_torch.core.tables.build_tables, agents.learners,
agents.evaluation) on the CPU against the JAX package, on the same
numpy-seeded inputs.

Tolerances: ``build_tables`` byte-equal; ``solve_matrix_games`` values
and strategies within 1e-5; best-response values and exploitability
within 1e-5 (float32 value iteration, summed in another order); Shapley
V within 1e-4 (the RM+ solve inside each sweep amplifies one-ulp
differences of the backup)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.agents import evaluation as jev
from gym_soccer_tpu.agents.learners import solve_matrix_games as jax_solve
from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import tables as jtables
from gym_soccer_tpu_torch.agents import evaluation as ev
from gym_soccer_tpu_torch.agents.learners import solve_matrix_games
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import tables

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG, JCFG = EnvConfig(5, 4, 0.2), JaxConfig(5, 4, 0.2)
NS = 761


def _policy(seed):
    return np.random.default_rng(seed).dirichlet(np.ones(5), NS).astype(
        np.float32)


@pytest.mark.parametrize("board", [(5, 4, 0.2), (6, 5, 0.1)])
def test_build_tables_byte_equal(board):
    want = jtables.build_tables(JaxConfig(*board))
    got = tables.build_tables(EnvConfig(*board))
    assert got.nS == want.nS
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name


@pytest.mark.parametrize("iters", [1, 50, 400])
def test_solve_matrix_games_equals_jax(iters):
    M = np.random.default_rng(iters).uniform(-1, 1, (NS, 5, 5)).astype(
        np.float32)
    want = [np.asarray(a) for a in jax_solve(jnp.asarray(M), iters=iters)]
    got = [a.numpy() for a in solve_matrix_games(torch.tensor(M), iters)]
    for a, b in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("side", ["player_a", "player_b"])
def test_best_response_value_equals_jax(side):
    pi = _policy(1)
    want, _ = jev.best_response_value(JCFG, jnp.asarray(pi), side, gamma=0.9)
    got, pol = ev.best_response_value(CFG, pi, side, gamma=0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert pol.shape == (NS,) and int(pol.min()) >= 0 and int(pol.max()) < 5


@pytest.mark.parametrize("pair", ["uniform", "random"])
def test_exploitability_equals_jax(pair):
    if pair == "uniform":
        pa = pb = np.full((NS, 5), 0.2, np.float32)
    else:
        pa, pb = _policy(2), _policy(3)
    want = float(jev.exploitability(JCFG, jnp.asarray(pa), jnp.asarray(pb),
                                    gamma=0.9))
    got = ev.exploitability(CFG, pa, pb, gamma=0.9)
    assert got > 0.5
    assert abs(got - want) <= 1e-5, (got, want)
    # the segmented edition reads the same V after whole segments
    seg = ev.exploitability(CFG, pa, pb, gamma=0.9, segment_iters=7)
    assert abs(seg - want) <= 1e-5, (seg, want)


def test_shapley_iteration_equals_jax():
    kw = dict(gamma=0.9, max_iters=40, solver_iters=100)
    want = jev.shapley_iteration(JCFG, **kw)
    got = ev.shapley_iteration(CFG, device="cpu", **kw)
    assert got[4] == int(want[4]) == 40
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-4)


def test_shapley_segments_never_overshoot_max_iters():
    kw = dict(gamma=0.9, max_iters=12, solver_iters=50, segment_sweeps=5)
    want = jev.shapley_iteration(JCFG, **kw)
    got = ev.shapley_iteration(CFG, device="cpu", **kw)
    assert got[4] == int(want[4]) == 12
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].sum(-1).numpy(), 1.0, atol=1e-5)


def test_start_value_and_joint_tensors():
    jt = ev.joint_tensors(CFG, "cpu")
    assert tuple(jt.prob.shape) == (NS, 5, 5, 36)
    np.testing.assert_allclose(jt.prob.sum(-1).numpy(), 1.0, atol=1e-6)
    V = torch.arange(NS, dtype=torch.float32)
    want = float(jev.start_value(JCFG, jnp.arange(NS, dtype=jnp.float32)))
    assert ev.start_value(CFG, V) == pytest.approx(want, abs=1e-4)
