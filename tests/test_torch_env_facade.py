"""The port's reference-compatible facade (``SoccerSimultaneousEnv``)
against the JAX package's.

* The JAX package's own facade suites, tests/test_env_deterministic.py,
  test_env_general.py and test_render_golden.py, re-run here against the
  port: their test functions and fixtures are imported, and a
  module-scoped autouse fixture rebinds the names they read (the facade,
  ``spaces``, the planners, the policy factories) to the port's for this
  module only.  (test_env_slip.py drives the JAX batch engine, so it stays
  out.)
* Streams: 2000 random-action steps with resets through both facades on
  5x4 at slip 0 and 0.2, on 6x5, and single-agent A and B: observations,
  rewards, flags, infos, states and the generators' states all equal.
* The state-space views and the four lazy table views equal on 5x4.
* Every entry of tests/golden/reference_golden.json through the port's
  facade and planners (gym_soccer_tpu_torch/tools/check_parity.py).
* The reference-suite runner reads only REFERENCE_PATH and exits 2
  without the reference's tests there.
All exact."""
import json
import os

import numpy as np
import pytest
import torch

import test_env_deterministic as jdet
import test_env_general as jgen
import test_render_golden as jrender
from gym_soccer_tpu.envs import SoccerSimultaneousEnv as JaxEnv
from gym_soccer_tpu_torch import spaces
from gym_soccer_tpu_torch.agents import planners
from gym_soccer_tpu_torch.envs import SoccerSimultaneousEnv
from gym_soccer_tpu_torch.envs import soccer_simultaneous_env as facade
from gym_soccer_tpu_torch.tools import check_parity
from gym_soccer_tpu_torch.utils import policies
# The JAX package's facade suites, run below against the port.
from test_env_deterministic import (  # noqa: F401
    _fresh, env, test_boundary_bounces, test_chasing_keeps_possession,
    test_initialization, test_move_into_stander_collision,
    test_partial_out_of_bounds, test_possession_stable_without_collision,
    test_race_to_same_cell, test_render_smoke, test_repeated_swap_collisions,
    test_reset_and_step_shapes, test_scoring, test_simultaneous_goal_attempts,
    test_swap_through_collision)
from test_env_general import (  # noqa: F401
    test_isd_sampling_uniformity, test_isd_structure, test_mode_contracts,
    test_P_schema, test_planners_agree, test_vi_beats_random_policy,
    test_vi_beats_stand_policy)
from test_render_golden import test_render_bytes_match_reference  # noqa: F401

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GOLD = json.load(open(check_parity.GOLDEN))


@pytest.fixture(scope="module", autouse=True)
def _the_ports_facade():
    """Point the imported suites' names at the port for this module."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdet, jgen, jrender):
            mp.setattr(mod, "SoccerSimultaneousEnv", SoccerSimultaneousEnv)
        mp.setattr(jgen, "spaces", spaces)
        for name in ("value_iteration", "policy_iteration",
                     "modified_policy_iteration"):
            mp.setattr(jgen, name, getattr(planners, name))
        for name in ("get_random_policy", "get_stand_policy"):
            mp.setattr(jgen, name, getattr(policies, name))
        yield


def test_the_suites_run_against_the_port(env):
    assert type(env) is SoccerSimultaneousEnv
    assert jgen.value_iteration is planners.value_iteration
    assert jgen.spaces is spaces and jrender.SoccerSimultaneousEnv is \
        SoccerSimultaneousEnv


def _policy(seed):
    return policies.get_random_policy(761, 5, seed)


STREAMS = {
    "5x4-slip0": dict(width=5, height=4, slip_prob=0.0),
    "5x4-slip0.2": dict(width=5, height=4, slip_prob=0.2),
    "6x5": dict(width=6, height=5, slip_prob=0.2),
    "single-A": dict(width=5, height=4, slip_prob=0.2,
                     player_b_policy=_policy(3)),
    "single-B": dict(width=5, height=4, slip_prob=0.2,
                     player_a_policy=_policy(8)),
}


def _same_generator(a, b):
    sa, sb = a.np_random.get_state(), b.np_random.get_state()
    return sa[0] == sb[0] and np.array_equal(sa[1], sb[1]) and \
        sa[2:] == sb[2:]


@pytest.mark.parametrize("kwargs", STREAMS.values(), ids=STREAMS.keys())
def test_streams_equal_the_jax_facade(kwargs):
    """2000 random actions with resets: every return value equal in value
    and type (repr), the states and the MT19937 states too."""
    ours, theirs = SoccerSimultaneousEnv(**kwargs), JaxEnv(**kwargs)
    assert ours.return_agent == theirs.return_agent
    rng = np.random.RandomState(2)
    assert repr(ours.reset(seed=17)) == repr(theirs.reset(seed=17))
    resets = 0
    for _ in range(2000):
        if ours.needs_reset:
            resets += 1
            assert repr(ours.reset()) == repr(theirs.reset())
        action = {a: int(rng.randint(0, 5)) for a in ours.return_agent}
        assert repr(ours.step(action)) == repr(theirs.step(action))
        assert ours.state == theirs.state
        assert ours.timestep == theirs.timestep
    assert resets > 10
    assert theirs.needs_reset == ours.needs_reset
    assert _same_generator(ours, theirs)


def test_state_injection_and_goal_self_loop():
    """An injected goal state self-loops in both facades (the dense row of
    state 0 points at the class representative)."""
    ours, theirs = SoccerSimultaneousEnv(), JaxEnv()
    goal = next(iter(ours.goal_states))
    for env in (ours, theirs):
        env.reset(seed=0)
        env.state = goal
    act = {"player_a": 3, "player_b": 4}
    assert repr(ours.step(act)) == repr(theirs.step(act))
    assert ours.state == theirs.state == goal


@pytest.mark.parametrize("kwargs", [
    dict(width=5, height=4, slip_prob=0.2),
    dict(width=5, height=4, slip_prob=0.2, player_a_policy=_policy(1)),
], ids=["multi", "single-B"])
def test_views_equal_the_jax_facade(kwargs):
    """The state classification views and the lazy P, P_readable, Pmat
    and Rmat, by repr (so -0.0 rewards count) and by bytes."""
    ours, theirs = SoccerSimultaneousEnv(**kwargs), JaxEnv(**kwargs)
    for name in ("state_space", "isd", "goal_states", "unreachable_states",
                 "nS", "nA", "goal_rows", "goal_cols", "width", "height"):
        assert repr(getattr(ours, name)) == repr(getattr(theirs, name)), name
    assert ours._P is None and ours._Pmat is None   # built on first use
    assert repr(ours.P) == repr(theirs.P)
    assert repr(ours.P_readable) == repr(theirs.P_readable)
    for name in ("Pmat", "Rmat"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_tables_are_cached_per_config():
    a = SoccerSimultaneousEnv(width=6, height=5, slip_prob=0.1)
    b = SoccerSimultaneousEnv(width=6, height=5, slip_prob=0.1, seed=3)
    assert a._tb is b._tb is facade.get_tables(a.cfg)


@pytest.mark.parametrize("suffix,kwargs,agents", check_parity.envs(),
                         ids=[e[0] for e in check_parity.envs()])
def test_golden_tables_and_trajectories(suffix, kwargs, agents, capsys):
    c = check_parity.Checker(GOLD)
    check_parity.check_env(c, suffix, kwargs, agents)
    assert c.failures == 0, capsys.readouterr().out


def test_golden_policy_evals_and_streams(capsys):
    c = check_parity.Checker(GOLD)
    check_parity.check_policy_evals(c)
    c.streams()
    out = capsys.readouterr().out
    assert c.failures == 0, out
    assert out.count("ok   ") == 15   # 2 x 4 policy-eval checks, 7 seeds


@pytest.mark.parametrize("where", ["unset", "empty"])
def test_reference_runner_needs_reference_path(where, tmp_path, monkeypatch,
                                               capsys):
    """The reference-suite runner searches nothing but REFERENCE_PATH: with
    it unset, or naming a directory without the reference's tests, it
    exits 2 before starting pytest."""
    from gym_soccer_tpu_torch.tools import run_reference_tests as runner
    monkeypatch.delenv("REFERENCE_PATH", raising=False)
    if where == "empty":
        monkeypatch.setenv("REFERENCE_PATH", str(tmp_path))
    monkeypatch.setattr(runner.subprocess, "call", None)   # never reached
    assert runner.main([]) == 2
    assert "REFERENCE_PATH" in capsys.readouterr().err
