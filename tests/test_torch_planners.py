"""The port's planners, registry and policies against the JAX package's.

* The numpy planners (VI, PI, MPI, policy evaluation, the matrix-form
  ``policy_eval``) are copies: bit-equal on the same single-agent tables.
* ``value_iteration_torch`` against the JAX package's
  ``value_iteration_jax_jit`` in float32, on the JAX tests' terms
  (tests/test_planners_jax.py: greedy actions equal where the float64 gap
  exceeds 1e-3, V within 1e-3 of the float64 V, sweep counts within 2),
  and against ``value_iteration_arrays`` in float64: within 1e-12 (torch
  and numpy sum in different orders) with equal sweep counts at theta
  1e-10; it returns the pre-update V, as the JAX function does.
* ``registry`` and ``utils/policies``: the same ids, specs and
  ``BASELINE_CONFIGS``; ``make`` with overrides and the registered
  truncation; the dict and array policies equal for several seeds, and
  their pickle round trip.
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_soccer_tpu as gst
import gym_soccer_tpu_torch as port
from gym_soccer_tpu import registry as jregistry
from gym_soccer_tpu.agents import planners as jplanners
from gym_soccer_tpu.envs import SoccerSimultaneousEnv as JaxEnv
from gym_soccer_tpu.utils import policies as jpolicies
from gym_soccer_tpu_torch import registry
from gym_soccer_tpu_torch.agents import planners
from gym_soccer_tpu_torch.envs import (SoccerAlternatingEnv,
                                       SoccerSimultaneousEnv)
from gym_soccer_tpu_torch.utils import policies

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GAMMA = 0.99


def _envs(side, policy):
    """The port's and the JAX package's single-agent 5x4 slip-0.2 facade,
    ``side`` learning against the frozen ``policy`` dict."""
    key = "player_b_policy" if side == "player_a" else "player_a_policy"
    return (SoccerSimultaneousEnv(slip_prob=0.2, **{key: policy}),
            JaxEnv(slip_prob=0.2, **{key: policy}))


@pytest.fixture(scope="module")
def stand_a():
    return _envs("player_a", policies.get_stand_policy(761))


@pytest.fixture(scope="module")
def random_b():
    return _envs("player_b", policies.get_random_policy(761, 5, seed=3))


def _equal(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("which", ["stand_a", "random_b"])
def test_numpy_planners_bit_equal_to_jax(which, request):
    env, jenv = request.getfixturevalue(which)
    arrs = planners._env_arrays(env)
    _equal(arrs, jplanners._env_arrays(jenv))
    theta = 1e-10
    _equal(planners.value_iteration(env, theta, GAMMA),
           jplanners.value_iteration(jenv, theta, GAMMA))
    pi, V, _, _ = planners.value_iteration(env, theta, GAMMA)
    _equal([planners.policy_evaluation(pi, env, theta, GAMMA)],
           [jplanners.policy_evaluation(pi, jenv, theta, GAMMA)])
    _equal(planners.policy_improvement(V, env, GAMMA),
           jplanners.policy_improvement(V, jenv, GAMMA))
    _equal(planners.policy_iteration_arrays(
               *arrs, theta, GAMMA, rng=np.random.RandomState(4)),
           jplanners.policy_iteration_arrays(
               *arrs, theta, GAMMA, rng=np.random.RandomState(4)))
    for k in (1, 10):
        _equal(planners.modified_policy_iteration(env, k, theta, GAMMA),
               jplanners.modified_policy_iteration(jenv, k, theta, GAMMA))
    mixed = np.random.default_rng(0).dirichlet(np.ones(5), 761)
    _equal(planners.policy_eval(env, mixed, 1e-8, GAMMA),
           jplanners.policy_eval(jenv, mixed, 1e-8, GAMMA))


def test_planners_refuse_joint_tables():
    with pytest.raises(AssertionError, match="single-agent"):
        planners.value_iteration(SoccerSimultaneousEnv(), 1e-6, GAMMA)


def _torch_arrays(env, dtype):
    prob, ns, rew, done = planners._env_arrays(env)
    return (torch.as_tensor(prob, dtype=dtype), torch.as_tensor(ns),
            torch.as_tensor(rew, dtype=dtype), torch.as_tensor(done))


def _jax_arrays(env):
    prob, ns, rew, done = planners._env_arrays(env)
    return (jnp.asarray(prob, jnp.float32), jnp.asarray(ns),
            jnp.asarray(rew, jnp.float32), jnp.asarray(done))


@pytest.mark.parametrize("which", ["stand_a", "random_b"])
@pytest.mark.parametrize("theta", [1e-4, 1e-5])
def test_torch_vi_float32_against_jax(which, theta, request):
    env, _ = request.getfixturevalue(which)
    pi_np, V_np, Q_np, cc_np = planners.value_iteration_arrays(
        *planners._env_arrays(env), theta, GAMMA)
    pi_t, V_t, Q_t, cc_t = planners.value_iteration_torch(
        *_torch_arrays(env, torch.float32), theta, GAMMA)
    pi_j, V_j, Q_j, cc_j = jplanners.value_iteration_jax_jit(
        *_jax_arrays(env), theta, GAMMA)
    assert V_t.dtype == Q_t.dtype == torch.float32 and isinstance(cc_t, int)
    gap = np.sort(Q_np, axis=1)
    distinct = (gap[:, -1] - gap[:, -2]) > 1e-3
    for pi, V, cc in ((pi_t.numpy(), V_t.numpy(), cc_t),
                      (np.asarray(pi_j), np.asarray(V_j), int(cc_j))):
        assert (pi[distinct] == pi_np[distinct]).all()
        assert np.allclose(V, V_np, atol=1e-3)
        assert abs(cc - cc_np) <= 2
    # float32 against float32: the same sweeps, sums in another order
    assert abs(cc_t - int(cc_j)) <= 2
    assert np.allclose(V_t.numpy(), np.asarray(V_j), atol=1e-4)
    assert (pi_t.numpy()[distinct] == np.asarray(pi_j)[distinct]).all()


@pytest.mark.parametrize("which", ["stand_a", "random_b"])
def test_torch_vi_float64_against_numpy(which, request):
    env, _ = request.getfixturevalue(which)
    theta = 1e-10
    pi_np, V_np, Q_np, cc_np = planners.value_iteration_arrays(
        *planners._env_arrays(env), theta, GAMMA)
    pi_t, V_t, Q_t, cc_t = planners.value_iteration_torch(
        *_torch_arrays(env, torch.float64), theta, GAMMA)
    assert cc_t == cc_np
    assert np.abs(V_t.numpy() - V_np).max() <= 1e-12
    assert np.abs(Q_t.numpy() - Q_np).max() <= 1e-12
    gap = np.sort(Q_np, axis=1)
    distinct = (gap[:, -1] - gap[:, -2]) > 1e-9
    assert (pi_t.numpy()[distinct] == pi_np[distinct]).all()


def test_torch_vi_returns_pre_update_v(stand_a):
    """V is the value the final Q was backed up from: its residual to
    max_a Q is below theta but not zero, and it is the second-to-last
    sweep's max_a Q, as in the JAX package (tests/test_planners_jax.py)."""
    env, _ = stand_a
    theta = 1e-4
    arrs = _torch_arrays(env, torch.float32)
    pi, V, Q, cc = planners.value_iteration_torch(*arrs, theta, GAMMA)
    resid = (V - Q.max(dim=1).values).abs().max().item()
    assert 0 < resid < theta
    _, V_prev, Q_prev, cc_prev = planners.value_iteration_torch(
        *arrs, theta, GAMMA, max_sweeps=cc - 1)
    assert cc_prev == cc - 1
    assert torch.equal(V, Q_prev.max(dim=1).values)
    assert torch.equal(pi, Q.argmax(dim=1))
    # a cap stops the sweeps without convergence
    _, _, _, capped = planners.value_iteration_torch(*arrs, 1e-12, GAMMA,
                                                     max_sweeps=5)
    assert capped == 5


def test_registry_equals_jax():
    assert registry.registry_ids() == jregistry.registry_ids()
    assert port.registry_ids() == gst.registry_ids()
    assert port.make is registry.make
    for env_id in registry.registry_ids():
        ours, theirs = registry._REGISTRY[env_id], jregistry._REGISTRY[env_id]
        assert ours["kwargs"] == theirs["kwargs"]
        assert ours["max_episode_steps"] == theirs["max_episode_steps"]
        assert ours["nondeterministic"] == theirs["nondeterministic"]
        assert ours["entry_point"].__name__ == theirs["entry_point"].__name__
        assert ours["entry_point"].__module__.startswith(
            "gym_soccer_tpu_torch.envs.")
    assert registry.BASELINE_CONFIGS.keys() == \
        jregistry.BASELINE_CONFIGS.keys()
    for name, spec in registry.BASELINE_CONFIGS.items():
        theirs = jregistry.BASELINE_CONFIGS[name]
        assert spec.keys() == theirs.keys()
        for k, v in spec.items():
            if k == "cfg":
                assert (v.W, v.H, v.slip_prob) == \
                    (theirs[k].W, theirs[k].H, theirs[k].slip_prob)
            elif k == "cfgs":
                assert [(c.W, c.H, c.slip_prob) for c in v] == \
                    [(c.W, c.H, c.slip_prob) for c in theirs[k]]
            else:
                assert v == theirs[k]


def test_make_builds_the_ports_envs():
    env = port.make("SoccerSimultaneous-v0")
    assert isinstance(env, SoccerSimultaneousEnv)
    assert env.slip_prob == 0.0 and env._max_steps == 100
    slip = port.make("SoccerSimultaneousSlip-v0", width=6)
    assert slip.slip_prob == 0.2 and slip.width == 8
    assert isinstance(port.make("SoccerAlternating-v0"),
                      SoccerAlternatingEnv)
    short = port.make("SoccerSimultaneous-v0", max_steps=3)
    short.reset(seed=1)
    truncs = [short.step({"player_a": 0, "player_b": 0})[3]["player_a"]
              for _ in range(3)]
    assert truncs == [False, False, True]
    with pytest.raises(KeyError, match="Unknown env id"):
        port.make("Soccer-v9")


def test_register_a_new_id():
    env_id = "SoccerPortShort-test_torch_planners-v0"
    port.register(env_id, max_episode_steps=7, width=6, height=5,
                  slip_prob=0.1)
    try:
        assert env_id in port.registry_ids()
        assert env_id not in gst.registry_ids()
        env = port.make(env_id)
        assert isinstance(env, SoccerSimultaneousEnv)
        assert (env.width, env.height, env.slip_prob, env._max_steps) == \
            (8, 5, 0.1, 7)
        assert port.make(env_id, max_steps=9)._max_steps == 9
    finally:
        registry._REGISTRY.pop(env_id)


@pytest.mark.parametrize("seed", [0, 1, 42, 123, 2**31 - 1])
@pytest.mark.parametrize("n", [761, 2381])
def test_policies_equal_jax(seed, n):
    ours = policies.get_random_policy(n, 5, seed)
    assert ours == jpolicies.get_random_policy(n, 5, seed)
    arr = policies.get_random_policy_array(n, 5, seed)
    assert arr.dtype == np.int32
    assert np.array_equal(arr, jpolicies.get_random_policy_array(n, 5, seed))
    assert np.array_equal(policies.policy_dict_to_array(ours, n), arr)
    assert policies.policy_array_to_dict(arr) == ours
    assert policies.get_stand_policy(n) == jpolicies.get_stand_policy(n)
    assert np.array_equal(policies.get_stand_policy_array(n),
                          jpolicies.get_stand_policy_array(n))


def test_policy_persistence(tmp_path):
    pol = policies.get_random_policy(761, 5, 7)
    path = tmp_path / "policy.pkl"
    policies.save_policy(pol, path)
    assert policies.load_policy(path) == pol
    assert jpolicies.load_policy(path) == pol
    with open(path, "rb") as f:
        assert pickle.load(f) == pol
    with pytest.raises(AssertionError, match="dictionary"):
        policies.save_policy(np.zeros(3), tmp_path / "array.pkl")
