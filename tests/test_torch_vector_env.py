"""The port's ``SoccerVectorEnv`` against the JAX package's.

* tests/test_vector_env.py's suite re-run here against the port on the
  CPU: its test functions and fixture are imported, and a module-scoped
  autouse fixture rebinds the names they read (``SoccerVectorEnv``, to the
  port's class on ``device="cpu"``) for this module only.
* Streams: 500 random-action steps from the same seed through both
  facades, multiagent, single-agent A and B and from a per-env seed list:
  observations, rewards, flags, infos and the episode stats equal, through
  reseeded and continued resets.
All exact."""
import os

import numpy as np
import pytest
import torch

import test_vector_env as jvec
from gym_soccer_tpu.envs import SoccerVectorEnv as JaxVectorEnv
from gym_soccer_tpu_torch.envs import SoccerVectorEnv
from gym_soccer_tpu_torch.utils import policies
# The JAX package's suite, run below against the port.
from test_vector_env import (  # noqa: F401
    test_action_validation, test_autoreset_and_final_observation,
    test_episode_stats_accumulation, test_max_steps_truncation_horizon,
    test_per_env_seed_list, test_reset_semantics_reseed_vs_continue,
    test_reset_shapes_and_keys, test_seeding_determinism,
    test_single_agent_mode_frozen_a_sign_flip,
    test_single_agent_mode_frozen_b, test_step_contract_multiagent,
    test_step_info_p, venv)

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


class CpuVectorEnv(SoccerVectorEnv):
    """The port's facade on the CPU, under the JAX suite's constructor."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, device="cpu", **kwargs)


@pytest.fixture(scope="module", autouse=True)
def _the_ports_vector_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvec, "SoccerVectorEnv", CpuVectorEnv)
        yield


def test_the_suite_runs_against_the_port(venv):
    assert isinstance(venv, SoccerVectorEnv)
    assert venv.device_state.t.device.type == "cpu"


def test_default_device_is_cuda():
    import inspect
    sig = inspect.signature(SoccerVectorEnv)
    assert sig.parameters["device"].default == "cuda"


STREAMS = {
    "multiagent": dict(),
    "single-A": dict(player_b_policy=policies.get_random_policy(761, 5, 3)),
    "single-B": dict(player_a_policy=policies.get_random_policy_array(
        761, 5, 8)),
}


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kwargs", STREAMS.values(), ids=STREAMS.keys())
def test_stream_equals_the_jax_facade(kwargs):
    """500 steps at 64 envs, slip 0.2, max_steps 30: every return value
    equal, across a reseed, a continued reset and a per-env seed list."""
    N = 64
    ours = SoccerVectorEnv(N, slip_prob=0.2, max_steps=30, seed=5,
                           device="cpu", **kwargs)
    theirs = JaxVectorEnv(N, slip_prob=0.2, max_steps=30, seed=5, **kwargs)
    rng = np.random.RandomState(4)
    seeds = [None, 11, None, list(range(100, 100 + N)), None]
    for k in range(500):
        if k % 100 == 0:
            _equal(ours.reset(seed=seeds[k // 100]),
                   theirs.reset(seed=seeds[k // 100]))
        if ours._frozen is None:
            acts = {a: rng.randint(0, 5, N) for a in ours.agents}
        else:
            acts = rng.randint(0, 5, N)
        _equal(ours.step(acts), theirs.step(acts))
    for x, y in zip(ours.episode_stats, theirs.episode_stats):
        assert float(x) == float(y)
