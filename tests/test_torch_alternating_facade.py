"""The JAX package's alternating facade suite (tests/test_env_alternating
.py :25-92, :95, :139-170 and :237-246) re-run against the port: its test
functions and ``env`` fixture are imported, and a module-scoped autouse
fixture rebinds the names they read to the port's for this module only:

* ``SoccerAlternatingEnv``, ``build_alt_tables``, ``alt_transition`` and
  ``EnvConfig`` to the port's;
* for ``test_batched_kernel_matches_single_env_semantics``, ``alt_init``
  and ``alt_step`` to the port's threefry engine on the CPU (numpy fields
  and actions become tensors at the call), and ``jax`` to a stand-in whose
  ``jit`` is the identity and whose ``random.key`` is core/threefry's.

The cases that set ``env.state`` and then step are among them.  The
suite's own thresholds; the facade draws numpy's RandomState as the JAX
package's does."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_env_alternating as jalt_tests
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import threefry
from gym_soccer_tpu_torch.envs import SoccerAlternatingEnv
from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
# The JAX package's facade suite, run below against the port.
from test_env_alternating import (  # noqa: F401
    env, test_alt_P_dict_view, test_alt_tables_match_env_sampling,
    test_batched_kernel_matches_single_env_semantics,
    test_egocentric_observations, test_goal_scoring,
    test_no_goal_without_possession, test_only_mover_moves, test_own_goal,
    test_slip_statistics, test_steal_on_contact, test_truncation,
    test_turn_alternates)

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _tensors(state):
    return type(state)(*(torch.as_tensor(np.asarray(f)) for f in state))


def _alt_init(cfg, key, batch, first_mover=0):
    return alt.alt_init(cfg, key, batch, first_mover, device="cpu")


def _alt_step(cfg, state, action, autoreset=True):
    return alt.alt_step(cfg, _tensors(state),
                        torch.as_tensor(np.asarray(action)), autoreset)


JAX_STAND_IN = SimpleNamespace(
    jit=lambda f: f, random=SimpleNamespace(key=threefry.key))


@pytest.fixture(scope="module", autouse=True)
def _the_ports_alternating_env():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (
                ("SoccerAlternatingEnv", SoccerAlternatingEnv),
                ("build_alt_tables", alt.build_alt_tables),
                ("alt_transition", alt.alt_transition),
                ("EnvConfig", EnvConfig),
                ("alt_init", _alt_init), ("alt_step", _alt_step),
                ("jax", JAX_STAND_IN)):
            mp.setattr(jalt_tests, name, value)
        yield


def test_the_suite_runs_against_the_port(env):
    assert type(env) is SoccerAlternatingEnv
    assert jalt_tests.alt_transition is alt.alt_transition
    st, _ = _alt_step(EnvConfig(5, 4, 0.0),
                      _alt_init(EnvConfig(5, 4, 0.0), threefry.key(0), 4),
                      np.zeros(4, np.int32))
    assert isinstance(st, alt.AltEnvState) and st.key.dtype == torch.int64
