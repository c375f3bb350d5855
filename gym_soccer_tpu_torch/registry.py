"""Named environment configurations and the `make` factory (a copy of
gym_soccer_tpu/registry.py, on the port's envs).

The reference *intended* to register 'SoccerSimultaneous-v0' with gym but
left it commented out (gym_soccer/__init__.py:3-12, with
max_episode_steps=100, nondeterministic=True).  This registry realizes that
capability without a gym dependency, and adds named configs mirroring
BASELINE.json's five benchmark configurations (SURVEY.md §5.6).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from .config import EnvConfig

_REGISTRY: Dict[str, dict] = {}


def register(env_id: str, *, entry_point: Callable = None,
             max_episode_steps: int = 100, nondeterministic: bool = True,
             **kwargs) -> None:
    if entry_point is None:
        from .envs import SoccerSimultaneousEnv
        entry_point = SoccerSimultaneousEnv
    _REGISTRY[env_id] = {
        "entry_point": entry_point,
        "max_episode_steps": max_episode_steps,
        "nondeterministic": nondeterministic,
        "kwargs": kwargs,
    }


def make(env_id: str, **overrides) -> Any:
    """Instantiate a registered environment (the reference's intended
    `gym.make('SoccerSimultaneous-v0')` surface)."""
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}; known: {sorted(_REGISTRY)}")
    spec = _REGISTRY[env_id]
    kwargs = dict(spec["kwargs"])
    # The spec's max_episode_steps is the registered truncation horizon —
    # gym's register() wires it into a TimeLimit wrapper (the reference's
    # intended registration, gym_soccer/__init__.py:5-12); here it becomes
    # the env's max_steps unless the caller overrides it.
    kwargs.setdefault("max_steps", spec["max_episode_steps"])
    kwargs.update(overrides)
    return spec["entry_point"](**kwargs)


def registry_ids():
    return sorted(_REGISTRY)


def _register_builtins():
    from .envs import SoccerAlternatingEnv, SoccerSimultaneousEnv
    # The reference's intended registration (gym_soccer/__init__.py:5-12).
    register("SoccerSimultaneous-v0", entry_point=SoccerSimultaneousEnv,
             max_episode_steps=100, nondeterministic=True,
             width=5, height=4, slip_prob=0.0)
    register("SoccerSimultaneousSlip-v0", entry_point=SoccerSimultaneousEnv,
             width=5, height=4, slip_prob=0.2)
    register("SoccerAlternating-v0", entry_point=SoccerAlternatingEnv,
             width=5, height=4, slip_prob=0.0)


_register_builtins()


# ----------------------------------------------------------------------
# BASELINE.json benchmark configurations (SURVEY.md §5.6)
# ----------------------------------------------------------------------

BASELINE_CONFIGS: Dict[str, dict] = {
    # 1: single env, default grid, two random agents, seeded parity run
    "baseline/parity-single": dict(
        cfg=EnvConfig(5, 4, 0.2), n_envs=1, mode="parity"),
    # 2: 1024-env lockstep self-play rollout, random vs random, one chip
    "baseline/rollout-1024": dict(
        cfg=EnvConfig(5, 4, 0.2), n_envs=1024, mode="rollout"),
    # 3: 8192-env batch with fused tabular learner updates
    "baseline/learner-8192": dict(
        cfg=EnvConfig(5, 4, 0.2), n_envs=8192, mode="minimax_q"),
    # 4: generalized grid sizes / goal widths vmapped across variants
    "baseline/generalized-grids": dict(
        cfgs=[EnvConfig(5, 4, 0.2), EnvConfig(6, 4, 0.2),
              EnvConfig(7, 5, 0.2), EnvConfig(9, 6, 0.2),
              EnvConfig(11, 7, 0.2)],
        n_envs=1024, mode="rollout"),
    # 5: multi-host pod slice, env shards per host + sharded learner
    "baseline/multihost-dp": dict(
        cfg=EnvConfig(5, 4, 0.2), n_envs=8192, mode="minimax_q",
        data_parallel=True),
}
