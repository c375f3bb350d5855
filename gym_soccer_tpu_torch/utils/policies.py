"""Policy factories and persistence (a copy of
gym_soccer_tpu/utils/policies.py).

Reference counterpart: gym_soccer/utils/policies.py.
The dict-based factories reproduce the reference's exact RNG semantics
(RandomState(seed).randint per state, policies.py:4-9) so frozen-opponent
table builds stay bit-identical.  Array-native variants serve the batched
engine and the trainers (policies as int32 arrays, not dicts).
"""
from __future__ import annotations

import pickle

import numpy as np

from ..config import NOOP


def get_random_policy(n_states=761, n_actions=5, seed=0):
    """Dict policy via RandomState(seed).randint, one draw per state in
    order — stream-identical to the reference."""
    random_policy = {}
    random_state = np.random.RandomState(seed)
    for s in range(n_states):
        random_policy[s] = random_state.randint(0, n_actions)
    return random_policy


def get_stand_policy(n_states=761):
    return {s: NOOP for s in range(n_states)}


def get_random_policy_array(n_states=761, n_actions=5, seed=0):
    """Array twin of get_random_policy (same stream, same values)."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, n_actions, size=n_states).astype(np.int32)


def get_stand_policy_array(n_states=761):
    return np.zeros(n_states, dtype=np.int32)


def policy_dict_to_array(policy: dict, n_states: int) -> np.ndarray:
    return np.asarray([policy[s] for s in range(n_states)], dtype=np.int32)


def policy_array_to_dict(policy) -> dict:
    return {s: int(a) for s, a in enumerate(np.asarray(policy))}


def save_policy(policy, filename, mode='wb'):
    """Pickle persistence, reference contract (policies.py:17-22)."""
    assert isinstance(policy, dict), "Policy must be a dictionary"
    with open(filename, mode) as f:
        pickle.dump(policy, f)


def load_policy(filename, mode='rb'):
    with open(filename, mode) as f:
        return pickle.load(f)
