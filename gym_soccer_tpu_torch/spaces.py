"""Self-contained observation/action space types (a copy of
gym_soccer_tpu/spaces.py).

The reference depends on ``gym.spaces`` (soccer_simultaneous_env.py:3,
:126-131); this framework has no gym dependency, so it ships the small
subset of that API its environments use: ``Discrete`` and ``Dict`` with
``.n``, indexing, membership, and seeded sampling.
"""
from __future__ import annotations

import numpy as np


class Space:
    def __init__(self, seed=None):
        self._np_random = np.random.RandomState(seed)

    def seed(self, seed=None):
        self._np_random = np.random.RandomState(seed)

    def sample(self):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    """Integers {0, ..., n-1}."""

    def __init__(self, n, seed=None):
        super().__init__(seed)
        assert n > 0, "n must be positive"
        self.n = int(n)

    def sample(self):
        return int(self._np_random.randint(0, self.n))

    def contains(self, x) -> bool:
        try:
            xi = int(x)
        except (TypeError, ValueError):
            return False
        return 0 <= xi < self.n and float(x) == xi

    def __eq__(self, other):
        return isinstance(other, Discrete) and other.n == self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """Fixed-length tuples of bounded integers (used for egocentric tuple
    observations in the alternating-turn env)."""

    def __init__(self, nvec, seed=None):
        super().__init__(seed)
        self.nvec = tuple(int(n) for n in nvec)

    def sample(self):
        return tuple(int(self._np_random.randint(0, n)) for n in self.nvec)

    def contains(self, x) -> bool:
        try:
            xs = tuple(int(v) for v in x)
        except (TypeError, ValueError):
            return False
        return len(xs) == len(self.nvec) and all(
            0 <= v < n for v, n in zip(xs, self.nvec))

    def __eq__(self, other):
        return isinstance(other, MultiDiscrete) and other.nvec == self.nvec

    def __repr__(self):
        return f"MultiDiscrete({list(self.nvec)})"


class Dict(Space):
    """Keyed collection of spaces (insertion-ordered)."""

    def __init__(self, spaces, seed=None):
        super().__init__(seed)
        self.spaces = dict(spaces)

    def __getitem__(self, key):
        return self.spaces[key]

    def __contains__(self, key):
        return key in self.spaces

    def __iter__(self):
        return iter(self.spaces)

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def sample(self):
        return {k: s.sample() for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return (isinstance(x, dict) and set(x) == set(self.spaces)
                and all(self.spaces[k].contains(v) for k, v in x.items()))

    def __eq__(self, other):
        return isinstance(other, Dict) and other.spaces == self.spaces

    def __repr__(self):
        return f"Dict({self.spaces})"
