"""Minimal gym.spaces stub.

Re-exports the port's space classes: the API subset matches what the
reference constructor uses (Discrete(n)/.n, Dict over a mapping, indexing,
membership), and sharing classes lets the reference's own isinstance
checks pass when its test suite runs against the port via refcompat."""
from gym_soccer_tpu_torch.spaces import Dict, Discrete, MultiDiscrete  # noqa: F401
