"""Policy factories and persistence."""
from . import policies  # noqa: F401
