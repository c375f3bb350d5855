"""Policy factories and persistence, episode metrics, profiling and
checkpoints."""
from . import policies  # noqa: F401
