"""Data parallelism over the env batch on ``torch.distributed``
(``parallel/mesh.py``)."""
from . import mesh  # noqa: F401
