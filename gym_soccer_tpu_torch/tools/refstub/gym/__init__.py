# Minimal stub of the `gym` API surface the reference repo imports, just
# enough to run its test suite against the port through refcompat.  Test
# tooling only: the port has its own spaces module and no gym dependency.
from . import spaces  # noqa: F401
