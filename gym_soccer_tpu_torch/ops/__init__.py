"""Device kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version.  Kernels are compiled at first launch (``_build``), never
at import."""
