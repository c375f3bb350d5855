# Compatibility shim: presents gym_soccer_tpu_torch under the reference's
# package name so the REFERENCE's own test suite can run unmodified
# against the port (gym_soccer_tpu_torch/tools/run_reference_tests.py).
