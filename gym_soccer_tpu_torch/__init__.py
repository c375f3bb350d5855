"""gym_soccer_tpu_torch — the PyTorch + CUDA port of gym_soccer_tpu.

Runs on PyTorch tensors on any device; the hot path has hand-written CUDA
kernels for Hopper (sm_90a) beside plain PyTorch versions of the same
functions.  It imports neither JAX nor the JAX package, which stays the
reference that the port is tested against.

Layers (module paths mirror gym_soccer_tpu's):
  config.py        EnvConfig (a copy)
  core/rules.py    branchless game rules over numpy or torch
  core/tables.py   host-side state-space indexing and transition tensors
                   (numpy)
  core/batch.py    batched engine on tensors, counter RNG
  core/mt19937.py  the reference's MT19937 on tensors
  core/parity.py   bit-exact reference trajectories (float64 thresholds)
  agents/          RM+ matrix-game solver; Shapley iteration, best
                   response and exploitability
  ops/step_kernel.py     fused and journaled random rollouts (CUDA K1, K2)
  ops/learner_kernel.py  minimax-Q chunk (CUDA K5) and the chunked trainers
  ops/parity_kernel.py   bit-exact parity events, closed loop and scripted
                         (CUDA K12, K13)
  interop.py       state, journal, learner, MT19937 and parity layouts to
                   and from the JAX package
"""
from .config import EnvConfig, NOOP, NORTH, SOUTH, EAST, WEST  # noqa: F401

__version__ = "0.1.0"
