"""gym_soccer_tpu_torch — the PyTorch + CUDA port of gym_soccer_tpu.

Runs on PyTorch tensors on any device; the hot path has hand-written CUDA
kernels for Hopper (sm_90a) beside plain PyTorch versions of the same
functions.  It imports neither JAX nor the JAX package, which stays the
reference that the port is tested against.

Layers (module paths mirror gym_soccer_tpu's):
  config.py        EnvConfig (a copy)
  spaces.py        Discrete, MultiDiscrete, Dict (a copy)
  registry.py      ``make``, ``register``, ``registry_ids`` (a copy)
  entry.py         ``entry()``: one K5 chunk of the default trainer
  native/          the C++ table builder and MT19937 stream generator
                   (copies of the JAX package's sources), built with g++
  core/rules.py    branchless game rules over numpy or torch
  core/tables.py   host-side state-space indexing and transition tensors
                   (numpy or the native builder)
  core/threefry.py jax.random's threefry2x32 (key, fold_in, split, bits,
                   uniform, randint), bit-equal
  core/batch.py    batched engine on tensors, threefry (default; kernel
                   T1 on the card) or counter RNG
  core/invariants.py  state invariants and a checked step
  core/multigrid.py  mixed-geometry codec, per-lane board geometry and
                   the threefry engine
  core/mt19937.py  the reference's MT19937 on tensors
  core/parity.py   bit-exact reference trajectories (float64 thresholds)
  envs/soccer_simultaneous_env.py  the reference-compatible facade
                   ``SoccerSimultaneousEnv`` (host numpy, a copy)
  envs/soccer_alternating_env.py  the alternating-turn game: tables, exact
                   value iteration (numpy and torch), the threefry engine,
                   a policy rollout and the single-env facade
  envs/vector_env.py  SoccerVectorEnv, the gym.vector-style facade
  agents/          RM+ matrix-game solver, the HBM-table learners (IQL,
                   minimax-Q, turn-based Q), the alternating game's greedy
                   policy; Shapley iteration, best response and
                   exploitability; the DP planners (VI/PI/MPI in numpy,
                   ``value_iteration_torch``)
  utils/policies.py  policy factories and persistence (a copy)
  utils/metrics.py, profiling.py, checkpoint.py  episode stats, timers and
                   traces, .npz checkpoints (reads the JAX package's)
  examples/        train_minimax (the entry point) and demo
  ops/threefry_kernel.py  per-lane threefry draws (CUDA T1)
  ops/step_kernel.py     fused, journaled, mixed-geometry and alternating
                         random rollouts (CUDA K1, K2, K3, K4)
  ops/rollout_codes.py   K1/K2's and K4's two stages on the host: step
                         codes, the step and tick tables, plain twins
  ops/learner_kernel.py  minimax-Q chunks, packed and unpacked, one board
                         or a mixture (CUDA K5, K6, K7), and the chunked
                         trainers
  ops/learner_codes.py   K5's two stages on the host: step codes, the walk
                         table, prepared rows, the call's layout, twins
  ops/*_variants.py      the redesigned kernels' timed variants (a card)
  ops/iql_kernel.py      independent-Q chunks (CUDA K8, K9) and trainer
  ops/altq_kernel.py     alternating-turn Q chunks (CUDA K10, K11) and
                         trainer
  ops/parity_kernel.py   bit-exact parity events, closed loop and scripted
                         (CUDA K12, K13)
  interop.py       state, journal, learner, MT19937 and parity layouts to
                   and from the JAX package
  tools/           check_parity (the facade and planners against the
                   reference's golden fixtures), the refcompat shim and
                   run_reference_tests
"""
from .config import EnvConfig, NOOP, NORTH, SOUTH, EAST, WEST  # noqa: F401
from .registry import make, register, registry_ids  # noqa: F401

__version__ = "0.1.0"
