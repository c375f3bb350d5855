"""The system under test: the PyTorch and CUDA port, through its public
entries only.  Imported when a run sets up, never when this module is."""
from __future__ import annotations

import sys
from types import SimpleNamespace

# top-level module names that no run may hold: JAX and the JAX package
FOREIGN = ("jax", "jaxlib", "flax", "gym_soccer_tpu")


def load() -> SimpleNamespace:
    from gym_soccer_tpu_torch.agents.evaluation import exploitability
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.ops.learner_kernel import fused_minimax_train
    from gym_soccer_tpu_torch.ops.step_kernel import (fused_journal_rollout,
                                                      unpack_journal)
    return SimpleNamespace(EnvConfig=EnvConfig,
                           fused_journal_rollout=fused_journal_rollout,
                           unpack_journal=unpack_journal,
                           fused_minimax_train=fused_minimax_train,
                           exploitability=exploitability)


def env_config(program, board: dict):
    return program.EnvConfig(width=board["width"], height=board["height"],
                             slip_prob=board["slip_prob"],
                             max_steps=board.get("max_steps", 100))


def foreign_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
