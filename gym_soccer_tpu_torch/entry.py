"""The port's twin of the JAX package's ``__graft_entry__.entry()``.

``entry(device)`` returns ``(fn, example_args)``: ``fn(*example_args)``
runs one packed minimax-Q learner chunk (``packed_learner_chunk``, kernel
K5 on the card: act, batched env transition and Bellman-residual
accumulation in one launch) on 5x4 at slip 0.2, from the default trainer's
chunk-0 table (``pack_m2`` of uniform policies, v = 0, exploration eps
0.2) and its initial state fields.  On the card it runs the JAX package's
TPU shape, 8192 lanes x 64 steps; on the CPU (``device="cpu"``) 256 x 4,
the JAX entry's off-TPU shape, through the plain version.

The JAX entry's ``dryrun_multichip`` waits for the port of the mesh layer.
"""
from __future__ import annotations

import torch

from .config import EnvConfig
from .core import tables
from .ops import learner_kernel as lk

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)
CARD_SHAPE = (8192, 64)
CPU_SHAPE = (256, 4)


def entry(device="cuda"):
    """(fn, (seed, table, fields)) for one K5 chunk on ``device``; fn
    returns ``packed_learner_chunk``'s (fields, (sums, cnt), stats)."""
    device = torch.device(device)
    B, T = CARD_SHAPE if device.type == "cuda" else CPU_SHAPE
    nS = tables.build_statespace(CFG).nS
    uniform = torch.full((nS, 5), 0.2, dtype=torch.float32, device=device)
    table = lk.pack_m2(CFG, uniform, uniform,
                       torch.zeros(nS, dtype=torch.float32, device=device),
                       0.2)
    fields = lk.init_state_fields(CFG, B, device)

    def fn(seed, table, fields):
        return lk.packed_learner_chunk(CFG, seed, table, fields, B, T)

    return fn, (0, table, fields)
