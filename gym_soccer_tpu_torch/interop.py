"""Carry state between the JAX package's layouts and the port's.

Everything here takes and gives numpy arrays on the JAX side, so the port
never imports JAX: convert a JAX array with ``np.asarray`` first.

* The batched engine's ``EnvState``: the JAX package keeps a typed PRNG
  key per instance; the port keeps its two uint32 key words
  (``jax.random.key_data(state.key)``) in int64.  The alternating engine's
  ``AltEnvState`` (eight int32 leaves and the key) and the mixed-geometry
  engine's ``MultiGridState`` (seven and the key; the geometry is rebuilt
  from the configs) likewise.
* The HBM-table learners' states (``IQLState``, ``MinimaxQState``,
  ``AltQState``): their tables as they are, the env state as above, the
  step as an int32 scalar (``learner_state_from_numpy``).
* The fused kernels' state planes: the JAX package tiles lanes as
  int32 [B/128, 128] (lane = row * 128 + col); the port keeps them flat
  int32 [B] in the same lane order.
* The journal: int32 [T, B/128, 128] in the JAX package, [T, B] in the
  port, the same words in the same memory order.
* MT19937 states: uint32 [B, 624] in the JAX package, the same words in
  int64 [B, 624] in the port (core/mt19937.py).
* The parity backend's ``ParityState``: the same four [B] leaves (raw, t,
  cursor int32; needs_reset bool).
* The minimax-Q learner's state: the JAX package's packed M (bfloat16
  [spm, 128], 8 states per row) becomes the port's table (float32
  [n_codes, 11], ``table_from_packed_m``), and its unpacked M (bfloat16
  [spc, 128], one state per row) the port's unpacked table (float32
  [n_codes, 36], ``table_from_m``), for one board or a mixture (a tuple of
  configs: both packages concatenate the variants' 8-aligned blocks in the
  same rows).  A mixture's six geometry planes (H, W, glo, ghi, q_int, row
  offset; JAX's ``init_state_fields(cfgs, B)[0]``) are lane-tiled like the
  state fields and go through ``planes_from_tiles`` too.  The trainers'
  resume dict becomes the port's (the port's trainers take a JAX run's
  (q, v, pi_a, pi_b, n) as numpy arrays in ``init`` as they are; a
  mixture's resume dict holds the fields only).
* The independent-Q learner's state: the JAX package's M (bfloat16, both
  players' Q as double-bf16 hi/lo columns; packed [_spm_i, 128] with 6
  states per row, or unpacked [spc, 128] with one) becomes the port's
  table (float32 [n_codes, 10]); its trainer's resume dict (q_a, q_b,
  fields, next_chunk, packed) goes through ``resume_from_numpy``.
* The alternating-turn learner's state: the JAX package's M (bfloat16,
  each turnless cellpair's A-to-move and B-to-move Q as double-bf16 hi/lo
  column blocks; packed [_spm_t, 128] with 6 cellpairs per row, or
  unpacked [spc, 128] with one) becomes the port's table (float32
  [n_codes, 10], ``alt_table_from_m``); its trainer's resume dict (q,
  seven lane-tiled fields, next_chunk, packed) goes through
  ``resume_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import EnvConfig
from .core import rules
from .core.batch import EnvState
from .core.parity import ParityState
from .ops.learner_kernel import n_codes

LANES = 128
# The JAX package's packed M: GP states per 128-wide row, GCOLS columns
# each, pi_a at 0-4, pi_b at 5-9, v split as bf16 hi at 10 and lo at 11
# (gym_soccer_tpu/ops/learner_kernel.py, GP/GCOLS/PCOL_*).
M_GP, M_GCOLS, M_V_HI, M_V_LO = 8, 16, 10, 11
# The JAX package's unpacked M: one state per 128-wide row, pi_a at 0-4,
# pi_b at 5-9, q's bf16 hi at 10-34 and lo at 37-61, v's hi at 35 and lo
# at 36 (gym_soccer_tpu/ops/learner_kernel.py, COL_*).
M_Q_HI, M_V_HI_U, M_V_LO_U, M_Q_LO = 10, 35, 36, 37
# The JAX package's IQL M: each state's 20 columns hold A's Q hi at 0-4
# and lo at 5-9, B's hi at 10-14 and lo at 15-19; IQL_GP states per row
# when packed, one when not (gym_soccer_tpu/ops/iql_kernel.py, GP_I and
# COL_Q*).
IQL_GP, IQL_GCOLS = 6, 20


def env_state_from_numpy(fields, key_words, device) -> EnvState:
    """The port's EnvState from the JAX package's as numpy arrays.

    ``fields``: the seven int32 [B] leaves (rows_a, cols_a, rows_b, cols_b,
    poss, t, n), i.e. ``[np.asarray(x) for x in jax_state[:7]]``;
    ``key_words``: uint32 [B, 2], ``np.asarray(jax.random.key_data(
    jax_state.key))``."""
    fields = [np.asarray(f) for f in fields]
    if len(fields) != 7:
        raise ValueError("fields = 7 arrays (rows_a, cols_a, rows_b, "
                         "cols_b, poss, t, n)")
    tensors = [torch.as_tensor(f.astype(np.int32), device=device)
               for f in fields]
    key = torch.as_tensor(np.asarray(key_words).astype(np.int64),
                          device=device)
    return EnvState(*tensors, key=key)


def alt_env_state_from_numpy(fields, key_words, device):
    """The port's AltEnvState from the JAX package's: the eight int32 [B]
    leaves (rows_a, cols_a, rows_b, cols_b, poss, turn, t, n) and uint32
    [B, 2] key words, as numpy."""
    from .envs.soccer_alternating_env import AltEnvState
    fields = [np.asarray(f) for f in fields]
    if len(fields) != 8:
        raise ValueError("fields = 8 arrays (rows_a, cols_a, rows_b, "
                         "cols_b, poss, turn, t, n)")
    return AltEnvState(*(torch.as_tensor(f.astype(np.int32), device=device)
                         for f in fields),
                       key=torch.as_tensor(np.asarray(key_words).astype(
                           np.int64), device=device))


def multigrid_state_from_numpy(cfgs, fields, key_words, device,
                               max_steps: int = 100):
    """The port's MultiGridState from the JAX package's: its seven int32
    [B] leaves and uint32 [B, 2] key words as numpy; the lanes' geometry
    is rebuilt from ``cfgs`` (round-robin, as both packages assign it)."""
    from .core import multigrid
    st = env_state_from_numpy(fields, key_words, device)
    geo = multigrid.lane_geometry(tuple(cfgs), st.t.shape[0], max_steps,
                                  device=device)
    return multigrid.MultiGridState(*st, geo=geo)


def learner_state_from_numpy(cls, env, device, **arrays):
    """A learner state ``cls`` (agents/learners ``IQLState``,
    ``MinimaxQState`` or ``AltQState``) from the JAX package's leaves as
    numpy (``step`` a 0-d int32) and the port's env state ``env``."""
    return cls(env=env, **{k: torch.tensor(np.asarray(v), device=device)
                           for k, v in arrays.items()})


def env_state_to_numpy(state: EnvState):
    """(the seven int32 [B] leaves, uint32 [B, 2] key words) as numpy."""
    fields = [f.cpu().numpy() for f in state[:7]]
    return fields, state.key.cpu().numpy().astype(np.uint32)


def planes_from_tiles(planes, device):
    """Lane-tiled int32 [B/128, 128] planes -> flat int32 [B] tensors."""
    return tuple(torch.tensor(np.asarray(p, np.int32).reshape(-1),
                              device=device) for p in planes)


def planes_to_tiles(planes):
    """Flat [B] tensors -> lane-tiled int32 [B/128, 128] numpy planes."""
    return tuple(p.cpu().numpy().astype(np.int32).reshape(-1, LANES)
                 for p in planes)


def journal_from_tiles(journal, device) -> torch.Tensor:
    """int32 [T, B/128, 128] journal -> int32 [T, B] tensor."""
    j = np.asarray(journal, np.int32)
    return torch.tensor(j.reshape(j.shape[0], -1), device=device)


def journal_to_tiles(journal: torch.Tensor) -> np.ndarray:
    """int32 [T, B] journal -> int32 [T, B/128, 128] numpy."""
    j = journal.cpu().numpy()
    return j.reshape(j.shape[0], -1, LANES)


def table_from_packed_m(cfg, m, device) -> torch.Tensor:
    """The JAX package's packed M (``np.asarray(m, np.float32)``, [spm,
    128]) -> the port's table float32 [n_codes, 11]: pi columns as they
    are, v = v_hi + v_lo (the value the JAX kernel bootstraps from).
    ``cfg``: one EnvConfig or a mixture's tuple."""
    m = np.asarray(m, np.float32).reshape(-1)
    codes = np.arange(n_codes(cfg))
    base = (codes // M_GP) * LANES + (codes % M_GP) * M_GCOLS
    pi = m[base[:, None] + np.arange(10)[None, :]]
    v = m[base + M_V_HI] + m[base + M_V_LO]
    table = np.concatenate([pi, v[:, None]], axis=1).astype(np.float32)
    return torch.tensor(table, device=device)


def table_from_m(cfg, m, device) -> torch.Tensor:
    """The JAX package's unpacked M (``np.asarray(m, np.float32)``, [spc,
    128] from ``pack_m``) -> the port's unpacked table float32 [n_codes,
    36]: pi columns as they are, then v = v_hi + v_lo and q = q_hi + q_lo
    (the values the JAX kernel reads).  ``cfg``: one EnvConfig or a
    mixture's tuple."""
    m = np.asarray(m, np.float32).reshape(-1, LANES)[:n_codes(cfg)]
    v = m[:, M_V_HI_U] + m[:, M_V_LO_U]
    q = m[:, M_Q_HI:M_Q_HI + 25] + m[:, M_Q_LO:M_Q_LO + 25]
    table = np.concatenate([m[:, :10], v[:, None], q], axis=1)
    return torch.tensor(table.astype(np.float32), device=device)


def iql_table_from_packed_m(cfg: EnvConfig, m, packed: bool,
                            device) -> torch.Tensor:
    """The JAX package's IQL M (``np.asarray(m, np.float32)``: [_spm_i,
    128] from ``pack_iql_m2`` if ``packed``, else [spc, 128] from
    ``pack_iql_m``) -> the port's table float32 [n_codes, 10]: A's five
    values, then B's, each hi + lo (the value the JAX kernel acts on)."""
    m = np.asarray(m, np.float32).reshape(-1)
    codes = np.arange(rules.n_cellpairs(cfg))
    base = ((codes // IQL_GP) * LANES + (codes % IQL_GP) * IQL_GCOLS
            if packed else codes * LANES)
    k = np.arange(5)[None, :]
    q_a = m[base[:, None] + k] + m[base[:, None] + 5 + k]
    q_b = m[base[:, None] + 10 + k] + m[base[:, None] + 15 + k]
    return torch.tensor(np.concatenate([q_a, q_b], axis=1), device=device)


# The JAX package's alternating M (``pack_alt_m2``: [_spm_t, 128], GP_T =
# 6 turnless cellpairs per row; ``pack_alt_m``: [spc, 128], one) holds in
# each cellpair's 20 columns the A-to-move Q hi at 0-4 and lo at 5-9 and
# the B-to-move hi at 10-14 and lo at 15-19 (gym_soccer_tpu/ops/
# altq_kernel.py, COL_QA* and COL_QB*): the IQL M's layout, with the
# mover in place of the player.  The port's alternating table [n_codes,
# 10] is the IQL table's layout too, so one reader serves both.
alt_table_from_m = iql_table_from_packed_m


def resume_from_numpy(resume: dict, device) -> dict:
    """A JAX trainer's resume dict (values as numpy arrays; ``fields`` as
    lane-tiled [B/128, 128] planes) -> the port's: float32 tensors, flat
    int32 [B] fields, ``next_chunk`` and ``packed`` as Python values."""
    out = {}
    for k, val in resume.items():
        if k == "fields":
            out[k] = planes_from_tiles(val, device)
        elif k == "next_chunk":
            out[k] = int(np.asarray(val))
        elif k == "packed":
            out[k] = bool(np.asarray(val))
        else:
            out[k] = torch.tensor(np.asarray(val, np.float32), device=device)
    return out


def mt_states_from_numpy(states, device) -> torch.Tensor:
    """uint32 [B, 624] MT19937 states -> the port's int64 [B, 624]."""
    return torch.as_tensor(np.asarray(states, np.uint32).astype(np.int64),
                           device=device)


def mt_states_to_numpy(states: torch.Tensor) -> np.ndarray:
    """The port's int64 [B, 624] MT19937 states -> uint32 numpy."""
    return states.cpu().numpy().astype(np.uint32)


def parity_state_from_numpy(state, device) -> ParityState:
    """The JAX package's ParityState as numpy arrays (``[np.asarray(x) for
    x in state]``: raw, t, cursor int32 [B]; needs_reset bool [B]) -> the
    port's."""
    raw, t, cursor, needs_reset = (np.asarray(x) for x in state)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)
    return ParityState(raw=i32(raw), t=i32(t), cursor=i32(cursor),
                       needs_reset=torch.as_tensor(needs_reset.astype(bool),
                                                   device=device))


def parity_state_to_numpy(state: ParityState):
    """The port's ParityState -> (raw, t, cursor int32; needs_reset bool)
    numpy arrays, the JAX package's leaves in order."""
    return tuple(x.cpu().numpy() for x in state)
