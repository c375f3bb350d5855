"""The two stages of the K5 learner kernel, on the host.

``csrc/learner_kernel.cu`` splits a lane-step of ``packed_learner_chunk``
(K5) in two, as K1/K2 split a rollout step (ops/rollout_codes.py).
Producer warps hash each (lane, step) into the step's 40 random bits that
follow from (chunk seed, step, lane) alone: word 0 as it is (the two 16-bit
sampling uniforms) and a side byte holding each player's slip class (0:
keep the move, 1: its first orthogonal, 2: its second), the two coin bits
and the ISD index.  Consumer threads, one a lane, read the state's
prepared row, retire the previous step, sample both actions, map each
action and slip class to its effective move and step by the branch-free
transition.  This module holds what the host needs for that and a plain
PyTorch twin of both stages, written the way the kernel computes them, so
that the CPU tests can hold the design to ``packed_learner_chunk_plain``
and to the JAX package bit for bit:

* ``learner_codes``: the producers' stage.
* ``prepare_rows``: the per-call prep pass's rows.  Row k holds compact
  code k's running sums of pi_a and pi_b in index order with their totals
  (so a sample is one multiply and four compares, the same float32
  roundings as ``sample5``), v and the row's first accumulator cell (k *
  25, as int32 bits): [cA0, cA1, cA2, cA3 | totA, cB0, cB1, cB2 | cB3,
  totB, v, cell], 48 B.  Where they fit one block's shared memory beside
  the widest ring (``shared_rows``: 5x4's 1104 rows, 52,992 B), the kernel
  copies them there; elsewhere (11x7) it reads them from L2.
* ``chunk_twin``: the consumers' stage over a whole chunk.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import EnvConfig
from ..core import rules
from . import learner_kernel as lk
from . import rollout_codes as rc
from . import step_kernel as sk

ROW_FLOATS = 12         # a prepared row, 48 B
# The kernel's ring (csrc/learner_kernel.cu kTile, kRingStages,
# kProducers): tiles of 8 steps of a word and a side byte, 2 tiles.
TILE_STEPS = 8
STAGES = 2
PRODUCER_WARPS = 8
SMEM_BUDGET = rc.SMEM_BUDGET
MAX_LANES = 512         # kMaxLanes: 768 threads a block with the producers
SMS = 132               # one wave on an H100 SXM
HEAD_BYTES = 16 + 80    # the mbarrier, the ISD entries' fields
# (slip class, action) -> the action whose move is made, a nibble each:
# class 0 keeps the action, 1 and 2 take rollout_codes' orthogonals.
EFFECT = (0x43210 | rc.FIRST_ORTHOGONAL << 20 | rc.SECOND_ORTHOGONAL << 40)


def slip_class(u, q_int: int):
    """0 where ``_slipped_move`` keeps the move (u < 65536 - q), 1 where it
    takes the first orthogonal, 2 the second."""
    return (u >= 65536 - q_int).long() + (u >= 65536 - q_int // 2).long()


def class_move(cls, a):
    """The action whose move action ``a`` makes under slip class ``cls``
    (``rollout_codes.effective_move`` by class)."""
    return (EFFECT >> (4 * (cls * 5 + a))) & 7


def learner_codes(cfg: EnvConfig, seed: int, lanes: torch.Tensor,
                  n_steps: int):
    """The producers' stage: (int64 [n_steps, len(lanes)] word 0, int32
    side bytes: slip class a | slip class b << 2 | coin << 4 | ISD index
    << 6) of the global lane ids ``lanes`` at steps 0 .. n_steps - 1."""
    q_int = sk._q_int(cfg)
    nI = sk._n_isd(cfg)
    words = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int64)
    side = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int32)
    for i in range(n_steps):
        bits0, bits1, bits2 = (sk._random_word(seed, i, w, lanes)
                               for w in range(3))
        words[i] = bits0
        side[i] = (slip_class(sk._u16(bits1, 0), q_int)
                   | slip_class(sk._u16(bits1, 1), q_int) << 2
                   | (bits2 & 3) << 4
                   | rc.isd_pick(sk._u16(bits2, 1), nI).long() << 6)
    return words, side


# ----------------------------------------------------------------------
# What the host needs
# ----------------------------------------------------------------------

def _align16(n: int) -> int:
    return -(-n // 16) * 16


def ring_bytes(lanes: int) -> int:
    """STAGES tiles of TILE_STEPS words and side bytes a lane."""
    return STAGES * TILE_STEPS * 5 * lanes


def smem_bytes(lanes: int, n_rows: int) -> int:
    """Dynamic shared memory of one block of ``lanes`` lanes: the head, the
    prepared rows of ``n_rows`` codes (0 where they stay in device memory)
    and the ring (csrc/learner_kernel.cu ``packed_smem_bytes``)."""
    return HEAD_BYTES + 4 * ROW_FLOATS * n_rows + ring_bytes(lanes)


@functools.lru_cache(maxsize=None)
def shared_rows(cfg: EnvConfig) -> bool:
    """The geometry's choice: the prepared rows in shared memory when they
    fit beside the ring of the widest block (5x4: 1104 codes); in device
    memory otherwise (11x7: 13612)."""
    return smem_bytes(MAX_LANES, lk.n_codes(cfg)) <= SMEM_BUDGET


def default_lanes(batch: int) -> int:
    """Lanes per block for ``batch`` lanes: the fewest multiple of 32 that
    keeps the grid to one wave of SMS blocks (8192: 64, 65536: 512)."""
    return min(MAX_LANES, max(32, -(-batch // (SMS * 32)) * 32))


def check_lanes(batch: int, threads) -> int:
    """The lanes per block of a K5 launch: ``threads``, or
    ``default_lanes(batch)`` when None: a multiple of 32 in [32,
    MAX_LANES] (every one fits its shared memory), else ValueError."""
    lanes = default_lanes(batch) if threads is None else threads
    if (not isinstance(lanes, int) or lanes <= 0 or lanes % 32
            or lanes > MAX_LANES):
        raise ValueError(f"threads (lanes per block) must be a multiple of 32 "
                         f"in [32, {MAX_LANES}], got {threads}")
    return lanes


class Layout(NamedTuple):
    """Byte offsets in the one allocation of a K5 call: the int64 sums,
    the int64 stats and the int32 counts (zeroed together, up to
    ``zero``), the six output planes and the prep pass's rows
    (csrc/learner_kernel.cu ``chunk_layout``)."""
    sums: int
    stats: int
    cnt: int
    zero: int
    fields: int
    rows: int
    total: int


@functools.lru_cache(maxsize=64)
def layout(n_codes: int, batch: int) -> Layout:
    stats = 8 * lk.NJ * n_codes
    cnt = stats + 32
    zero = cnt + 4 * lk.NJ * n_codes
    fields = _align16(zero)
    rows = _align16(fields + 24 * batch)
    return Layout(0, stats, cnt, zero, fields, rows,
                  rows + 4 * ROW_FLOATS * n_codes)


# ----------------------------------------------------------------------
# The plain twin of both stages
# ----------------------------------------------------------------------

def prepare_rows(table: torch.Tensor) -> torch.Tensor:
    """The prep pass's rows (float32 [n_codes, 12]) of ``table``: running
    sums of pi_a and pi_b in index order, their totals, v and the first
    accumulator cell (code * 25) as int32 bits."""
    cols = []
    for base in (lk.COL_PI_A, lk.COL_PI_B):
        s = table[:, base]
        run = [s]
        for k in range(1, 5):
            s = s + table[:, base + k]
            run.append(s)
        cols.append(run)
    cell = (torch.arange(table.shape[0], dtype=torch.int32) * lk.NJ) \
        .view(torch.float32)
    return torch.stack([*cols[0], *cols[1], table[:, lk.COL_V], cell], 1)


def _sample(row, word):
    """Both actions at the prepared rows ``row`` from word 0's halves."""
    inv = 1.0 / 65536.0
    ua = (word & 0xFFFF).float() * inv
    ub = (word >> 16).float() * inv
    ta, tb = ua * row[:, 4], ub * row[:, 9]
    aa = sum((row[:, k] <= ta).long() for k in range(4))
    ab = sum((row[:, 5 + k] <= tb).long() for k in range(4))
    return aa, ab


def chunk_twin(cfg: EnvConfig, seed: int, table: torch.Tensor, fields,
               n_steps: int, gamma: float):
    """The consumers' stage of a chunk on the CPU, from
    ``learner_codes``' codes and ``prepare_rows``' rows: returns what
    ``packed_learner_chunk_plain`` returns."""
    fields = tuple(f.to(torch.int64) for f in fields)
    B = fields[0].shape[0]
    n = lk.n_codes(cfg)
    words, side = learner_codes(cfg, seed, torch.arange(B), n_steps)
    rows = prepare_rows(table)
    gamma_f = torch.tensor(np.float32(gamma))
    zero = torch.zeros((), dtype=torch.float32)
    limit = lk.value_limit(B, n_steps)
    sums = torch.zeros(n * lk.NJ, dtype=torch.int64)
    cnt = torch.zeros(n * lk.NJ, dtype=torch.int32)
    rew = torch.zeros(B, dtype=torch.int64)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    oor = torch.zeros((), dtype=torch.int64)
    pend = None
    for word, sd in zip(words, side.long()):
        row = rows[rules.cellpair_encode(torch, *fields[:5], cfg).long()]
        v = row[:, 10]
        oor += lk._out_of_range(v, limit)
        if pend is not None:
            lk._retire(sums, cnt, *pend[:3], v, pend[3])
        aa, ab = _sample(row, word)
        ea, eb = class_move(sd & 3, aa), class_move((sd >> 2) & 3, ab)
        ra, ca, rb, cb, p, goal, r = sk.transition_core(
            *fields[:5], ea, eb, torch.zeros_like(word), (sd >> 4) & 3, cfg,
            0)
        t = fields[5] + 1
        trunc = (t >= cfg.max_steps) & ~goal
        term = goal | trunc
        reset = sk._isd_lookup(sd >> 6, cfg)
        fields = (*(torch.where(term, i, f) for i, f in
                    zip(reset, (ra, ca, rb, cb, p))), torch.where(term, 0, t))
        pend = (row[:, 11].view(torch.int32).long() + aa * 5 + ab, r.float(),
                torch.where(term, zero, gamma_f), v)
        rew += r
        goals += goal
        truncs += trunc
    v_end = rows[rules.cellpair_encode(torch, *fields[:5], cfg).long(), 10]
    oor += lk._out_of_range(v_end, limit)
    lk._retire(sums, cnt, *pend[:3], v_end, pend[3])
    return (tuple(f.to(torch.int32) for f in fields),
            (sums.reshape(-1, lk.NJ), cnt.reshape(-1, lk.NJ)),
            (rew.sum(), goals.sum(), truncs.sum(), oor))
