"""The two stages of the K5, K6 and K7 learner kernels, on the host.

``csrc/learner_kernel.cu`` splits a lane-step of ``packed_learner_chunk``
(K5), ``multigrid_packed_learner_chunk`` (K6), ``learner_chunk`` and
``multigrid_learner_chunk`` (K7, its two call sites) in two, as K1/K2 split
a rollout step (ops/rollout_codes.py).  Producer warps hash each (lane,
step) into the step's 40 random bits that follow from (chunk seed, step,
lane) alone: word 0 as it is (the two 16-bit sampling uniforms) and a side
byte holding each player's slip class (0: keep the move, 1: its first
orthogonal, 2: its second), the two coin bits and the ISD index.  Consumer
threads, one a lane, read the state's prepared row, retire the previous
step, sample both actions, map each action and slip class to its effective
move and step by the branch-free transition.  This module holds what the
host needs for that and a plain PyTorch twin of both stages, written the
way the kernel computes them, so that the CPU tests can hold the design to
the plain versions (``packed_learner_chunk_plain``,
``multigrid_packed_learner_chunk_plain``, ``learner_chunk_plain``,
``multigrid_learner_chunk_plain``) bit for bit and to the JAX package:

* ``learner_codes``: the producers' stage.
* ``prepare_rows``: the per-call prep pass's rows.  Row k holds compact
  code k's running sums of pi_a and pi_b in index order with their totals
  (so a sample is one multiply and four compares, the same float32
  roundings as ``sample5``), v and the row's first accumulator cell (k *
  25, as int32 bits): [cA0, cA1, cA2, cA3 | totA, cB0, cB1, cB2 | cB3,
  totB, v, cell], 48 B.  Where they fit one block's shared memory beside
  the widest ring (``shared_rows``: 5x4's 1104 rows, 52,992 B; the
  ``--multigrid`` recipe's 5x4 + 6x5, 3,624 rows), the kernel copies them
  there; elsewhere (11x7, the 3-board mixture's 8,928) it reads them from
  L2.  K7's 36-column table gives the same rows.
* ``chunk_twin``: the consumers' stage over a whole chunk.  K5 and K6
  retire each visit against v(s), K7 against q(s, a), loaded from its
  table after the sample; on a mixture (K6, K7 multigrid) each lane's slip
  classes and ISD index are its board's, its row is offset by its
  variant's block, and its resets are computed as K3's are
  (csrc/pipeline.cuh ``LaneBoard``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

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
MAX_LANES = rc.MAX_LANES   # kMaxLanes: 768 threads a block with the producers
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


def learner_codes(cfg, seed: int, lanes: torch.Tensor, n_steps: int):
    """The producers' stage: (int64 [n_steps, len(lanes)] word 0, int32
    side bytes: slip class a | slip class b << 2 | coin << 4 | ISD index
    << 6) of the global lane ids ``lanes`` at steps 0 .. n_steps - 1.
    ``cfg``: an EnvConfig, or a GeoPlanes whose planes, indexed like
    ``lanes``, give each lane its q_int and its ISD mask (3 on an even
    board, 1 on an odd one)."""
    q_int = sk._q_int(cfg)
    if isinstance(cfg, sk.GeoPlanes):
        mask = torch.where(cfg.H % 2 == 0, 3, 1)
        pick = lambda u: u & mask   # noqa: E731
    else:
        nI = sk._n_isd(cfg)
        pick = lambda u: rc.isd_pick(u, nI)   # noqa: E731
    words = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int64)
    side = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int32)
    for i in range(n_steps):
        bits0, bits1, bits2 = (sk._random_word(seed, i, w, lanes)
                               for w in range(3))
        words[i] = bits0
        side[i] = (slip_class(sk._u16(bits1, 0), q_int)
                   | slip_class(sk._u16(bits1, 1), q_int) << 2
                   | (bits2 & 3) << 4
                   | pick(sk._u16(bits2, 1)).long() << 6)
    return words, side


# ----------------------------------------------------------------------
# What the host needs
# ----------------------------------------------------------------------

def _align16(n: int) -> int:
    return -(-n // 16) * 16


def ring_bytes(lanes: int) -> int:
    """STAGES tiles of TILE_STEPS words and side bytes a lane."""
    return STAGES * TILE_STEPS * 5 * lanes


def smem_bytes(lanes: int, n_rows: int, multi: bool = False) -> int:
    """Dynamic shared memory of one block of ``lanes`` lanes: the head, the
    prepared rows of ``n_rows`` codes (0 where they stay in device memory),
    the ring and, on a mixture (``multi``), a 16-B slip entry a lane
    (csrc/learner_kernel.cu ``chunk_smem_bytes``)."""
    return (HEAD_BYTES + 4 * ROW_FLOATS * n_rows + ring_bytes(lanes)
            + (16 * lanes if multi else 0))


@functools.lru_cache(maxsize=None)
def shared_rows(cfg) -> bool:
    """The geometry's choice (``cfg`` one board or a mixture): the prepared
    rows in shared memory when they fit beside the ring of the widest block
    (5x4: 1104 codes; 5x4 + 6x5: 3624, 223,200 B with a mixture's slip
    entries); in device memory otherwise (11x7: 13612; the 3-board
    mixture: 8928; 5x4 + 11x7: 14720)."""
    multi = isinstance(cfg, tuple)
    return smem_bytes(MAX_LANES, lk.n_codes(cfg), multi) <= SMEM_BUDGET


def default_lanes(batch: int) -> int:
    """Lanes per block for ``batch`` lanes: the fewest multiple of 32 that
    keeps the grid to one wave of SMS blocks (8192: 64, 16384: 128, 32768:
    256, 65536: 512)."""
    return min(MAX_LANES, max(32, -(-batch // (SMS * 32)) * 32))


def check_lanes(batch: int, threads) -> int:
    """The lanes per block of a K5, K6 or K7 launch: ``threads``, or
    ``default_lanes(batch)`` when None: a multiple of 32 in [32,
    MAX_LANES] (every one fits its shared memory), else ValueError."""
    return rc.lanes_per_block(threads, default_lanes(batch))


class Layout(NamedTuple):
    """Byte offsets in the one allocation of a K5, K6 or K7 call: the int64
    sums, the int64 stats and the int32 counts (zeroed together, up to
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


def chunk_twin(cfg, seed: int, table: torch.Tensor, fields, n_steps: int,
               gamma: float, planes=None):
    """The consumers' stage of a chunk on the CPU, from
    ``learner_codes``' codes and ``prepare_rows``' rows: returns what the
    plain version returns.  ``table``'s width picks the layout: 11 columns
    K5's residuals against v(s), 36 K7's TD against q(s, a); ``planes``
    (the six planes of ``init_state_fields(cfgs, ...)``, ``cfg`` a tuple)
    puts each lane on its own board, K6 or K7's multigrid site."""
    packed = table.shape[1] == lk.TABLE_COLS
    fields = tuple(f.to(torch.int64) for f in fields)
    B = fields[0].shape[0]
    n = lk.n_codes(cfg)
    if planes is None:
        geo, cpo, max_steps = cfg, 0, cfg.max_steps
    else:
        max_steps = cfg[0].max_steps
        geo = sk.GeoPlanes(*(x.long() for x in planes[:5]), max_steps)
        cpo = planes[5].long()
        mid_lo, mid_hi = (geo.H - 1) // 2, geo.H // 2
    words, side = learner_codes(geo, seed, torch.arange(B), n_steps)
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

    def settle(v):
        """The pending visits' retirement against ``v``, K7's baselines
        tested for range with it."""
        nonlocal oor
        if pend is not None:
            if not packed:
                oor += lk._out_of_range(pend[3], limit)
            lk._retire(sums, cnt, *pend[:3], v, pend[3])

    for word, sd in zip(words, side.long()):
        k = rules.cellpair_encode(torch, *fields[:5], geo).long() + cpo
        row = rows[k]
        v = row[:, 10]
        oor += lk._out_of_range(v, limit)
        settle(v)
        aa, ab = _sample(row, word)
        ja = aa * 5 + ab
        base = v if packed else table[k, lk.COL_Q + ja]
        ea, eb = class_move(sd & 3, aa), class_move((sd >> 2) & 3, ab)
        ra, ca, rb, cb, p, goal, r = sk.transition_core(
            *fields[:5], ea, eb, torch.zeros_like(word), (sd >> 4) & 3, geo,
            0)
        t = fields[5] + 1
        late = t >= max_steps
        term = goal | late
        idx = sd >> 6
        if planes is None:
            reset = sk._isd_lookup(idx, cfg)
        else:
            swap = (idx >> 1) == 1
            reset = (torch.where(swap, mid_hi, mid_lo),
                     torch.full_like(ra, 2), torch.where(swap, mid_lo,
                                                         mid_hi),
                     geo.W - 3, idx & 1)
        fields = (*(torch.where(term, i, f) for i, f in
                    zip(reset, (ra, ca, rb, cb, p))), torch.where(term, 0, t))
        pend = (row[:, 11].view(torch.int32).long() + ja, r.float(),
                torch.where(term, zero, gamma_f), base)
        rew += r
        goals += goal
        truncs += late & ~goal
    k = rules.cellpair_encode(torch, *fields[:5], geo).long() + cpo
    v_end = rows[k, 10]
    oor += lk._out_of_range(v_end, limit)
    settle(v_end)
    return (tuple(f.to(torch.int32) for f in fields),
            (sums.reshape(-1, lk.NJ), cnt.reshape(-1, lk.NJ)),
            (rew.sum(), goals.sum(), truncs.sum(), oor))
