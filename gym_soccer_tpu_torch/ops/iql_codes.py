"""The two stages of the K8 and K9 independent-Q kernels, on the host.

``csrc/iql_kernel.cu`` splits a lane-step of ``iql_packed_chunk`` (K8)
and ``iql_chunk`` (K9) in two, as K5 splits a minimax-Q step
(ops/learner_codes.py).  Producer warps hash each (lane, step) into a
14-bit step code that follows from (chunk seed, step + step_offset, lane)
and the chunk's eps_int alone: each player's choice (an explored action
0-4, or ``GREEDY``: take the state's greedy action), each player's slip
class (0: keep the move, 1: its first orthogonal, 2: its second), the two
coin bits and the ISD index.  A prep pass turns each row of the chunk's
frozen table into what a step needs of it: both players' greedy actions
(the strict ``>`` scan from action 0) and maxes.  Consumer threads, one a
lane, read the state's prepared row, retire the previous step against its
maxes, take each action (the code's, or the row's greedy one), map action
and slip class to the effective move and step by the branch-free
transition.  This module holds what the host needs for that and a plain
PyTorch twin of both stages, written the way the kernel computes them, so
that the CPU tests can hold the design to the plain versions
(``iql_packed_chunk_plain``, ``iql_chunk_plain``) bit for bit and to the
JAX package:

* ``iql_codes``: the producers' stage.  Code bits: A's choice 0-2, B's
  choice 3-5, A's slip class 6-7, B's 8-9, the coin bits 10-11, the ISD
  index 12-13.
* ``prepare_rows``: the prep pass.  Row k is compact code k's (max q_A,
  max q_B) as a float32 pair and its greedy actions g_A | g_B << 3 in one
  byte; the pairs of all codes, then the bytes: 9 B a code
  (``row_bytes``: 9,936 B on 5x4, 122,512 B on 11x7).  Both boards' rows
  fit one block's shared memory beside the ring of the widest block
  (``shared_rows``), and the kernel copies them there; a larger board's
  stay in L2.
* ``chunk_twin``: the consumers' stage over a whole chunk.  K9's baseline
  q(s, a) is read from the table after the actions are known.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import N_ACTIONS
from ..core import rules
from . import iql_kernel as ik
from . import learner_codes as lc
from . import learner_kernel as lk
from . import rollout_codes as rc
from . import step_kernel as sk

COLS = ik.IQL_COLS      # a table and accumulator row: A's five, then B's
GREEDY = 7              # a choice: the state's greedy action
# The kernel's ring (csrc/iql_kernel.cu kTile, kRingStages, kProducers):
# tiles of 8 steps of a 16-bit code, 2 tiles.
TILE_STEPS = lc.TILE_STEPS
STAGES = lc.STAGES
PRODUCER_WARPS = lc.PRODUCER_WARPS
SMEM_BUDGET = lc.SMEM_BUDGET
MAX_LANES = lc.MAX_LANES
HEAD_BYTES = lc.HEAD_BYTES   # the mbarrier, the ISD entries' fields
# csrc/iql_kernel.cu kAccMaxVisits: a block's private accumulators in
# shared memory are exact while it adds at most 2**16 values to a cell.
ACC_MAX_VISITS = 1 << 16
# Lanes per block: K5's rule, one wave of 132 blocks (8192: 64, 65536: 512).
default_lanes = lc.default_lanes
check_lanes = lc.check_lanes


def iql_codes(cfg, seed: int, eps_int: int, lanes: torch.Tensor,
              n_steps: int, step_offset: int = 0) -> torch.Tensor:
    """The producers' stage: int32 [n_steps, len(lanes)] step codes of the
    global lane ids ``lanes`` at steps step_offset .. step_offset +
    n_steps - 1 (the module's bit layout)."""
    q_int, nI = sk._q_int(cfg), sk._n_isd(cfg)
    codes = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int32)
    for i in range(n_steps):
        b0, b1, b2, b3 = (sk._random_word(seed, i + step_offset, w, lanes)
                          for w in range(4))
        xa, xb = (torch.where(sk._u16(b, 0) < eps_int,
                              sk._u16(b, 1) % N_ACTIONS, GREEDY)
                  for b in (b0, b3))
        codes[i] = (xa | xb << 3
                    | lc.slip_class(sk._u16(b1, 0), q_int) << 6
                    | lc.slip_class(sk._u16(b1, 1), q_int) << 8
                    | (b2 & 3) << 10
                    | rc.isd_pick(sk._u16(b2, 1), nI).long() << 12)
    return codes


# ----------------------------------------------------------------------
# What the host needs
# ----------------------------------------------------------------------

def _align16(n: int) -> int:
    return -(-n // 16) * 16


def row_bytes(n_codes: int) -> int:
    """The prep pass's rows of ``n_codes`` codes: a float32 pair and a
    byte each, padded to 16 B."""
    return _align16(9 * n_codes)


def ring_bytes(lanes: int) -> int:
    """STAGES tiles of TILE_STEPS 16-bit codes a lane."""
    return STAGES * TILE_STEPS * 2 * lanes


def acc_bytes(n_codes: int) -> int:
    """One block's private accumulators of ``n_codes`` codes: four 32-bit
    words a cell (the sums of a fixed-point value's bits 0-15, 16-31 and
    32-63, and the count), COLS cells a code."""
    return 16 * COLS * n_codes


def smem_bytes(lanes: int, n_rows: int, n_acc: int = 0) -> int:
    """Dynamic shared memory of one block of ``lanes`` lanes: the head,
    the prepared rows of ``n_rows`` codes (0 where they stay in device
    memory), the ring and the private accumulators of ``n_acc`` codes (0
    where the kernel adds to device memory; csrc/iql_kernel.cu
    ``smem_bytes``)."""
    return (HEAD_BYTES + row_bytes(n_rows) + ring_bytes(lanes)
            + acc_bytes(n_acc))


@functools.lru_cache(maxsize=None)
def shared_rows(cfg) -> bool:
    """The prepared rows in shared memory when they fit beside the ring of
    the widest block (5x4: 1104 codes; 11x7: 13612), else in L2."""
    return smem_bytes(MAX_LANES, lk.n_codes(cfg)) <= SMEM_BUDGET


def shared_acc(cfg, lanes: int, n_steps: int) -> bool:
    """The kernel's choice (csrc/iql_kernel.cu ``placement``): each block's
    own accumulators in shared memory when the rows are there, the
    accumulators fit beside them at the widest block (5x4) and a block adds
    at most ACC_MAX_VISITS values to a cell (lanes x n_steps); else every
    visit adds to device memory."""
    n = lk.n_codes(cfg)
    return (shared_rows(cfg) and smem_bytes(MAX_LANES, n, n) <= SMEM_BUDGET
            and lanes * n_steps <= ACC_MAX_VISITS)


def block_smem_bytes(cfg, lanes: int, n_steps: int) -> int:
    """The dynamic shared memory of one block of a call's launch."""
    n = lk.n_codes(cfg)
    return smem_bytes(lanes, n if shared_rows(cfg) else 0,
                      n if shared_acc(cfg, lanes, n_steps) else 0)


class Layout(NamedTuple):
    """Byte offsets in the one allocation of a K8 or K9 call: the int64
    sums, the int64 stats and the int32 counts (zeroed together, up to
    ``zero``), the six output planes and the prep pass's rows
    (csrc/iql_kernel.cu ``iql_layout``)."""
    sums: int
    stats: int
    cnt: int
    zero: int
    fields: int
    rows: int
    total: int


@functools.lru_cache(maxsize=64)
def layout(n_codes: int, batch: int) -> Layout:
    stats = 8 * COLS * n_codes
    cnt = stats + 32
    zero = cnt + 4 * COLS * n_codes
    fields = _align16(zero)
    rows = _align16(fields + 24 * batch)
    return Layout(0, stats, cnt, zero, fields, rows,
                  rows + row_bytes(n_codes))


# ----------------------------------------------------------------------
# The plain twin of both stages
# ----------------------------------------------------------------------

def _scan(q):
    """The prep pass's greedy action and max of five columns: a strict
    ``>`` scan from action 0, so the lowest index wins a tie."""
    best, g = q[:, 0], torch.zeros(q.shape[0], dtype=torch.int32)
    for k in range(1, N_ACTIONS):
        upd = q[:, k] > best
        g = torch.where(upd, k, g)
        best = torch.where(upd, q[:, k], best)
    return g, best


def prepare_rows(table: torch.Tensor):
    """The prep pass's rows of ``table`` (float32 [n_codes, 10]): (float32
    [n_codes, 2] of (max q_A, max q_B), int32 [n_codes] of g_A | g_B <<
    3)."""
    ga, va = _scan(table[:, :N_ACTIONS])
    gb, vb = _scan(table[:, N_ACTIONS:])
    return torch.stack([va, vb], 1), ga | gb << 3


def chunk_twin(cfg, seed: int, eps_int: int, table: torch.Tensor, fields,
               n_steps: int, gamma: float, step_offset: int = 0,
               packed: bool = True):
    """The consumers' stage of a chunk on the CPU, from ``iql_codes``'
    codes and ``prepare_rows``' rows: returns what the plain version
    returns.  ``packed``: K8's residuals against max q(s), else K9's TD
    against q(s, a)."""
    fields = tuple(f.to(torch.int64) for f in fields)
    B = fields[0].shape[0]
    n = lk.n_codes(cfg)
    codes = iql_codes(cfg, seed, eps_int, torch.arange(B), n_steps,
                      step_offset).long()
    vals, greedy = prepare_rows(table)
    greedy = greedy.long()
    gamma_f = torch.tensor(lk._f32(gamma))
    zero = torch.zeros((), dtype=torch.float32)
    limit = ik.value_limit(B, n_steps)
    sums = torch.zeros(n * COLS, dtype=torch.int64)
    cnt = torch.zeros(n * COLS, dtype=torch.int32)
    rew = torch.zeros(B, dtype=torch.int64)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    oor = torch.zeros((), dtype=torch.int64)
    pend = None

    def settle(v):
        """The pending visits' retirement against the maxes ``v``."""
        nonlocal oor
        if pend is not None:
            ia, ib, r, cont, base_a, base_b = pend
            oor += ik._retire(sums, cnt, ia, r, cont, v[:, 0], base_a, limit)
            oor += ik._retire(sums, cnt, ib, -r, cont, v[:, 1], base_b, limit)

    for code in codes:
        k = rules.cellpair_encode(torch, *fields[:5], cfg).long()
        v, g = vals[k], greedy[k]
        settle(v)
        xa, xb = code & 7, (code >> 3) & 7
        aa = torch.where(xa == GREEDY, g & 7, xa)
        ab = torch.where(xb == GREEDY, g >> 3, xb)
        cell = k * COLS
        if packed:
            base_a, base_b = v[:, 0], v[:, 1]
        else:
            base_a, base_b = table[k, aa], table[k, N_ACTIONS + ab]
        ea = lc.class_move((code >> 6) & 3, aa)
        eb = lc.class_move((code >> 8) & 3, ab)
        ra, ca, rb, cb, p, goal, r = sk.transition_core(
            *fields[:5], ea, eb, torch.zeros_like(code), (code >> 10) & 3,
            cfg, 0)
        t = fields[5] + 1
        late = t >= cfg.max_steps
        term = goal | late
        reset = sk._isd_lookup(code >> 12, cfg)
        fields = (*(torch.where(term, i, f) for i, f in
                    zip(reset, (ra, ca, rb, cb, p))), torch.where(term, 0, t))
        pend = (cell + aa, cell + N_ACTIONS + ab, r.float(),
                torch.where(term, zero, gamma_f), base_a, base_b)
        rew += r
        goals += goal
        truncs += late & ~goal
    settle(vals[rules.cellpair_encode(torch, *fields[:5], cfg).long()])
    return (tuple(f.to(torch.int32) for f in fields),
            (sums.reshape(-1, COLS), cnt.reshape(-1, COLS)),
            (rew.sum(), goals.sum(), truncs.sum(), oor))

