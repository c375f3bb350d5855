"""The two stages of the K10 and K11 turn-based Q kernels, on the host.

``csrc/altq_kernel.cu`` splits a lane-step of ``altq_packed_chunk`` (K10)
and ``altq_chunk`` (K11) in two, as K8/K9 split an independent-Q step
(ops/iql_codes.py).  Producer warps hash each (lane, step) into a 7-bit
step code that follows from (chunk seed, step + step_offset, lane) and the
chunk's eps_int alone: the mover's choice (an explored action 0-4, or
``GREEDY``: take the state's greedy action), its slip class (0: keep the
move, 1: its first orthogonal, 2: its second) and the ISD index.  A prep
pass turns each row of the chunk's frozen table into what a step needs of
it: both movers' V (A's max over columns 0-4, B's min over 5-9, NaN-
propagating) and greedy actions (the strict ``>`` scan on sgn * q whose
running best propagates NaN, the plain version's; not K8's scan, which
skips a NaN).  Consumer threads, one a lane, read the prepared V and
greedy action at the state's (code, turn), retire the previous step
against that V, take the mover's action (the code's, or the greedy one),
map action and slip class to the effective move and step: by K4's tick
table where it fits (5x4: ``rollout_codes.build_alt_table``), the state
held as 2 x (2 x code + turn), else by the branch-free transition.  This
module holds what the host needs for that and a plain PyTorch twin of both
stages, written the way the kernel computes them, so that the CPU tests
can hold the design to the plain versions (``altq_packed_chunk_plain``,
``altq_chunk_plain``) bit for bit and to the JAX package:

* ``altq_codes``: the producers' stage.  Code bits: the choice 0-2, the
  slip class 3-4, the ISD index 5-6.
* ``prepare_rows``: the prep pass.  Row k is compact code k's (V_A, V_B)
  as a float32 pair and its greedy actions g_A | g_B << 3 in one byte;
  the pairs of all codes, then the bytes: 9 B a code (``row_bytes``: 9,936
  B on 5x4, 122,512 B on 11x7).  The pair read as floats puts the V of
  (code, turn) at 2 x code + turn.
* ``chunk_twin``: the consumers' stage over a whole chunk, by the tick
  table for each 32-lane warp whose lanes the table can start from, by
  arithmetic for the others.  K11's baseline q(s, a) is read from the
  table after the action is known.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import N_ACTIONS
from ..core import rules
from . import iql_codes as qc
from . import iql_kernel as ik
from . import learner_codes as lc
from . import learner_kernel as lk
from . import rollout_codes as rc
from . import step_kernel as sk

COLS = 2 * N_ACTIONS    # a table and accumulator row: A-to-move's five, B's
GREEDY = qc.GREEDY      # a choice: the state's greedy action
# The kernel's ring (csrc/altq_kernel.cu kTile, kRingStages, kProducers):
# K8/K9's, tiles of 8 steps of a 16-bit code, 2 tiles.
TILE_STEPS = qc.TILE_STEPS
STAGES = qc.STAGES
PRODUCER_WARPS = qc.PRODUCER_WARPS
SMEM_BUDGET = qc.SMEM_BUDGET
MAX_LANES = qc.MAX_LANES
HEAD_BYTES = qc.HEAD_BYTES   # the mbarrier, the ISD entries' fields
ACC_MAX_VISITS = qc.ACC_MAX_VISITS
# Lanes per block: K5's rule, one wave of 132 blocks (8192: 64, 65536: 512).
default_lanes = lc.default_lanes
check_lanes = lc.check_lanes
row_bytes = qc.row_bytes
ring_bytes = qc.ring_bytes
acc_bytes = qc.acc_bytes
tick_bytes = rc.alt_table_bytes
raw_bytes = rc.raw_bytes


def altq_codes(cfg, seed: int, eps_int: int, lanes: torch.Tensor,
               n_steps: int, step_offset: int = 0) -> torch.Tensor:
    """The producers' stage: int32 [n_steps, len(lanes)] step codes of the
    global lane ids ``lanes`` at steps step_offset .. step_offset +
    n_steps - 1 (the module's bit layout)."""
    q_int, nI = sk._q_int(cfg), sk._n_isd(cfg)
    codes = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int32)
    for i in range(n_steps):
        b0, b1, b2 = (sk._random_word(seed, i + step_offset, w, lanes)
                      for w in range(3))
        x = torch.where(sk._u16(b0, 0) < eps_int,
                        sk._u16(b0, 1) % N_ACTIONS, GREEDY)
        codes[i] = (x | lc.slip_class(sk._u16(b1, 0), q_int) << 3
                    | rc.isd_pick(sk._u16(b2, 1), nI).long() << 5)
    return codes


# ----------------------------------------------------------------------
# What the host needs
# ----------------------------------------------------------------------

def smem_bytes(lanes: int, n_rows: int, n_table: int = 0,
               n_acc: int = 0) -> int:
    """Dynamic shared memory of one block of ``lanes`` lanes: the head,
    the prepared rows of ``n_rows`` codes (0 where they stay in device
    memory), the tick table and raw codes of ``n_table`` codes (0: the
    arithmetic walk), the ring and the private accumulators of ``n_acc``
    codes (0 where the kernel adds to device memory; csrc/altq_kernel.cu
    ``smem_bytes``)."""
    return (HEAD_BYTES + row_bytes(n_rows) + ring_bytes(lanes)
            + (tick_bytes(n_table) + raw_bytes(n_table) if n_table else 0)
            + acc_bytes(n_acc))


def _fits(n_rows: int, n_table: int = 0, n_acc: int = 0) -> bool:
    return smem_bytes(MAX_LANES, n_rows, n_table, n_acc) <= SMEM_BUDGET


@functools.lru_cache(maxsize=None)
def shared_rows(cfg) -> bool:
    """The prepared rows in shared memory when they fit beside the ring of
    the widest block (5x4: 1104 codes; 11x7: 13612), else in L2."""
    return _fits(lk.n_codes(cfg))


@functools.lru_cache(maxsize=None)
def uses_table(cfg) -> bool:
    """The kernel's walk (csrc/altq_kernel.cu ``placement``): K4's tick
    table where its entries hold the codes (``rollout_codes.
    uses_alt_table``) and it fits beside the rows at the widest block
    (5x4), else the arithmetic walk (11x7)."""
    n = lk.n_codes(cfg)
    return rc.uses_alt_table(cfg) and shared_rows(cfg) and _fits(n, n)


def shared_acc(cfg, lanes: int, n_steps: int, table: bool | None = None
               ) -> bool:
    """The kernel's choice: each block's own accumulators in shared memory
    when the rows are there, the accumulators fit beside them and the tick
    table (``table``, default ``uses_table(cfg)``) at the widest block
    (5x4) and a block adds at most ACC_MAX_VISITS values to a cell (lanes
    x n_steps); else every visit adds to device memory."""
    n = lk.n_codes(cfg)
    if table is None:
        table = uses_table(cfg)
    return (shared_rows(cfg) and _fits(n, n if table else 0, n)
            and lanes * n_steps <= ACC_MAX_VISITS)


def block_smem_bytes(cfg, lanes: int, n_steps: int) -> int:
    """The dynamic shared memory of one block of a call's launch."""
    n = lk.n_codes(cfg)
    return smem_bytes(lanes, n if shared_rows(cfg) else 0,
                      n if uses_table(cfg) else 0,
                      n if shared_acc(cfg, lanes, n_steps) else 0)


class Layout(NamedTuple):
    """Byte offsets in the one allocation of a K10 or K11 call: the int64
    sums, the int64 stats and the int32 counts (zeroed together, up to
    ``zero``), the seven output planes and the prep pass's rows
    (csrc/altq_kernel.cu ``altq_layout``)."""
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
    fields = qc._align16(zero)
    rows = qc._align16(fields + 28 * batch)
    return Layout(0, stats, cnt, zero, fields, rows,
                  rows + row_bytes(n_codes))


# ----------------------------------------------------------------------
# The plain twin of both stages
# ----------------------------------------------------------------------

def _scan(q, sgn: float):
    """The mover's greedy action on sgn * q, [n, 5]: a strict ``>`` scan
    from action 0 whose running best propagates NaN, so a NaN at column k
    keeps every later column from being chosen (the plain version's)."""
    best = torch.zeros(q.shape[0], dtype=torch.int64)
    bestv = sgn * q[:, 0]
    for k in range(1, N_ACTIONS):
        sc = sgn * q[:, k]
        best = torch.where(sc > bestv, k, best)
        bestv = torch.maximum(bestv, sc)
    return best


def _v(q, turn_a: bool):
    """The mover's V of q, [n, 5]: max for A, min for B, NaN-propagating."""
    v = q[:, 0]
    for k in range(1, N_ACTIONS):
        v = torch.maximum(v, q[:, k]) if turn_a else torch.minimum(v, q[:, k])
    return v


def prepare_rows(table: torch.Tensor):
    """The prep pass's rows of ``table`` (float32 [n_codes, 10]): (float32
    [n_codes, 2] of (V_A, V_B), int32 [n_codes] of g_A | g_B << 3)."""
    qa, qb = table[:, :N_ACTIONS], table[:, N_ACTIONS:]
    vals = torch.stack([_v(qa, True), _v(qb, False)], 1)
    return vals, (_scan(qa, 1.0) | _scan(qb, -1.0) << 3).to(torch.int32)


def _look(flat, vals, greedy, k, turn):
    """The V and greedy action at (code k, turn): the prepared row's for
    turn 0 or 1, the table's own scan for any other turn (the kernel's
    arithmetic walk on the table)."""
    ct = 2 * k + turn
    ok = (turn == 0) | (turn == 1)
    v = vals.reshape(-1)[torch.where(ok, ct, 0)]
    g = (greedy[k] >> (3 * (turn & 1))) & 7
    if bool(ok.all()):
        return ct, v, g
    q = flat[(5 * ct)[:, None] + torch.arange(N_ACTIONS)]
    a = turn == 0
    v_any = torch.where(a, _v(q, True), _v(q, False))
    g_any = torch.where(a, _scan(q, 1.0), _scan(q, -1.0))
    return ct, torch.where(ok, v, v_any), torch.where(ok, g, g_any)


def chunk_twin(cfg, seed: int, eps_int: int, table: torch.Tensor, fields,
               n_steps: int, gamma: float, step_offset: int = 0,
               packed: bool = True, walk_table: bool | None = None):
    """The consumers' stage of a chunk on the CPU, from ``altq_codes``'
    codes and ``prepare_rows``' rows: returns what the plain version
    returns.  ``packed``: K10's residuals against V(s), else K11's TD
    against q(s, a).  ``walk_table`` (default ``uses_table(cfg)``) walks
    the tick table for each warp whose lanes are all walkable with turn 0
    or 1, the others by arithmetic, as the kernel does."""
    fields = tuple(f.to(torch.int64) for f in fields)
    B = fields[0].shape[0]
    n = lk.n_codes(cfg)
    if walk_table is None:
        walk_table = uses_table(cfg)
    codes = altq_codes(cfg, seed, eps_int, torch.arange(B), n_steps,
                       step_offset).long()
    vals, greedy = prepare_rows(table)
    greedy = greedy.long()
    flat = table.reshape(-1)
    gamma_f = torch.tensor(lk._f32(gamma))
    zero = torch.zeros((), dtype=torch.float32)
    limit = ik.value_limit(B, n_steps)
    sums = torch.zeros(n * COLS, dtype=torch.int64)
    cnt = torch.zeros(n * COLS, dtype=torch.int32)
    rew = torch.zeros(B, dtype=torch.int64)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    oor = torch.zeros((), dtype=torch.int64)

    by_table = torch.zeros(B, dtype=torch.bool)
    if walk_table:
        at = rc.build_alt_table(cfg)
        tick = torch.as_tensor(at.table.astype(np.int64))
        reset = torch.as_tensor(4 * at.isd_code.astype(np.int64))
        valid = (rc.walkable(cfg, *fields[:5])
                 & ((fields[5] == 0) | (fields[5] == 1)))
        pad = torch.ones(-B % 32, dtype=torch.bool)
        by_table = torch.cat([valid, pad]).reshape(-1, 32).all(1) \
            .repeat_interleave(32)[:B]
        safe = [torch.where(by_table, f, int(v)) for f, v in
                zip(fields[:6], (*rc.code_fields(cfg)[at.isd_code[0]], 0))]
        cs2 = 2 * (2 * rules.cellpair_encode(torch, *safe[:5], cfg)
                   + safe[5])
        tt = fields[6]

    def state_value():
        """The V and greedy action at each lane's state, and 2 x code +
        turn: the table walk's from cs2, the arithmetic walk's from the
        fields."""
        k = rules.cellpair_encode(torch, *fields[:5], cfg).long()
        ct, v, g = _look(flat, vals, greedy, k, fields[5])
        if walk_table:
            tct = cs2 >> 1
            tv = vals.reshape(-1)[tct]
            tg = (greedy[cs2 >> 2] >> (3 * (tct & 1))) & 7
            ct, v, g = (torch.where(by_table, a, b) for a, b in
                        ((tct, ct), (tv, v), (tg, g)))
        return ct, v, g

    pend = None
    for code in codes:
        ct, v, g = state_value()
        if pend is not None:   # the previous step, against this V
            oor += ik._retire(sums, cnt, *pend[:3], v, pend[3], limit)
        x = code & 7
        act = torch.where(x == GREEDY, g, x)
        cell = 5 * ct + act
        base = v if packed else flat[cell]
        e = lc.class_move((code >> 3) & 3, act)
        idx = (code >> 5) & 3
        # the arithmetic walk: alt_moves under e, then the ISD reset
        ra, ca, rb, cb, p, goal, r = sk.alt_transition_core(
            *fields[:6], e, torch.zeros_like(code), cfg, 0)
        t = fields[6] + 1
        late = t >= cfg.max_steps
        term = goal | late
        reset_f = sk._isd_lookup(idx, cfg)
        fields = (*(torch.where(term, i, f) for i, f in
                    zip(reset_f, (ra, ca, rb, cb, p))),
                  torch.where(term, 0, 1 - fields[5]),
                  torch.where(term, 0, t))
        if walk_table:   # the table walk: one entry, a select
            entry = tick[e * (2 * n) + (cs2 >> 1)]
            tgoal = entry < 0
            tlate = tt + 1 >= cfg.max_steps
            tterm = tgoal | tlate
            cs2 = torch.where(tterm, reset[idx], entry & rc.CODE_MASK)
            tt = torch.where(tterm, 0, tt + 1)
            tr = torch.where(tgoal, torch.where(
                (entry & rc.REWARD_BIT) != 0, 1, -1), 0)
            goal, late, r = (torch.where(by_table, a, b) for a, b in
                             ((tgoal, goal), (tlate, late), (tr, r)))
            term = goal | late
        pend = (cell, r.float(), torch.where(term, zero, gamma_f), base)
        rew += r
        goals += goal
        truncs += late & ~goal
    _, v, _ = state_value()
    oor += ik._retire(sums, cnt, *pend[:3], v, pend[3], limit)
    if walk_table:
        dec = torch.as_tensor(rc.code_fields(cfg).astype(np.int64))[cs2 >> 2]
        fields = tuple(torch.where(by_table, a, b) for a, b in
                       zip((*dec.unbind(1), (cs2 >> 1) & 1, tt), fields))
    return (tuple(f.to(torch.int32) for f in fields),
            (sums.reshape(-1, COLS), cnt.reshape(-1, COLS)),
            (rew.sum(), goals.sum(), truncs.sum(), oor))
