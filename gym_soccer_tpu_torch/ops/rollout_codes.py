"""The two stages of the K1-K4 rollout kernels, on the host.

``csrc/step_kernel.cu`` splits a lane-step of ``fused_rollout`` (K1) and
``fused_journal_rollout`` (K2) in two.  Producer warps turn the three
counter words of each (lane, step) into one 16-bit **step code**, all that
follows from (seed, step, lane) alone; consumer threads, one a lane, walk
the state chain from the codes.  This module holds what the host builds
for that walk and a plain PyTorch twin of both stages, written the way the
kernel computes them, so that the CPU tests can hold the design to the
plain versions and to the JAX package bit for bit:

* ``step_codes``: the producers' stage.
* ``walk_codes``: the consumers' stage, by the table (``build_step_table``)
  or by arithmetic from the effective moves.
* ``isd_pick``: ``u16 % nI`` without a division, for nI 1 to 4.

A step code packs
    bits 0-6   the table input (ea * 5 + eb) * 4 + coin: each player's
               effective move after the slip (an action index, 0 to stay)
               and the two coin bits (possession, who advances)
    bits 7-8   the ISD index of a reset this step
    bits 9-13  the joint action aa * 5 + ab, for the journal
A move slips to (0, 0) exactly when its action is 0, so the transition is
a function of (state, ea, eb, coin): 100 inputs a state.  The step table
holds, for every compact state code (``rules.cellpair_encode``) and input,
the pre-reset next code with its goal and reward bits (int16: 2 x code |
(r == 1) << 13 | goal << 15, the code doubled into a byte offset of int16
rows), input-major; 220,800 B on 5x4, inside one block's shared memory.  The walk stays among the *walkable* states (``walkable``:
both players on the interior columns, on distinct cells, p 0 or 1: the
reachable states that are not goals), since a goal resets; entries of the
other codes are 0 and never read.  A lane that starts elsewhere (an
``init_fields`` the game cannot reach) walks by arithmetic, with its warp.

K4 (``alt_rollout``, the alternating-turn game) splits its ticks the same
way (``alt_step_codes``, ``alt_walk_codes``).  A tick code packs the
mover's effective move (bits 0-2) and the ISD index (bits 3-4): only one
player moves, and which one does not change its effective move, so a tick
is a function of (state, turn, move).  The tick table (``build_alt_table``)
holds, for every compact code, turn and move, the pre-reset next (code,
turn) with its goal and reward bits (int16: 2 x (2 x code + turn) | (r ==
1) << 13 | goal << 15), move-major; 22,080 B on 5x4.  The next turn is the
other player's; a goal or a truncation resets to an ISD entry with A to
move.

K3 (``multigrid_rollout``, a mixture of boards) splits its steps as K1
does, each lane on its own board (``mg_step_codes``, ``mg_walk_codes``).
Its step code is K1's without the joint action (K3 keeps no journal),
made with the slip thresholds and the ISD mask of the lane's board, which
a producer reads from a 16-B entry a lane in shared memory.  Every lane
walks by arithmetic on its board and resets to its board's ISD entry,
computed from the index; there is no step table.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import EnvConfig
from ..core import rules
from . import step_kernel as sk

INPUTS = 100            # (effective move a, effective move b, coin bits)
GOAL_BIT = 1 << 15      # the table entry's sign bit
REWARD_BIT = 1 << 13    # set iff the goal's reward is +1
CODE_MASK = REWARD_BIT - 1   # 2 x the next compact code
# The kernel's ring (csrc/step_kernel.cu kTileSteps, kStages): tiles of 8
# steps of step codes, 3 tiles in shared memory.
TILE_STEPS = 8
STAGES = 3
PRODUCER_WARPS = 8      # kProducerWarps, beside a block's lanes
SMEM_BUDGET = 232448    # shared memory one H100 block may use
DEFAULT_LANES = 64      # 128 blocks at 8192 lanes: one wave on 132 SMs
MAX_LANES = 512         # kMaxLanes: 768 threads a block with the producers
# The orthogonals of an action's move, as actions, one nibble per action:
# (-mr, mc) first, (mr, -mc) second (step_kernel._slipped_move).
FIRST_ORTHOGONAL = 0x12430
SECOND_ORTHOGONAL = 0x21340


def effective_move(a, u, q_int: int):
    """The action whose move ``_slipped_move(a, u, q_int)`` makes: ``a``
    kept with p = 1 - q, else its first or second orthogonal."""
    keep = u < 65536 - q_int
    first = u < 65536 - q_int // 2
    orth = (torch.where(first, FIRST_ORTHOGONAL, SECOND_ORTHOGONAL)
            >> (4 * a)) & 7
    return torch.where(keep, a, orth)


def isd_pick(u, nI: int):
    """``u % nI`` for ``u`` in [0, 65536) and nI in 1..4, as the kernel
    computes it: a mask for 1, 2 and 4, a multiply-high for 3."""
    if nI == 4:
        return u & 3
    if nI == 2:
        return u & 1
    if nI == 3:
        return u - 3 * ((u * 43691) >> 17)
    if nI == 1:
        return u & 0
    raise ValueError(f"nI must lie in [1, 4], got {nI}")


def step_codes(cfg: EnvConfig, seed: int, lanes: torch.Tensor, n_steps: int,
               step_offset: int = 0) -> torch.Tensor:
    """The producers' stage: int32 [n_steps, len(lanes)] step codes of the
    global lane ids ``lanes`` (int64) at absolute steps step_offset + i."""
    q_int = sk._q_int(cfg)
    nI = sk._n_isd(cfg)
    codes = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int32,
                        device=lanes.device)
    for i in range(n_steps):
        bits0, bits1, bits2 = (sk._random_word(seed, i + step_offset, w, lanes)
                               for w in range(3))
        aa, ab = sk._u16(bits0, 0) % 5, sk._u16(bits0, 1) % 5
        ea = effective_move(aa, sk._u16(bits1, 0), q_int)
        eb = effective_move(ab, sk._u16(bits1, 1), q_int)
        coin = sk._u16(bits2, 0) & 3
        idx = isd_pick(sk._u16(bits2, 1), nI)
        codes[i] = ((ea * 5 + eb) * 4 + coin) | (idx << 7) | ((aa * 5 + ab) << 9)
    return codes


# ----------------------------------------------------------------------
# The step table
# ----------------------------------------------------------------------

class StepTable(NamedTuple):
    n_codes: int
    table: np.ndarray       # int16 [INPUTS * n_codes], input-major
    code_raw: np.ndarray    # int32 [n_codes]: raw code of each compact code
    code_fields: np.ndarray  # int32 [n_codes, 5]: (ra, ca, rb, cb, p)
    isd_code: np.ndarray    # int32 [nI]: compact codes of the ISD entries


def _valid_cells(cfg: EnvConfig):
    """(rows, cols) of the valid cells in ``rules.cell_encode`` order."""
    r, c = np.meshgrid(np.arange(cfg.H), np.arange(cfg.W), indexing="ij")
    r, c = r.ravel(), c.ravel()
    lo, hi = cfg.goal_row_bounds
    ok = ((c > 0) & (c < cfg.W - 1)) | ((r >= lo) & (r <= hi))
    r, c = r[ok], c[ok]
    order = np.argsort(rules.cell_encode(np, r, c, cfg), kind="stable")
    return r[order], c[order]


def code_fields(cfg: EnvConfig) -> np.ndarray:
    """int32 [n_codes, 5]: the state fields of every compact code."""
    r, c = _valid_cells(cfg)
    nc = len(r)
    code = np.arange(rules.n_cellpairs(cfg))
    p = code % 2
    a, b_rank = np.divmod(code // 2, nc - 1)
    b = np.where(b_rank >= a, b_rank + 1, b_rank)
    return np.stack([r[a], c[a], r[b], c[b], p], -1).astype(np.int32)


def walkable(cfg: EnvConfig, ra, ca, rb, cb, p):
    """The states the table walk starts from and stays among (numpy or
    torch): both players on the interior columns, on distinct cells,
    possession 0 or 1."""
    def inside(r, c):
        return (r >= 0) & (r < cfg.H) & (c >= 1) & (c <= cfg.W - 2)

    return (inside(ra, ca) & inside(rb, cb) & ((ra != rb) | (ca != cb))
            & ((p == 0) | (p == 1)))


@functools.lru_cache(maxsize=None)
def build_step_table(cfg: EnvConfig) -> StepTable:
    """(cached) The next state of every (walkable compact code, input),
    from the port's ``transition_core``: the effective moves played as
    actions with no slip (``q_int`` 0), the coin bits as the low bits of
    word 2."""
    fields = code_fields(cfg)
    n = len(fields)
    if 2 * n > CODE_MASK + 1:
        raise ValueError(f"{n} compact codes do not fit the entry's 13 bits "
                         "(twice the code)")
    live = walkable(cfg, *fields.T)
    src = fields[live]
    inp = np.arange(INPUTS)
    ea, eb, coin = inp // 20, (inp // 4) % 5, inp % 4
    shape = (INPUTS, len(src))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        a, shape)), dtype=torch.int64)
    out = sk.transition_core(
        *(t(src[:, k]) for k in range(5)), t(ea[:, None]), t(eb[:, None]),
        t(0), t(coin[:, None]), cfg, 0)
    nra, nca, nrb, ncb, npz, goal, r = (x.numpy() for x in out)
    goal_state = rules.is_goal_state(np, nra, nca, nrb, ncb, npz, cfg)
    if not (walkable(cfg, nra, nca, nrb, ncb, npz) | goal_state).all():
        raise AssertionError("a transition left the walkable states")
    nxt = rules.cellpair_encode(np, nra, nca, nrb, ncb, npz, cfg)
    entry = np.zeros((INPUTS, n), np.int64)
    entry[:, live] = (2 * nxt | np.where(r == 1, REWARD_BIT, 0)
                      | np.where(goal, GOAL_BIT, 0))
    isd = sk.tables.isd_fields(cfg)
    isd_code = rules.cellpair_encode(np, *isd.T, cfg).astype(np.int32)
    return StepTable(
        n_codes=n, table=entry.astype(np.uint16).view(np.int16).ravel(),
        code_raw=rules.raw_encode(np, *fields.T, cfg).astype(np.int32),
        code_fields=fields, isd_code=isd_code)


def ring_bytes(lanes: int) -> int:
    """Shared memory of the step-code ring: STAGES tiles of TILE_STEPS
    int16 codes a lane."""
    return STAGES * TILE_STEPS * 2 * lanes


def table_bytes(n_codes: int) -> int:
    return INPUTS * 2 * n_codes


def raw_bytes(n_codes: int) -> int:
    """The uint16 raw codes of the compact codes, padded to 16 B."""
    return -(-2 * n_codes // 16) * 16


def smem_bytes(lanes: int, n_codes: int) -> int:
    """Dynamic shared memory of one block of ``lanes`` lanes: an mbarrier
    (16 B), the ISD entries' codes and fields (96 B), the step table and
    the raw codes (neither when ``n_codes`` is 0) and the ring
    (csrc/step_kernel.cu ``smem_bytes``)."""
    return (16 + 96 + ring_bytes(lanes)
            + (table_bytes(n_codes) + raw_bytes(n_codes) if n_codes else 0))


@functools.lru_cache(maxsize=None)
def uses_table(cfg: EnvConfig) -> bool:
    """The geometry's choice: the table path when the step table fits one
    block's shared memory beside the ring of the default block size (5x4:
    1104 codes, 220,800 B); the arithmetic path otherwise (11x7: 13612
    codes, 2.7 MB)."""
    return smem_bytes(DEFAULT_LANES, rules.n_cellpairs(cfg)) <= SMEM_BUDGET


def lanes_per_block(threads, default: int = DEFAULT_LANES) -> int:
    """The lanes per block of a split kernel's launch: ``threads``, or
    ``default`` when None, if a multiple of 32 in [32, MAX_LANES], else
    ValueError.  K3 takes any such size (``mg_smem_bytes`` fits); K1/K2
    and K4 check their tables' shared memory besides."""
    lanes = default if threads is None else threads
    if (not isinstance(lanes, int) or lanes <= 0 or lanes % 32
            or lanes > MAX_LANES):
        raise ValueError(f"threads (lanes per block) must be a multiple of 32 "
                         f"in [32, {MAX_LANES}], got {threads}")
    return lanes


def check_lanes(cfg: EnvConfig, threads) -> int:
    """The lanes per block of a K1/K2 launch: ``threads``, or DEFAULT_LANES
    when None: a multiple of 32 in [32, MAX_LANES] whose shared memory
    fits, else ValueError."""
    lanes = lanes_per_block(threads)
    need = smem_bytes(lanes, rules.n_cellpairs(cfg) if uses_table(cfg) else 0)
    if need > SMEM_BUDGET:
        raise ValueError(f"threads={lanes} needs {need} B of shared memory "
                         f"with the step table; the budget is {SMEM_BUDGET} B "
                         "a block")
    return lanes


class DeviceStepTable(NamedTuple):
    table: torch.Tensor      # int16 [INPUTS * n_codes]
    code_raw: torch.Tensor   # uint16 bits in int16 [raw_bytes(n_codes) / 2]
    n_codes: int


@functools.lru_cache(maxsize=8)
def device_step_table(cfg: EnvConfig, device: torch.device) -> DeviceStepTable:
    """(cached) ``build_step_table`` on ``device``, its raw codes as uint16
    padded to 16 B, as the kernel copies them to shared memory."""
    st = build_step_table(cfg)
    if st.code_raw.max() >= 65536:
        raise ValueError("raw codes past 16 bits")
    raw = np.zeros(raw_bytes(st.n_codes) // 2, np.uint16)
    raw[:st.n_codes] = st.code_raw
    return DeviceStepTable(torch.as_tensor(st.table, device=device),
                           torch.as_tensor(raw.view(np.int16), device=device),
                           st.n_codes)


# ----------------------------------------------------------------------
# The consumers' stage
# ----------------------------------------------------------------------

def _arith_step(cfg: EnvConfig, fields, code):
    """One lane-step from a step code by arithmetic: the transition under
    the effective moves, no slip, then the reset to ISD entry bits 7-8.
    Returns the fields, the pre-reset raw code, goal, truncation and
    reward."""
    ra, ca, rb, cb, p, t = fields
    inp = code & 127
    ea, eb, coin = inp // 20, (inp >> 2) % 5, inp & 3
    ra, ca, rb, cb, p, goal, r = sk.transition_core(
        ra, ca, rb, cb, p, ea, eb, torch.zeros_like(code), coin, cfg, 0)
    raw = rules.raw_encode(torch, ra, ca, rb, cb, p, cfg)
    t = t + 1
    trunc = (t >= cfg.max_steps) & ~goal
    term = goal | trunc
    reset = sk._isd_lookup((code >> 7) & 3, cfg)
    out = tuple(torch.where(term, i, f)
                for i, f in zip(reset, (ra, ca, rb, cb, p)))
    return (*out, torch.where(term, 0, t)), raw, goal, trunc, r.long()


def _table_step(st: StepTable, tbl, cs, t, code, max_steps: int):
    """One lane-step from a step code by the table: the entry of (input,
    code), the reset to the ISD entry's code.  Returns the code, t, the
    pre-reset raw code, goal, truncation and reward."""
    e = tbl[(code & 127) * st.n_codes + cs]
    goal = e < 0
    nxt = (e & CODE_MASK) >> 1
    t = t + 1
    trunc = (t >= max_steps) & ~goal
    term = goal | trunc
    r = torch.where(goal, torch.where((e & REWARD_BIT) != 0, 1, -1), 0)
    isd_code = torch.as_tensor(st.isd_code.astype(np.int64))
    cs = torch.where(term, isd_code[(code >> 7) & 3], nxt)
    raw = torch.as_tensor(st.code_raw.astype(np.int64))[nxt]
    return cs, torch.where(term, 0, t), raw, goal, trunc, r


def walk_codes(cfg: EnvConfig, fields, codes: torch.Tensor, journal: bool,
               table: bool | None = None):
    """The consumers' stage: the state fields after the steps whose codes
    are ``codes`` [T, B], the per-lane int64 (reward, goal, truncation)
    sums and, with ``journal``, the journal words [T, B] (None without).

    ``table`` (default: ``uses_table(cfg)``) walks the step table for each
    warp (32 lanes) whose states are all ``walkable`` and by arithmetic the
    others, as the kernel does; ``table=False`` walks every lane by
    arithmetic."""
    if table is None:
        table = uses_table(cfg)
    fields = tuple(f.to(torch.int64) for f in fields)
    B = fields[0].shape[0]
    by_table = torch.zeros(B, dtype=torch.bool)
    if table:
        st = build_step_table(cfg)
        tbl = torch.as_tensor(st.table.astype(np.int64))
        valid = walkable(cfg, *fields[:5])
        pad = torch.ones(-B % 32, dtype=torch.bool)
        by_table = torch.cat([valid, pad]).reshape(-1, 32).all(1) \
            .repeat_interleave(32)[:B]
        # the lanes that walk by arithmetic hold the first ISD entry here
        safe = [torch.where(by_table, f, int(v)) for f, v in
                zip(fields[:5], st.code_fields[st.isd_code[0]])]
        cs, tt = rules.cellpair_encode(torch, *safe, cfg), fields[5]
    rew = torch.zeros(B, dtype=torch.int64)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    words = (torch.empty((codes.shape[0], B), dtype=torch.int32)
             if journal else None)
    for i, code in enumerate(codes.to(torch.int64)):
        fields, raw, goal, trunc, r = _arith_step(cfg, fields, code)
        if table:
            cs, tt, traw, tgoal, ttrunc, tr = _table_step(
                st, tbl, cs, tt, code, cfg.max_steps)
            raw, goal, trunc, r = (torch.where(by_table, a, b) for a, b in
                                   ((traw, raw), (tgoal, goal),
                                    (ttrunc, trunc), (tr, r)))
        if journal:
            words[i] = (raw | ((code >> 9) << 16) | (goal.long() << 21)
                        | (trunc.long() << 22) | ((r == 1).long() << 23)
                        | (((code >> 7) & 3) << 24)).to(torch.int32)
        rew += r
        goals += goal
        truncs += trunc
    if table:
        dec = torch.as_tensor(st.code_fields.astype(np.int64))[cs].unbind(1)
        fields = tuple(torch.where(by_table, a, b) for a, b in
                       zip((*dec, tt), fields))
    return (tuple(f.to(torch.int32) for f in fields), (rew, goals, truncs),
            words)


# ----------------------------------------------------------------------
# K4: the alternating game's two stages
# ----------------------------------------------------------------------

ALT_INPUTS = 5          # the mover's effective move


def alt_step_codes(cfg: EnvConfig, seed: int, lanes: torch.Tensor,
                   n_steps: int, step_offset: int = 0) -> torch.Tensor:
    """K4's producers' stage: int32 [n_steps, len(lanes)] tick codes,
    the mover's effective move | the ISD index << 3."""
    q_int = sk._q_int(cfg)
    nI = sk._n_isd(cfg)
    codes = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int32,
                        device=lanes.device)
    for i in range(n_steps):
        bits0, bits1, bits2 = (sk._random_word(seed, i + step_offset, w, lanes)
                               for w in range(3))
        e = effective_move(sk._u16(bits0, 0) % 5, sk._u16(bits1, 0), q_int)
        codes[i] = e | (isd_pick(sk._u16(bits2, 1), nI) << 3)
    return codes


class AltTable(NamedTuple):
    n_codes: int
    table: np.ndarray       # int16 [ALT_INPUTS * 2 * n_codes], move-major
    isd_code: np.ndarray    # int32 [nI]: compact codes of the ISD entries


@functools.lru_cache(maxsize=None)
def build_alt_table(cfg: EnvConfig) -> AltTable:
    """(cached) The next (code, turn) of every walkable compact code, turn
    and effective move, from the port's ``alt_transition_core`` with no
    slip (``q_int`` 0)."""
    fields = code_fields(cfg)
    n = len(fields)
    if 4 * n > CODE_MASK + 1:
        raise ValueError(f"{n} compact codes do not fit the entry's 13 bits "
                         "(four times the code)")
    live = np.flatnonzero(walkable(cfg, *fields.T))
    src = fields[live]
    shape = (ALT_INPUTS, 2, len(src))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        a, shape)), dtype=torch.int64)
    turn = np.arange(2)[None, :, None]
    move = np.arange(ALT_INPUTS)[:, None, None]
    out = sk.alt_transition_core(*(t(src[:, k]) for k in range(5)), t(turn),
                                 t(move), t(0), cfg, 0)
    nra, nca, nrb, ncb, npz, goal, r = (x.numpy() for x in out)
    goal_state = rules.is_goal_state(np, nra, nca, nrb, ncb, npz, cfg)
    if not (walkable(cfg, nra, nca, nrb, ncb, npz) | goal_state).all():
        raise AssertionError("a tick left the walkable states")
    nxt = rules.cellpair_encode(np, nra, nca, nrb, ncb, npz, cfg)
    entry = np.zeros((ALT_INPUTS, n, 2), np.int64)
    entry[:, live, :] = np.moveaxis(
        2 * (2 * nxt + 1 - turn) | np.where(r == 1, REWARD_BIT, 0)
        | np.where(goal, GOAL_BIT, 0), 1, 2)
    isd = sk.tables.isd_fields(cfg)
    isd_code = rules.cellpair_encode(np, *isd.T, cfg).astype(np.int32)
    return AltTable(n, entry.astype(np.uint16).view(np.int16).ravel(),
                    isd_code)


def alt_table_bytes(n_codes: int) -> int:
    return ALT_INPUTS * 4 * n_codes


def alt_smem_bytes(lanes: int, n_codes: int) -> int:
    """K4's dynamic shared memory a block: K1/K2's head, the tick table and
    the raw codes (neither when ``n_codes`` is 0) and the ring
    (csrc/step_kernel.cu ``alt_smem_bytes``)."""
    return (16 + 96 + ring_bytes(lanes)
            + (alt_table_bytes(n_codes) + raw_bytes(n_codes) if n_codes
               else 0))


@functools.lru_cache(maxsize=None)
def uses_alt_table(cfg: EnvConfig) -> bool:
    """K4's geometry choice: the tick table when its entries hold four
    times the codes and it fits one block's shared memory beside the ring
    of the default block size (5x4: 1104 codes, 22,080 B); the arithmetic
    walk otherwise (11x7: 13612 codes)."""
    n = rules.n_cellpairs(cfg)
    return (4 * n <= CODE_MASK + 1
            and alt_smem_bytes(DEFAULT_LANES, n) <= SMEM_BUDGET)


def check_alt_lanes(cfg: EnvConfig, threads) -> int:
    """The lanes per block of a K4 launch: ``threads``, or DEFAULT_LANES
    when None: a multiple of 32 in [32, MAX_LANES] whose shared memory
    fits, else ValueError."""
    lanes = lanes_per_block(threads)
    need = alt_smem_bytes(lanes, rules.n_cellpairs(cfg)
                          if uses_alt_table(cfg) else 0)
    if need > SMEM_BUDGET:
        raise ValueError(f"threads={lanes} needs {need} B of shared memory "
                         f"with the tick table; the budget is {SMEM_BUDGET} "
                         "B a block")
    return lanes


@functools.lru_cache(maxsize=8)
def device_alt_table(cfg: EnvConfig, device: torch.device) -> DeviceStepTable:
    """(cached) ``build_alt_table`` on ``device``, with the raw codes as
    ``device_step_table`` holds them."""
    at = build_alt_table(cfg)
    raw = np.zeros(raw_bytes(at.n_codes) // 2, np.uint16)
    raw[:at.n_codes] = rules.raw_encode(np, *code_fields(cfg).T, cfg)
    return DeviceStepTable(torch.as_tensor(at.table, device=device),
                           torch.as_tensor(raw.view(np.int16), device=device),
                           at.n_codes)


def _alt_arith_step(cfg: EnvConfig, fields, code):
    """One tick from a tick code by arithmetic: ``alt_transition_core``
    under the effective move, no slip, then the reset to ISD entry bits
    3-4 with A to move.  Returns the fields, goal, truncation and
    reward."""
    ra, ca, rb, cb, p, turn, t = fields
    ra, ca, rb, cb, p, goal, r = sk.alt_transition_core(
        ra, ca, rb, cb, p, turn, code & 7, torch.zeros_like(code), cfg, 0)
    t = t + 1
    trunc = (t >= cfg.max_steps) & ~goal
    term = goal | trunc
    reset = sk._isd_lookup((code >> 3) & 3, cfg)
    out = tuple(torch.where(term, i, f)
                for i, f in zip(reset, (ra, ca, rb, cb, p)))
    return ((*out, torch.where(term, 0, 1 - turn), torch.where(term, 0, t)),
            goal, trunc, r.long())


def alt_walk_codes(cfg: EnvConfig, fields, codes: torch.Tensor,
                   table: bool | None = None):
    """K4's consumers' stage: the seven fields after the ticks whose codes
    are ``codes`` [T, B] and the per-lane int64 (reward, goal, truncation)
    sums.  ``table`` (default: ``uses_alt_table(cfg)``) walks the tick
    table for each warp whose lanes are all ``walkable`` with turn 0 or 1,
    the others by arithmetic, as the kernel does."""
    if table is None:
        table = uses_alt_table(cfg)
    fields = tuple(f.to(torch.int64) for f in fields)
    B = fields[0].shape[0]
    by_table = torch.zeros(B, dtype=torch.bool)
    if table:
        at = build_alt_table(cfg)
        tbl = torch.as_tensor(at.table.astype(np.int64))
        isd2 = torch.as_tensor(4 * at.isd_code.astype(np.int64))
        valid = (walkable(cfg, *fields[:5])
                 & ((fields[5] == 0) | (fields[5] == 1)))
        pad = torch.ones(-B % 32, dtype=torch.bool)
        by_table = torch.cat([valid, pad]).reshape(-1, 32).all(1) \
            .repeat_interleave(32)[:B]
        safe = [torch.where(by_table, f, int(v)) for f, v in
                zip(fields[:6], (*code_fields(cfg)[at.isd_code[0]], 0))]
        cs2 = 2 * (2 * rules.cellpair_encode(torch, *safe[:5], cfg) + safe[5])
        tt = fields[6]
    rew = torch.zeros(B, dtype=torch.int64)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    for code in codes.to(torch.int64):
        fields, goal, trunc, r = _alt_arith_step(cfg, fields, code)
        if table:
            e = tbl[(code & 7) * (2 * at.n_codes) + (cs2 >> 1)]
            tgoal = e < 0
            late = tt + 1 >= cfg.max_steps
            term = tgoal | late
            cs2 = torch.where(term, isd2[(code >> 3) & 3], e & CODE_MASK)
            tt = torch.where(term, 0, tt + 1)
            tr = torch.where(tgoal, torch.where((e & REWARD_BIT) != 0, 1, -1),
                             0)
            goal, trunc, r = (torch.where(by_table, a, b) for a, b in
                              ((tgoal, goal), (late & ~tgoal, trunc),
                               (tr, r)))
        rew += r
        goals += goal
        truncs += trunc
    if table:
        dec = torch.as_tensor(code_fields(cfg).astype(np.int64))[cs2 >> 2]
        fields = tuple(torch.where(by_table, a, b) for a, b in
                       zip((*dec.unbind(1), (cs2 >> 1) & 1, tt), fields))
    return tuple(f.to(torch.int32) for f in fields), (rew, goals, truncs)


# ----------------------------------------------------------------------
# K3: the mixture's two stages
# ----------------------------------------------------------------------

def mg_smem_bytes(lanes: int) -> int:
    """K3's dynamic shared memory a block: the per-variant int64 sums (16
    variants x 3), a 16-B slip entry a lane and the ring
    (csrc/step_kernel.cu ``mg_smem_bytes``); 33,152 B at 512 lanes."""
    return 8 * 3 * sk.MAX_VARIANTS + 16 * lanes + ring_bytes(lanes)


def mg_step_codes(geo: sk.GeoPlanes, seed: int, lanes: torch.Tensor,
                  n_steps: int, step_offset: int = 0) -> torch.Tensor:
    """K3's producers' stage: int32 [n_steps, len(lanes)] step codes, the
    table input | the ISD index << 7, of the global lane ids ``lanes``
    (int64) at absolute steps step_offset + i, each on its own board:
    ``geo``'s planes, indexed like ``lanes``, give its q_int and its ISD
    mask (3 on an even board, 1 on an odd one)."""
    mask = torch.where(geo.H % 2 == 0, 3, 1)
    codes = torch.empty((n_steps, lanes.shape[0]), dtype=torch.int32,
                        device=lanes.device)
    for i in range(n_steps):
        bits0, bits1, bits2 = (sk._random_word(seed, i + step_offset, w, lanes)
                               for w in range(3))
        ea = effective_move(sk._u16(bits0, 0) % 5, sk._u16(bits1, 0),
                            geo.q_int)
        eb = effective_move(sk._u16(bits0, 1) % 5, sk._u16(bits1, 1),
                            geo.q_int)
        coin = sk._u16(bits2, 0) & 3
        codes[i] = ((ea * 5 + eb) * 4 + coin) | ((sk._u16(bits2, 1) & mask)
                                                 << 7)
    return codes


def mg_walk_codes(cfgs: tuple, fields, planes, codes: torch.Tensor):
    """K3's consumers' stage: the six fields after the steps whose codes
    are ``codes`` [T, B], each lane on its own board (``planes``: H, W,
    glo, ghi, q_int, variant id), walked by arithmetic and reset to its
    board's ISD entry computed from the index as the kernel computes it
    (csrc/pipeline.cuh ``LaneBoard``), and the per-variant int64 [nV, 3]
    (reward sum, goals, truncations)."""
    *geo, vid = planes
    g = sk.GeoPlanes(*geo, cfgs[0].max_steps)
    mid_lo, mid_hi = (g.H - 1) // 2, g.H // 2
    fields = tuple(f.to(torch.int64) for f in fields)
    B = fields[0].shape[0]
    sums = torch.zeros((3, B), dtype=torch.int64)
    for code in codes.to(torch.int64):
        ra, ca, rb, cb, p, t = fields
        inp = code & 127
        ra, ca, rb, cb, p, goal, r = sk.transition_core(
            ra, ca, rb, cb, p, inp // 20, (inp >> 2) % 5,
            torch.zeros_like(code), inp & 3, g, 0)
        late = t + 1 >= g.max_steps
        term = goal | late
        idx = (code >> 7) & 3
        swap = (idx >> 1) == 1
        reset = (torch.where(swap, mid_hi, mid_lo), torch.full_like(ra, 2),
                 torch.where(swap, mid_lo, mid_hi), g.W - 3, idx & 1)
        fields = (*(torch.where(term, i, f) for i, f in
                    zip(reset, (ra, ca, rb, cb, p))),
                  torch.where(term, 0, t + 1))
        sums += torch.stack([r.long(), goal.long(), (late & ~goal).long()])
    stats = torch.zeros((len(cfgs), 3), dtype=torch.int64)
    stats.index_add_(0, vid.long(), sums.t())
    return tuple(f.to(torch.int32) for f in fields), stats
