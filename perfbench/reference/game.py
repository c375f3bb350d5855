"""Plain PyTorch reference of the simultaneous-move Littman '94 soccer game
and of its journaled random-vs-random rollout.

Written from the published rules (mimoralea/gym-soccer-littman94,
soccer_simultaneous_env.py: the board with two goal columns added, the
slip to one of the two orthogonal moves, the collision chain in its
priority order, goals, the initial-state distribution, truncation at 100
steps) and from the rollout's documented random words and journal layout.
It imports nothing of the program under test and works on any device.

Boards: ``width`` playable columns plus two goal columns (W = width + 2),
``height`` rows (H).  A state is (row_a, col_a, row_b, col_b, possession)
with possession 0 for player A and 1 for B.

Random words: three uint32 a lane-step, a pure function of (seed, absolute
step, word index, global lane id): a murmur3 finaliser over the lane id
mixed with a constant of the other three.  Word 0 draws the two actions
(low and high 16 bits, mod 5), word 1 the two slips (low: A, high: B),
word 2 the collision coins (bit 0: possession, bit 1: who advances) and,
in its high 16 bits, the autoreset's initial-state entry.

Journal word, one int32 a lane-step: bits 0-15 the raw code of the state
before autoreset, 16-20 the joint action aa * 5 + ab, 21 goal, 22
truncation, 23 reward +1, 24-25 the initial-state entry drawn.

uint32 arithmetic is held in int64 and masked, since PyTorch has no
uint32 multiply on the CPU.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
# (dcol, drow) of NOOP, NORTH, SOUTH, EAST, WEST
MOVES = ((0, 0), (0, -1), (0, 1), (1, 0), (-1, 0))


class Board:
    """The geometry of one board, from its published parameters."""

    def __init__(self, width: int, height: int, slip_prob: float,
                 max_steps: int = 100):
        self.width, self.height = int(width), int(height)
        self.W, self.H = self.width + 2, self.height
        self.slip_prob = float(slip_prob)
        self.max_steps = int(max_steps)
        h = self.H
        rows = ((h - 1) // 2, h // 2) if h % 2 == 0 else \
            (h // 2 - 1, h // 2, h // 2 + 1)
        self.goal_rows = rows
        self.glo, self.ghi = rows[0], rows[-1]
        # the rollout's slip threshold: the 16-bit uniform keeps the move
        # below 65536 - q
        self.q_int = int(round(self.slip_prob * 65536))
        self.isd = self._isd()

    @classmethod
    def from_config(cls, board: dict) -> "Board":
        return cls(board["width"], board["height"], board["slip_prob"],
                   board.get("max_steps", 100))

    def _isd(self):
        """[(probability, (ra, ca, rb, cb, p))] in the published order."""
        ca, cb = 2, self.W - 3
        if len(self.goal_rows) % 2 == 0:
            r0, r1 = self.goal_rows
            return [(0.25, (ra, ca, rb, cb, p))
                    for ra, rb in ((r0, r1), (r1, r0)) for p in (0, 1)]
        mid = self.goal_rows[len(self.goal_rows) // 2]
        return [(0.5, (mid, ca, mid, cb, p)) for p in (0, 1)]

    @property
    def n_raw(self) -> int:
        return self.H * self.W * self.H * self.W * 2

    def raw_code(self, ra, ca, rb, cb, p):
        return (((ra * self.W + ca) * self.H + rb) * self.W + cb) * 2 + p

    def in_goal_rows(self, r):
        return (r >= self.glo) & (r <= self.ghi)


# ----------------------------------------------------------------------
# Counter random words
# ----------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2**32 with every partial product below 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def random_word(seed: int, step: int, widx: int, lanes):
    """uint32 word ``widx`` of absolute step ``step`` for the int64 global
    lane ids ``lanes``."""
    c = (_mul32(seed & M32, 0x9E3779B9) + _mul32(step & M32, 0x85EBCA77)
         + _mul32(widx, 0xC2B2AE3D)) & M32
    return _fmix32((_fmix32(lanes ^ c) + c) & M32)


# ----------------------------------------------------------------------
# One transition
# ----------------------------------------------------------------------

def _move(a):
    dc = (a == 3).long() - (a == 4).long()
    dr = (a == 2).long() - (a == 1).long()
    return dc, dr


def slipped_move(a, u16, q_int: int, bits: int = 16):
    """The move actually made: the intended one while the ``bits``-bit
    uniform ``u16`` lies below (1 - q) of its range, else the first
    orthogonal (-drow, dcol) on the next q/2, else (drow, -dcol).  NOOP
    has no orthogonal: it stays.  ``bits`` < 16 draws the slip from the
    top ``bits`` bits only (the control's coarser draw)."""
    dc, dr = _move(a)
    if bits < 16:
        u16 = (u16 >> (16 - bits)) << (16 - bits)
    keep = u16 < 65536 - q_int
    first = u16 < 65536 - q_int // 2
    odc = torch.where(first, -dr, dr)
    odr = torch.where(first, dc, -dc)
    return torch.where(keep, dc, odc), torch.where(keep, dr, odr)


def next_cell(b: Board, r, c, dc, dr, has_ball):
    """A player's cell after its move: rows clamp to the board; a step
    into a goal column bounces back unless the mover carries the ball on
    a goal row."""
    nr = (r + dr).clamp(0, b.H - 1)
    nc = c + dc
    edge = (nc == 0) | (nc == b.W - 1)
    scores = edge & b.in_goal_rows(nr) & has_ball
    return nr, torch.where(edge & ~scores, c, nc)


def transition(b: Board, s, aa, ab, w1, w2, slip_bits: int = 16):
    """One transition of the fields ``s`` = (ra, ca, rb, cb, p) under the
    chosen actions; returns the next fields before autoreset, the goal
    flag and player A's reward."""
    ra, ca, rb, cb, p = s
    dca, dra = slipped_move(aa, w1 & 0xFFFF, b.q_int, slip_bits)
    dcb, drb = slipped_move(ab, (w1 >> 16) & 0xFFFF, b.q_int, slip_bits)
    nra, nca = next_cell(b, ra, ca, dca, dra, p == 0)
    nrb, ncb = next_cell(b, rb, cb, dcb, drb, p == 1)
    # 1: the players swap cells through each other
    c1 = ((ra == rb) & ((ca - cb).abs() == 1) & (nca == cb) & (ncb == ca)) | \
         ((ca == cb) & ((ra - rb).abs() == 1) & (nra == rb) & (nrb == ra))
    # 2: a player moves into an opponent who stands still (NOOP)
    c2 = ~c1 & (((nra == rb) & (nca == cb) & (ab == 0)) |
                ((nrb == ra) & (ncb == ca) & (aa == 0)))
    # 3: a player that bounced in place is invaded
    c3 = ~c1 & ~c2 & (
        ((ra == nra) & (ca == nca) & (aa != 0) & (nrb == ra) & (ncb == ca)) |
        ((rb == nrb) & (cb == ncb) & (ab != 0) & (nra == rb) & (nca == cb)))
    # 4: both race to one cell; 5: both move freely
    c4 = ~c1 & ~c2 & ~c3 & (nra == nrb) & (nca == ncb)
    c5 = ~c1 & ~c2 & ~c3 & ~c4
    coin = w2 & 0xFFFF
    coin_poss = coin & 1
    a_first = ((coin >> 1) & 1) == 1
    a_go = c5 | (c4 & a_first)
    b_go = c5 | (c4 & ~a_first)
    ra2 = torch.where(a_go, nra, ra)
    ca2 = torch.where(a_go, nca, ca)
    rb2 = torch.where(b_go, nrb, rb)
    cb2 = torch.where(b_go, ncb, cb)
    p2 = torch.where(c2, 1 - p, torch.where(c1 | c3 | c4, coin_poss, p))
    a_ball = p2 == 0
    ball_row = torch.where(a_ball, ra2, rb2)
    ball_col = torch.where(a_ball, ca2, cb2)
    goal = b.in_goal_rows(ball_row) & ((ball_col == 0) | (ball_col == b.W - 1))
    r = torch.where(goal, torch.where(ball_col == b.W - 1, 1, -1), 0)
    return (ra2, ca2, rb2, cb2, p2), goal, r


def isd_fields(b: Board, idx):
    """Fields (ra, ca, rb, cb, p) of the initial-state entries ``idx``."""
    table = torch.tensor([e[1] for e in b.isd], dtype=torch.int64,
                         device=idx.device)
    return table[idx].unbind(-1)


# ----------------------------------------------------------------------
# The journaled rollout
# ----------------------------------------------------------------------

def start_fields(b: Board, batch: int, device):
    """Lane i on initial-state entry i % nI at t = 0: six int64 [batch]."""
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    return (*isd_fields(b, lanes % len(b.isd)),
            torch.zeros(batch, dtype=torch.int64, device=device))


def autoreset(b: Board, s, t, goal, w2):
    """Truncation at ``max_steps`` and the uniform initial-state reset of
    the lanes whose episode ended; the reset's entry is the high 16 bits of
    word 2 modulo the entries.  Returns (fields, t, truncation flag,
    entry drawn)."""
    t = t + 1
    trunc = (t >= b.max_steps) & ~goal
    end = goal | trunc
    idx = ((w2 >> 16) & 0xFFFF) % len(b.isd)
    fresh = isd_fields(b, idx)
    s = tuple(torch.where(end, x0, x) for x0, x in zip(fresh, s))
    return s, torch.where(end, 0, t), trunc, idx


def journal_rollout(b: Board, seed: int, fields, n_steps: int,
                    step_offset: int, lanes=None, slip_bits: int = 16,
                    record: bool = False):
    """``n_steps`` random-vs-random steps from ``fields`` (six int64 [n]:
    ra, ca, rb, cb, p, t) at absolute steps ``step_offset`` on.  ``lanes``
    are the global lane ids of the n lanes (all of 0..n-1 by default).
    Returns (final fields, (reward sum, goals, truncations) as Python ints,
    journal int32 [n_steps, n]); with ``record`` a fourth element, the
    per-step stream int64 [n_steps, n]: ``raw`` (the state's raw code
    before the reset), ``raw_next`` (after it), ``aa``, ``ab``, ``r``
    (player A's reward), ``goal`` and ``trunc``."""
    ra, ca, rb, cb, p, t = (f.long() for f in fields)
    dev = ra.device
    n = ra.shape[0]
    if lanes is None:
        lanes = torch.arange(n, dtype=torch.int64, device=dev)
    words = torch.empty((n_steps, n), dtype=torch.int32, device=dev)
    keys = ("raw", "raw_next", "aa", "ab", "r", "goal", "trunc")
    rec = ({k: torch.empty((n_steps, n), dtype=torch.int64, device=dev)
            for k in keys} if record else None)
    rew = torch.zeros((), dtype=torch.int64, device=dev)
    goals, truncs = rew.clone(), rew.clone()
    s = (ra, ca, rb, cb, p)
    for i in range(n_steps):
        step = step_offset + i
        w0, w1, w2 = (random_word(seed, step, k, lanes) for k in range(3))
        aa = (w0 & 0xFFFF) % 5
        ab = ((w0 >> 16) & 0xFFFF) % 5
        s, goal, r = transition(b, s, aa, ab, w1, w2, slip_bits)
        raw = b.raw_code(*s)
        s, t, trunc, idx = autoreset(b, s, t, goal, w2)
        words[i] = (raw | ((aa * 5 + ab) << 16) | (goal.long() << 21)
                    | (trunc.long() << 22) | ((r == 1).long() << 23)
                    | (idx << 24)).to(torch.int32)
        if record:
            for k, x in zip(keys, (raw, b.raw_code(*s), aa, ab, r, goal,
                                   trunc)):
                rec[k][i] = x
        rew += r.sum()
        goals += goal.sum()
        truncs += trunc.sum()
    out = ((*s, t), (int(rew), int(goals), int(truncs)), words)
    return out + (rec,) if record else out
