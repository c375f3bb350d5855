"""Fused random-vs-random rollout: CUDA kernels and their plain versions.

The port of gym_soccer_tpu/ops/step_kernel.py.  Three public wrappers:

* ``fused_rollout``: T steps of random-vs-random play for ``batch`` lanes,
  returning the final state fields and the (reward sum, goals,
  truncations) totals.  Replaces ``pallas_rollout`` (kernel K1).
* ``fused_journal_rollout``: the same, plus one packed int32 journal word
  per lane-step ([T, B]), decoded by ``unpack_journal``.  Replaces
  ``pallas_journal_rollout`` (kernel K2).
* ``multigrid_rollout``: ``fused_rollout`` over a mixture of boards, lane
  i on variant i % nV, with the totals per variant.  Replaces
  ``pallas_multigrid_rollout`` (kernel K3).  Per-lane geometry is a
  ``GeoPlanes``, which ``transition_core``, ``autoreset_core`` and
  core/rules take where they take an ``EnvConfig``.
* ``alt_rollout``: T ticks of random play of the alternating-turn game
  (envs/soccer_alternating_env), one mover a tick, on seven fields (ra,
  ca, rb, cb, p, turn, t).  Replaces ``pallas_alt_rollout`` (kernel K4);
  its transition is ``alt_transition_core``.

Each has a plain PyTorch version here (``fused_rollout_plain``,
``fused_journal_rollout_plain``, ``multigrid_rollout_plain``,
``alt_rollout_plain``).  A wrapper
runs the plain version when its tensors lie on the CPU and launches the
CUDA kernel (``csrc/step_kernel.cu``) when they lie on a CUDA device;
there is no fallback from one to the other.  The wrappers run on the card
unless the caller passes ``device="cpu"``; the plain versions take a
device always.

Randomness is a counter PRNG: three murmur3 words per lane-step, a pure
integer function of (seed, absolute step, word index, global lane id), so
the kernels, the plain versions and the JAX package agree bit for bit, a
run resumed with ``init_fields``/``step_offset`` equals one long run, and
the CUDA block size changes nothing.  Lanes are flat: lane ``i`` of a
``[B]`` tensor is the JAX package's lane ``row * 128 + col`` (``interop``
converts the layouts).

uint32 arithmetic is done in int64 and masked to 32 bits, because PyTorch
has no uint32 add, shift or multiply on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import EnvConfig
from ..core import rules, tables

M32 = 0xFFFFFFFF
BATCH_MULTIPLE = 1024  # the JAX wrappers tile lanes as [B/128, 128], B % 1024 == 0

# Launches of each CUDA kernel in this process, counted by the wrappers
# where they launch and nowhere else.
launch_counts = {"fused_rollout": 0, "fused_journal_rollout": 0,
                 "multigrid_rollout": 0, "alt_rollout": 0}
MAX_VARIANTS = 16  # K3 sums its stats per variant in shared memory


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------------------
# Counter PRNG (uint32 values held in int64 tensors or Python ints)
# ----------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2**32 for a uint32 ``x`` and constant ``c``.  ``c`` is
    split into 16-bit halves so every partial product stays below 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix32(x):
    """murmur3 finalizer: full-avalanche 32-bit mix (uint32 in/out)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _random_word(seed, step, widx, lane_ctr):
    """One uint32 of pseudo-randomness per lane from the counter
    (seed, step, word index, lane)."""
    c = (_mul32(seed & M32, 0x9E3779B9) + _mul32(step & M32, 0x85EBCA77)
         + _mul32(widx, 0xC2B2AE3D)) & M32
    return (_fmix32((_fmix32(lane_ctr ^ c) + c) & M32))


def _u16(w, hi):
    return ((w >> (16 if hi else 0)) & 0xFFFF).to(torch.int32)


# ----------------------------------------------------------------------
# Game transition on [B] int32 tensors
# ----------------------------------------------------------------------

class GeoPlanes:
    """Per-lane geometry: int32 [B] tensors H, W (internal width), glo, ghi
    (the inclusive goal-row range) and q_int (round(slip * 65536)), and one
    ``max_steps`` for all lanes.  Duck-types ``EnvConfig`` in
    ``transition_core``, ``autoreset_core`` and core/rules, whose geometry
    reads are elementwise (gym_soccer_tpu/ops/step_kernel.py ``GeoPlanes``).
    """

    def __init__(self, H, W, glo, ghi, q_int, max_steps: int):
        self.H, self.W = H, W
        self.glo, self.ghi = glo, ghi
        self.q_int = q_int
        self.max_steps = max_steps

    @property
    def goal_row_bounds(self):
        return self.glo, self.ghi


def _q_int(cfg) -> int:
    if isinstance(cfg, GeoPlanes):
        return cfg.q_int
    return int(round(cfg.slip_prob * 65536))


def _n_isd(cfg: EnvConfig) -> int:
    return 4 if len(cfg.goal_rows) % 2 == 0 else 2


def _action_move(a):
    """(dcol, drow) of an action, arithmetically."""
    mc = (a == 3).to(torch.int32) - (a == 4).to(torch.int32)
    mr = (a == 2).to(torch.int32) - (a == 1).to(torch.int32)
    return mc, mr


def _slipped_move(a, u16, q_int):
    """Keep the intended move with p = 1-q, else one of the two orthogonals
    (q/2 each).  ``u16`` uniform in [0, 65536); ``q_int`` = round(q * 65536),
    an int or a per-lane int32 tensor."""
    mc, mr = _action_move(a)
    keep = u16 < 65536 - q_int
    first = u16 < 65536 - q_int // 2
    # orthogonals of (mc, mr): (-mr, mc) then (mr, -mc)
    omc = torch.where(first, -mr, mr)
    omr = torch.where(first, mc, -mc)
    return torch.where(keep, mc, omc), torch.where(keep, mr, omr)


def transition_core(ra, ca, rb, cb, p, aa, ab, bits1, bits2, cfg, q_int):
    """Game transition under CHOSEN actions: slips, collision chain, goal.
    ``cfg`` is an EnvConfig or a GeoPlanes.  Returns (nra, nca, nrb, ncb,
    npz, goal, r) without autoreset."""
    mca, mra = _slipped_move(aa, _u16(bits1, 0), q_int)
    mcb, mrb = _slipped_move(ab, _u16(bits1, 1), q_int)

    nxa, nya = rules.next_cell(torch, ra, ca, mca, mra, p == 0, cfg)
    nxb, nyb = rules.next_cell(torch, rb, cb, mcb, mrb, p == 1, cfg)

    # collision chain (reference priority order; see core/rules.py)
    c1 = ((ra == rb) & ((ca - cb).abs() == 1) & (nya == cb) & (nyb == ca)) | \
         ((ca == cb) & ((ra - rb).abs() == 1) & (nxa == rb) & (nxb == ra))
    c2 = ~c1 & (((nxa == rb) & (nya == cb) & (ab == 0)) |
                ((nxb == ra) & (nyb == ca) & (aa == 0)))
    c3 = ~c1 & ~c2 & (
        ((ra == nxa) & (ca == nya) & (aa != 0) & (nxb == ra) & (nyb == ca)) |
        ((rb == nxb) & (cb == nyb) & (ab != 0) & (nxa == rb) & (nya == cb)))
    c4 = ~c1 & ~c2 & ~c3 & (nxa == nxb) & (nya == nyb)
    c5 = ~c1 & ~c2 & ~c3 & ~c4

    coin = _u16(bits2, 0)
    coin_poss = coin & 1                 # 50/50 possession
    coin_who = ((coin >> 1) & 1) == 1    # c4: who advances

    a_moves = c5 | (c4 & coin_who)
    b_moves = c5 | (c4 & ~coin_who)
    nra = torch.where(a_moves, nxa, ra)
    nca = torch.where(a_moves, nya, ca)
    nrb = torch.where(b_moves, nxb, rb)
    ncb = torch.where(b_moves, nyb, cb)
    npz = torch.where(c2, 1 - p, torch.where(c1 | c3 | c4, coin_poss, p))

    a_ball = npz == 0
    ball_col = torch.where(a_ball, nca, ncb)
    gr = torch.where(a_ball, rules.in_goal_rows(nra, cfg),
                     rules.in_goal_rows(nrb, cfg))
    goal = gr & ((ball_col == 0) | (ball_col == cfg.W - 1))
    r = torch.where(goal, torch.where(ball_col == cfg.W - 1, 1, -1), 0)
    return nra, nca, nrb, ncb, npz, goal, r.to(torch.int32)


def alt_transition_core(ra, ca, rb, cb, p, turn, a, bits1, cfg, q_int):
    """Alternating-turn transition under the mover's CHOSEN action
    ``a``: the mover's slipped move on the low 16 bits of ``bits1``,
    steal-on-contact (a mover stepping into the opponent bounces back and
    the opponent gets the ball), the goal check on the carrier's cell.
    Returns (nra, nca, nrb, ncb, npz, goal, r); the caller flips the
    turn."""
    mc, mr = _slipped_move(a, _u16(bits1, 0), q_int)
    a_moves = turn == 0
    mx = torch.where(a_moves, ra, rb)
    my = torch.where(a_moves, ca, cb)
    ox = torch.where(a_moves, rb, ra)
    oy = torch.where(a_moves, cb, ca)
    nx, ny = rules.next_cell(torch, mx, my, mc, mr, p == turn, cfg)
    collide = (nx == ox) & (ny == oy)
    nx = torch.where(collide, mx, nx)
    ny = torch.where(collide, my, ny)
    npz = torch.where(collide, 1 - turn, p)
    nra = torch.where(a_moves, nx, ra)
    nca = torch.where(a_moves, ny, ca)
    nrb = torch.where(a_moves, rb, nx)
    ncb = torch.where(a_moves, cb, ny)
    a_ball = npz == 0
    ball_col = torch.where(a_ball, nca, ncb)
    gr = torch.where(a_ball, rules.in_goal_rows(nra, cfg),
                     rules.in_goal_rows(nrb, cfg))
    goal = gr & ((ball_col == 0) | (ball_col == cfg.W - 1))
    r = torch.where(goal, torch.where(ball_col == cfg.W - 1, 1, -1), 0)
    return nra, nca, nrb, ncb, npz, goal, r.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _isd_table(cfg: EnvConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tables.isd_fields(cfg), device=device)


def _isd_lookup(idx, cfg: EnvConfig):
    """Initial state fields (5 tensors) by ISD index."""
    return _isd_table(cfg, idx.device)[idx.long()].unbind(-1)


def _isd_fields_arith(idx, H, W, xp=torch):
    """Initial state fields from the geometry, arithmetically (reference
    _generate_isd): columns 2 and W - 3 on the middle rows, even-H boards
    swapping the rows for idx 2 and 3, possession idx % 2.  ``xp`` is torch
    or numpy."""
    even = (H % 2) == 0
    mid_hi = H // 2
    mid_lo = (H - 1) // 2
    swap = (idx // 2) == 1
    ira = xp.where(even & swap, mid_hi, mid_lo)
    irb = xp.where(even & swap, mid_lo, mid_hi)
    ip = idx % 2
    ica = xp.full_like(ira, 2)
    icb = W - 3
    return ira, ica, irb, icb, ip


def autoreset_core(nra, nca, nrb, ncb, npz, t, goal, bits2, cfg):
    """Truncation + uniform-ISD autoreset; returns updated fields, t and
    the truncation flag.  An EnvConfig ``cfg`` picks among its listed ISD
    entries (nI by the goal rows); a GeoPlanes computes each lane's entry
    arithmetically (nI by H % 2), as the two JAX kernels do."""
    t = t + 1
    trunc = (t >= cfg.max_steps) & ~goal
    term = goal | trunc
    if isinstance(cfg, GeoPlanes):
        n_entries = torch.where(cfg.H % 2 == 0, 4, 2).to(torch.int32)
        isd_idx = _u16(bits2, 1) % n_entries
        ira, ica, irb, icb, ip = _isd_fields_arith(isd_idx, cfg.H, cfg.W)
    else:
        isd_idx = _u16(bits2, 1) % _n_isd(cfg)
        ira, ica, irb, icb, ip = _isd_lookup(isd_idx, cfg)
    nra = torch.where(term, ira, nra)
    nca = torch.where(term, ica, nca)
    nrb = torch.where(term, irb, nrb)
    ncb = torch.where(term, icb, ncb)
    npz = torch.where(term, ip, npz)
    t = torch.where(term, 0, t)
    return nra, nca, nrb, ncb, npz, t, trunc


def isd_spread_fields(cfg: EnvConfig, batch: int, device):
    """Initial state fields (5 int32 tensors [batch]) with lane i on ISD
    entry i % nI.  (Starting every lane in the same ISD entry biases the
    aggregate reward: possession near one's own goal is an own-goal risk
    under random play.)"""
    device = torch.device(device)
    table = _isd_table(cfg, device)  # built on the device: no copy per call
    lane_isd = torch.arange(batch, device=device) % table.shape[0]
    return tuple(table.t()[:, lane_isd].unbind(0))


def init_alt_fields(cfg: EnvConfig, batch: int, device="cuda"):
    """Initial state of the alternating game: seven int32 [batch] tensors
    (ra, ca, rb, cb, p, turn, t), lane i on ISD entry i % nI, A to move,
    t = 0."""
    zeros = torch.zeros(batch, dtype=torch.int32, device=torch.device(device))
    return (*isd_spread_fields(cfg, batch, device), zeros, zeros.clone())


@functools.lru_cache(maxsize=None)
def _mg_planes_on(cfgs: tuple, batch: int, layout: str,
                  device: torch.device):
    """int32 [batch] tensors on ``device``, cached: the planes H, W, glo,
    ghi, q_int, variant id, then the initial ra, ca, rb, cb, p
    (gym_soccer_tpu/ops/step_kernel.py ``_mg_planes``)."""
    nV = len(cfgs)
    lanes = np.arange(batch, dtype=np.int64)
    if layout == "blocked":
        idx = lanes * nV // batch
    elif layout == "roundrobin":
        idx = lanes % nV
    else:
        raise ValueError(f"layout must be 'roundrobin' or 'blocked', got "
                         f"{layout!r}")
    per_variant = [[c.H for c in cfgs], [c.W for c in cfgs],
                   [c.goal_row_bounds[0] for c in cfgs],
                   [c.goal_row_bounds[1] for c in cfgs],
                   [_q_int(c) for c in cfgs]]
    planes = [np.asarray(v, np.int32)[idx] for v in per_variant]
    planes.append(idx.astype(np.int32))
    H, W = planes[0], planes[1]
    n_entries = np.where(H % 2 == 0, 4, 2)
    # the lane's initial ISD entry, (lane // nV) % n_entries whatever the
    # layout, as the JAX package spreads it
    isd = ((lanes // nV) % n_entries).astype(np.int32)
    init = [np.asarray(a, np.int32)
            for a in _isd_fields_arith(isd, H, W, xp=np)]
    return tuple(torch.as_tensor(a, device=device) for a in planes + init)


def mg_planes(cfgs: tuple, batch: int, device, layout: str = "roundrobin"):
    """Per-lane geometry planes and the initial state of a mixed-geometry
    batch on ``device``: ``(planes, fields)``, six int32 [batch] planes H,
    W, glo, ghi, q_int and variant id, and five int32 [batch] fields ra,
    ca, rb, cb, p.  ``layout`` 'roundrobin' puts lane i on variant i % nV
    (the rollout's); 'blocked' on variant i * nV // batch (the learner's).
    Either way lane i starts on its board's ISD entry (i // nV) %
    n_entries, computed arithmetically."""
    out = _mg_planes_on(tuple(cfgs), batch, layout, torch.device(device))
    return out[:6], tuple(f.clone() for f in out[6:])


def _geo(cfgs: tuple, batch: int, device, layout: str = "roundrobin"):
    """``mg_planes``'s six geometry planes alone, shared and read-only."""
    return _mg_planes_on(cfgs, batch, layout, torch.device(device))[:6]


def check_variants(cfgs) -> tuple:
    """``cfgs`` as a tuple of 1 to MAX_VARIANTS EnvConfigs that share
    max_steps (the kernels' truncation is one value for all lanes)."""
    cfgs = tuple(cfgs)
    if not 1 <= len(cfgs) <= MAX_VARIANTS:
        raise ValueError(f"a mixture takes 1 to {MAX_VARIANTS} variants, "
                         f"got {len(cfgs)}")
    if not all(isinstance(c, EnvConfig) for c in cfgs):
        raise ValueError("a mixture is a tuple of EnvConfigs")
    if len({c.max_steps for c in cfgs}) != 1:
        raise ValueError("variants must share max_steps, got "
                         f"{sorted({c.max_steps for c in cfgs})}")
    return cfgs


# ----------------------------------------------------------------------
# Journal words
# ----------------------------------------------------------------------
# One int32 per lane-step (the JAX package's layout, step_kernel.py:696-709):
#   bits  0-15  raw state code of the PRE-autoreset next state
#               (rules.raw_encode; needs H*W*H*W*2 <= 65536)
#   bits 16-20  joint action aa * 5 + ab
#   bit  21     goal (done)
#   bit  22     truncation
#   bit  23     reward sign (set iff reward_a == +1)
#   bits 24-25  autoreset ISD index

def _journal_word(raw, aa, ab, goal, trunc, r, isd_idx):
    i32 = torch.int32
    return (raw | ((aa * 5 + ab) << 16) | (goal.to(i32) << 21)
            | (trunc.to(i32) << 22) | ((r == 1).to(i32) << 23)
            | (isd_idx << 24))


def unpack_journal(cfg: EnvConfig, journal):
    """Decode a packed journal [T, B] (or [T, B/128, 128]) into the
    reference-shaped per-step stream.  Returns a dict of [T, B] tensors on
    the journal's device:

    obs        int32    post-step observation (post-autoreset)
    final_obs  int32    pre-autoreset observation (goal states -> 0)
    actions_a/actions_b  int32  the actions the lanes played
    reward_a   float32  +1 / -1 / 0 (player-A perspective)
    done       bool     goal this step
    truncated  bool     truncation this step
    """
    ss = tables.build_statespace(cfg)
    dev = journal.device
    w = journal.reshape(journal.shape[0], -1)
    raw = w & 0xFFFF
    ja = (w >> 16) & 31
    goal = ((w >> 21) & 1).bool()
    trunc = ((w >> 22) & 1).bool()
    rpos = (w >> 23) & 1
    isd_idx = (w >> 24) & 3
    raw_to_dense = torch.as_tensor(ss.raw_to_dense, device=dev)
    isd_dense = torch.as_tensor(ss.raw_to_dense[ss.isd_raw], device=dev)
    final_obs = raw_to_dense[raw.long()]
    reward = torch.where(rpos == 1, 1.0, -1.0).to(torch.float32)
    return {
        "obs": torch.where(goal | trunc, isd_dense[isd_idx.long()], final_obs),
        "final_obs": final_obs,
        "actions_a": ja // 5,
        "actions_b": ja % 5,
        "reward_a": torch.where(goal, reward, 0.0),
        "done": goal,
        "truncated": trunc,
    }


# ----------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------

def _plain(cfg, seed: int, fields, n_steps: int, step_offset: int,
           journal: bool):
    """The rollout on an EnvConfig or a GeoPlanes ``cfg``.  Returns the
    final fields, the per-lane int64 (reward, goal, truncation) sums and
    the journal words (None unless ``journal``)."""
    ra, ca, rb, cb, p, t = fields
    B = ra.shape[0]
    q_int = _q_int(cfg)
    lane = torch.arange(B, dtype=torch.int64, device=ra.device)
    rew = torch.zeros(B, dtype=torch.int64, device=ra.device)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    words = (torch.empty((n_steps, B), dtype=torch.int32, device=ra.device)
             if journal else None)
    for i in range(n_steps):
        step = i + step_offset
        bits0, bits1, bits2 = (_random_word(seed, step, w, lane)
                               for w in range(3))
        aa = _u16(bits0, 0) % 5
        ab = _u16(bits0, 1) % 5
        ra, ca, rb, cb, p, goal, r = transition_core(
            ra, ca, rb, cb, p, aa, ab, bits1, bits2, cfg, q_int)
        if journal:
            raw = rules.raw_encode(torch, ra, ca, rb, cb, p, cfg)
        ra, ca, rb, cb, p, t, trunc = autoreset_core(
            ra, ca, rb, cb, p, t, goal, bits2, cfg)
        if journal:
            words[i] = _journal_word(raw, aa, ab, goal, trunc, r,
                                     _u16(bits2, 1) % _n_isd(cfg))
        rew += r
        goals += goal
        truncs += trunc
    return (ra, ca, rb, cb, p, t), (rew, goals, truncs), words


def _totals(lane_sums):
    return tuple(x.sum() for x in lane_sums)


def fused_rollout_plain(cfg: EnvConfig, seed: int, batch: int, n_steps: int,
                        device, init_fields=None, step_offset: int = 0):
    """Plain PyTorch version of ``fused_rollout``, on any device."""
    fields = _start_fields(cfg, batch, n_steps, device, init_fields,
                           step_offset)
    out, sums, _ = _plain(cfg, seed, fields, n_steps, step_offset, False)
    return out, _totals(sums)


def fused_journal_rollout_plain(cfg: EnvConfig, seed: int, batch: int,
                                n_steps: int, device, init_fields=None,
                                step_offset: int = 0):
    """Plain PyTorch version of ``fused_journal_rollout``, on any device."""
    _check_journal_fits(cfg)
    fields = _start_fields(cfg, batch, n_steps, device, init_fields,
                           step_offset)
    out, sums, words = _plain(cfg, seed, fields, n_steps, step_offset, True)
    return out, _totals(sums), words


def _mg_plain(cfgs: tuple, seed: int, fields, planes, n_steps: int,
              step_offset: int):
    *geo, vid = planes
    out, sums, _ = _plain(GeoPlanes(*geo, cfgs[0].max_steps), seed, fields,
                          n_steps, step_offset, False)
    stats = torch.zeros((len(cfgs), 3), dtype=torch.int64,
                        device=vid.device)
    for k, x in enumerate(sums):
        stats[:, k].index_add_(0, vid.long(), x)
    return out, stats


def multigrid_rollout_plain(cfgs, seed: int, batch: int, n_steps: int,
                            device, init_fields=None, step_offset: int = 0):
    """Plain PyTorch version of ``multigrid_rollout``, on any device."""
    cfgs = check_variants(cfgs)
    fields = _start_fields(cfgs, batch, n_steps, device, init_fields,
                           step_offset)
    planes = _geo(cfgs, batch, fields[0].device)
    return _mg_plain(cfgs, seed, fields, planes, n_steps, step_offset)


def _alt_plain(cfg: EnvConfig, seed: int, fields, n_steps: int,
               step_offset: int):
    """The alternating game's random rollout: each tick the mover plays
    the low 16 bits of word 0 mod 5, slips on word 1, and a goal or a
    truncation resets on word 2 and gives the turn to A.  Returns the
    final seven fields and the (reward sum, goals, truncations) totals."""
    ra, ca, rb, cb, p, turn, t = fields
    q_int = _q_int(cfg)
    lane = torch.arange(ra.shape[0], dtype=torch.int64, device=ra.device)
    rew = torch.zeros(ra.shape[0], dtype=torch.int64, device=ra.device)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    for i in range(n_steps):
        bits0, bits1, bits2 = (_random_word(seed, i + step_offset, w, lane)
                               for w in range(3))
        ra, ca, rb, cb, p, goal, r = alt_transition_core(
            ra, ca, rb, cb, p, turn, _u16(bits0, 0) % 5, bits1, cfg, q_int)
        ra, ca, rb, cb, p, t, trunc = autoreset_core(
            ra, ca, rb, cb, p, t, goal, bits2, cfg)
        turn = torch.where(goal | trunc, 0, 1 - turn)
        rew += r
        goals += goal
        truncs += trunc
    return (ra, ca, rb, cb, p, turn, t), _totals((rew, goals, truncs))


def alt_rollout_plain(cfg: EnvConfig, seed: int, batch: int, n_steps: int,
                      device, init_fields=None, step_offset: int = 0):
    """Plain PyTorch version of ``alt_rollout``, on any device."""
    fields = _start_fields(cfg, batch, n_steps, device, init_fields,
                           step_offset, alt=True)
    return _alt_plain(cfg, seed, fields, n_steps, step_offset)


# ----------------------------------------------------------------------
# Public wrappers
# ----------------------------------------------------------------------

def fused_rollout(cfg: EnvConfig, seed: int, batch: int, n_steps: int,
                  device="cuda", init_fields=None, step_offset: int = 0,
                  threads=None):
    """Run ``n_steps`` of random-vs-random play for ``batch`` lanes.

    Returns ``(fields, (reward_sum, goals, truncs))``: the final
    (ra, ca, rb, cb, p, t) as int32 [batch] tensors and the totals as
    int64 scalars, all on ``device``.  ``batch`` must be a multiple of
    1024.  ``init_fields`` (6 int32 [batch] tensors on ``device``) and
    ``step_offset`` resume from an earlier call's final fields at that
    absolute step: the two calls equal one long call bit for bit.  Without
    ``init_fields`` lane i starts on ISD entry i % nI with t = 0.
    ``threads`` is the kernel's lanes per block: a multiple of 32 in [32,
    512] whose shared memory fits (``rollout_codes.check_lanes``; 64 by
    default, ValueError otherwise, on any device); it does not change the
    result.

    On a CPU device this runs ``fused_rollout_plain``; on a CUDA device it
    launches the K1 kernel.
    """
    device = torch.device(device)
    fields = _start_fields(cfg, batch, n_steps, device, init_fields,
                           step_offset, make=device.type == "cpu")
    lanes = _lanes(cfg, threads)
    if device.type == "cpu":
        out, sums, _ = _plain(cfg, seed, fields, n_steps, step_offset, False)
        return out, _totals(sums)
    out, stats, _ = _launch_rollout("fused_rollout", cfg, seed, device,
                                    batch, fields, n_steps, step_offset,
                                    lanes)
    return out, stats


def fused_journal_rollout(cfg: EnvConfig, seed: int, batch: int,
                          n_steps: int, device="cuda", init_fields=None,
                          step_offset: int = 0, threads=None):
    """``fused_rollout`` that also journals every transition.

    Returns ``(fields, stats, journal)``; the trajectories, fields and
    stats equal ``fused_rollout``'s for the same arguments, and
    ``journal`` is int32 [n_steps, batch], one packed word per lane-step
    (decode with ``unpack_journal``).  ``threads`` as in
    ``fused_rollout``.  On a CPU device this runs
    ``fused_journal_rollout_plain``; on a CUDA device it launches the K2
    kernel.
    """
    _check_journal_fits(cfg)
    device = torch.device(device)
    fields = _start_fields(cfg, batch, n_steps, device, init_fields,
                           step_offset, make=device.type == "cpu")
    lanes = _lanes(cfg, threads)
    if device.type == "cpu":
        out, sums, words = _plain(cfg, seed, fields, n_steps, step_offset,
                                  True)
        return out, _totals(sums), words
    return _launch_rollout("fused_journal_rollout", cfg, seed, device, batch,
                           fields, n_steps, step_offset, lanes)


def multigrid_rollout(cfgs, seed: int, batch: int, n_steps: int,
                      device="cuda", init_fields=None, step_offset: int = 0,
                      threads=None):
    """``fused_rollout`` over a mixture of boards: ``cfgs`` is a tuple of 1
    to 16 EnvConfigs sharing max_steps, and lane i plays on cfgs[i % nV]
    (its height, width, goal rows and slip), starting on its board's ISD
    entry (i // nV) % nI unless ``init_fields`` are given.

    Returns ``(fields, stats)``: the final (ra, ca, rb, cb, p, t) as int32
    [batch] tensors and int64 [nV, 3] per-variant (reward sum, goals,
    truncations), on ``device``.  ``batch`` is a multiple of 1024;
    ``init_fields``/``step_offset`` resume as in ``fused_rollout``.
    ``threads`` is the kernel's lanes per block: a multiple of 32 in [32,
    512] (``rollout_codes.lanes_per_block``; 64 by default, ValueError
    otherwise, on any device); it does not change the result.

    On a CPU device this runs ``multigrid_rollout_plain``; on a CUDA device
    it launches the K3 kernel.
    """
    from . import rollout_codes
    cfgs = check_variants(cfgs)
    lanes = rollout_codes.lanes_per_block(threads)
    fields = _start_fields(cfgs, batch, n_steps, device, init_fields,
                           step_offset)
    planes = _geo(cfgs, batch, fields[0].device)
    if fields[0].device.type == "cpu":
        return _mg_plain(cfgs, seed, fields, planes, n_steps, step_offset)
    return _launch_mg(cfgs, seed, fields, planes, n_steps, step_offset,
                      lanes)


def alt_rollout(cfg: EnvConfig, seed: int, batch: int, n_steps: int,
                device="cuda", init_fields=None, step_offset: int = 0,
                threads=None):
    """Run ``n_steps`` ticks of random play of the alternating-turn game for
    ``batch`` lanes: each tick only the mover acts, with a uniformly random
    action.

    Returns ``(fields, (reward_sum, goals, truncs))``: the final (ra, ca,
    rb, cb, p, turn, t) as int32 [batch] tensors and the totals as int64
    scalars, on ``device``.  ``batch`` is a multiple of 1024.
    ``init_fields`` (7 int32 [batch] tensors on ``device``) and
    ``step_offset`` resume from an earlier call at that absolute step, bit
    for bit; without them lane i starts on ISD entry i % nI, A to move,
    t = 0 (``init_alt_fields``).  ``threads`` is the kernel's lanes per
    block: a multiple of 32 in [32, 512] whose shared memory fits
    (``rollout_codes.check_alt_lanes``; 64 by default, ValueError
    otherwise, on any device); it does not change the result.

    On a CPU device this runs ``alt_rollout_plain``; on a CUDA device it
    launches the K4 kernel.
    """
    device = torch.device(device)
    fields = _start_fields(cfg, batch, n_steps, device, init_fields,
                           step_offset, alt=True, make=device.type == "cpu")
    lanes = _alt_lanes(cfg, threads)
    if device.type == "cpu":
        return _alt_plain(cfg, seed, fields, n_steps, step_offset)
    return _launch_alt(cfg, seed, device, batch, fields, n_steps, step_offset,
                       lanes)


def _lanes(cfg: EnvConfig, threads) -> int:
    from . import rollout_codes
    return rollout_codes.check_lanes(cfg, threads)


def _alt_lanes(cfg: EnvConfig, threads) -> int:
    from . import rollout_codes
    return rollout_codes.check_alt_lanes(cfg, threads)


def _check_journal_fits(cfg: EnvConfig) -> None:
    if cfg.n_raw > 65536:
        raise ValueError(f"raw state code needs {cfg.n_raw} values; the "
                         "journal word holds 16 bits")


def _start_fields(cfg, batch: int, n_steps: int, device, init_fields,
                  step_offset: int, alt: bool = False, make: bool = True):
    """The six int32 [batch] starting planes on ``device``, checked; ``cfg``
    is an EnvConfig or a tuple of them (a mixture, round-robin).  ``alt``:
    the alternating game's seven (turn before t).  Without ``init_fields``
    and ``make``, None: K1/K2 start lane i on ISD entry i % nI
    themselves."""
    if batch <= 0 or batch % BATCH_MULTIPLE:
        raise ValueError(f"batch must be a positive multiple of "
                         f"{BATCH_MULTIPLE}, got {batch}")
    if n_steps < 0 or step_offset < 0 or n_steps + step_offset >= 2**31:
        raise ValueError(f"steps [{step_offset}, {step_offset + n_steps}) "
                         "must lie in [0, 2**31)")
    device = torch.device(device)
    if init_fields is None and not make:
        return None
    if init_fields is None:
        if alt:
            return init_alt_fields(cfg, batch, device)
        start = (mg_planes(cfg, batch, device)[1] if isinstance(cfg, tuple)
                 else isd_spread_fields(cfg, batch, device))
        return (*start, torch.zeros(batch, dtype=torch.int32, device=device))
    fields = tuple(init_fields)
    if len(fields) != (7 if alt else 6):
        raise ValueError(f"init_fields = {7 if alt else 6} tensors (ra, ca, "
                         f"rb, cb, p, {'turn, ' if alt else ''}t)")
    for f in fields:
        if (f.dtype != torch.int32 or tuple(f.shape) != (batch,)
                or not f.is_contiguous() or f.device.type != device.type
                or (device.index is not None and f.device != device)):
            raise ValueError(
                f"init_fields must be contiguous int32 [{batch}] tensors on "
                f"{device}; got {f.dtype} {tuple(f.shape)} on {f.device}")
    return fields


# ----------------------------------------------------------------------
# CUDA launch (K1, K2, K3, K4)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared."""
    from . import _build
    return declare(_build.load("step_kernel"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``csrc/step_kernel.cu``."""
    vp, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    # params, table, code_raw, n_codes, B, T, seed, offset, lanes, stream
    k1k2 = [vp, vp, vp, i32, i32, i32, u32, i32, i32, vp]
    lib.gst_fused_rollout.argtypes = [i32, vp, vp, vp] + k1k2
    lib.gst_fused_journal_rollout.argtypes = [i32, vp, vp, vp, vp] + k1k2
    lib.gst_alt_rollout.argtypes = [i32, vp, vp, vp] + k1k2
    for fn in (lib.gst_rollout_smem_bytes, lib.gst_alt_rollout_smem_bytes):
        fn.argtypes = [i32, i32]
        fn.restype = i32
    lib.gst_mg_rollout_smem_bytes.argtypes = [i32]
    lib.gst_mg_rollout_smem_bytes.restype = i32
    lib.gst_rollout_shape.argtypes = [vp]
    lib.gst_rollout_shape.restype = None
    lib.gst_multigrid_rollout.argtypes = [i32, vp, vp, vp, vp, i32, i32, u32,
                                          i32, i32, i32, i32, vp]
    #    device, in, out, geo, stats, B, T, seed, offset, max_steps,
    #    n_variants, lanes, stream
    for fn in (lib.gst_fused_rollout, lib.gst_fused_journal_rollout,
               lib.gst_multigrid_rollout, lib.gst_alt_rollout):
        fn.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _game_params(cfg: EnvConfig):
    """The kernels' game description: H, W, goal-row bounds, q_int,
    max_steps, nI, then the ISD entries' fields."""
    lo, hi = cfg.goal_row_bounds
    isd = tables.isd_fields(cfg)
    vals = [cfg.H, cfg.W, lo, hi, _q_int(cfg), cfg.max_steps, len(isd),
            *isd.ravel().tolist()]
    return (ctypes.c_int32 * len(vals))(*vals)


def ptr_array(tensors):
    """A host array of the tensors' device pointers, as the kernels' entry
    points take them; keep it alive across the call."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_rollout(name: str, cfg: EnvConfig, seed: int, dev: torch.device,
                    B: int, fields, n_steps: int, step_offset: int,
                    lanes: int):
    """Launch K1 or K2 on ``B`` lanes from ``fields`` (None: the kernel's
    ISD spread) at ``lanes`` lanes per block, on the step table when the
    geometry takes it (``rollout_codes.uses_table``)."""
    from . import rollout_codes
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    lib = _library()
    if fields is not None:
        dev = fields[0].device
    elif dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    planes = torch.empty((6, B), dtype=torch.int32, device=dev)
    out = tuple(planes.unbind(0))
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    in_ptrs = None if fields is None else ptr_array(fields)
    out_ptrs = (ctypes.c_void_p * 6)(*(planes.data_ptr() + 4 * B * k
                                      for k in range(6)))
    head = [dev.index, None if in_ptrs is None else ctypes.addressof(in_ptrs),
            ctypes.addressof(out_ptrs), stats.data_ptr()]
    journal = None
    if name == "fused_journal_rollout":
        journal = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
        head.append(journal.data_ptr())
    table = (rollout_codes.device_step_table(cfg, dev)
             if rollout_codes.uses_table(cfg) else None)
    rc = getattr(lib, "gst_" + name)(
        *head, ctypes.addressof(_game_params(cfg)),
        None if table is None else table.table.data_ptr(),
        None if table is None else table.code_raw.data_ptr(),
        0 if table is None else table.n_codes, B, n_steps, seed & M32,
        step_offset, lanes, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    launch_counts[name] += 1
    return out, tuple(stats.unbind()), journal


def _launch_alt(cfg: EnvConfig, seed: int, dev: torch.device, B: int,
                fields, n_steps: int, step_offset: int, lanes: int):
    """Launch K4 on ``B`` lanes from ``fields`` (None: the kernel's ISD
    spread) at ``lanes`` lanes per block, on the tick table when the
    geometry takes it (``rollout_codes.uses_alt_table``).  The seven
    output planes and the stats are views of one allocation."""
    from . import rollout_codes
    name = "alt_rollout"
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    lib = _library()
    if fields is not None:
        dev = fields[0].device
    elif dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    buf = torch.empty(3 + 7 * B // 2, dtype=torch.int64, device=dev)
    in_ptrs = None if fields is None else ptr_array(fields)
    base = buf.data_ptr() + 24
    out_ptrs = (ctypes.c_void_p * 7)(*(base + 4 * B * k for k in range(7)))
    table = (rollout_codes.device_alt_table(cfg, dev)
             if rollout_codes.uses_alt_table(cfg) else None)
    rc = lib.gst_alt_rollout(
        dev.index, None if in_ptrs is None else ctypes.addressof(in_ptrs),
        ctypes.addressof(out_ptrs), buf.data_ptr(),
        ctypes.addressof(_game_params(cfg)),
        None if table is None else table.table.data_ptr(),
        None if table is None else table.code_raw.data_ptr(),
        0 if table is None else table.n_codes, B, n_steps, seed & M32,
        step_offset, lanes, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    launch_counts[name] += 1
    return (buf.view(torch.int32).as_strided((7, B), (B, 1), 6).unbind(0),
            buf.as_strided((3,), (1,), 0).unbind())


def _launch_mg(cfgs: tuple, seed: int, fields, planes, n_steps: int,
               step_offset: int, lanes: int):
    """Launch K3 at ``lanes`` lanes per block; the launch zeroes the
    stats."""
    name = "multigrid_rollout"
    dev = fields[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    lib = _library()
    B = fields[0].shape[0]
    out = tuple(torch.empty_like(f) for f in fields)
    stats = torch.empty((len(cfgs), 3), dtype=torch.int64, device=dev)
    in_ptrs, out_ptrs, geo_ptrs = (ptr_array(x) for x in (fields, out, planes))
    rc = lib.gst_multigrid_rollout(
        dev.index, ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
        ctypes.addressof(geo_ptrs), stats.data_ptr(), B, n_steps, seed & M32,
        step_offset, cfgs[0].max_steps, len(cfgs), lanes,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    launch_counts[name] += 1
    return out, stats
