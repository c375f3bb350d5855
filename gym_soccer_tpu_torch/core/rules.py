"""Pure, branchless rules of the Littman94 simultaneous soccer game.

The port of gym_soccer_tpu/core/rules.py.  Every function is written
against an array namespace ``xp``: ``numpy`` (host-side table building) or
``torch`` (the batched engine, on any device).  Passing the ``torch``
module selects ``_TorchXP``, which spells the few numpy calls the rules
make (``broadcast_arrays``, ``stack(axis=)``, ``clip``, a callable
``float32``) for tensors.  The geometry (``cfg``) is an ``EnvConfig`` or
anything with its H, W and ``goal_row_bounds`` as per-lane tensors
(ops/step_kernel.GeoPlanes, core/multigrid.LaneGeometry).

Semantics are the reference's (gym_soccer/envs/soccer_simultaneous_env.py):

* single-player kinematics ``_next_cell`` (:364-373),
* the 4-priority collision chain ``_get_next_state`` (:296-362),
* goal/terminal classification (:91-102).

The reference's ordered if/elif chain becomes mutually exclusive masks with
identical precedence; its 1/2/4-outcome lists become 4 fixed outcome slots
(invalid slots carry probability weight 0) appended in the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import NOOP, EnvConfig


class _TorchXP:
    """The numpy calls of this module, for torch tensors."""

    abs = staticmethod(torch.abs)
    ones_like = staticmethod(torch.ones_like)
    zeros_like = staticmethod(torch.zeros_like)
    broadcast_arrays = staticmethod(torch.broadcast_tensors)

    @staticmethod
    def clip(a, lo, hi):
        # torch.clamp takes two numbers or two tensors as bounds, not one of
        # each; a per-lane board (ops/step_kernel.GeoPlanes) has a tensor H.
        # The number becomes a 0-d tensor filled on the device (no copy
        # from the host, which a CUDA-graph capture refuses).
        if isinstance(lo, torch.Tensor) != isinstance(hi, torch.Tensor):
            lo, hi = (x if isinstance(x, torch.Tensor) else
                      torch.full((), x, dtype=a.dtype, device=a.device)
                      for x in (lo, hi))
        return torch.clamp(a, lo, hi)

    @staticmethod
    def ascontiguousarray(a):
        return a.contiguous()

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(arrays, dim=axis)

    @staticmethod
    def float32(v):
        # A Python float holding the value rounded to float32, as a JAX
        # weak-typed scalar is rounded when it meets a float32 array.
        return float(np.float32(v))

    @staticmethod
    def where(cond, a, b):
        # torch.where of two Python floats would take the default dtype;
        # the rules' weights are float32 like the JAX engine's.
        if isinstance(a, float) and isinstance(b, float):
            a = torch.full((), a, dtype=torch.float32, device=cond.device)
        return torch.where(cond, a, b)


def _xp(xp):
    return _TorchXP if xp is torch else xp


def in_goal_rows(x, cfg):
    """Membership of a row index in the (contiguous) goal rows."""
    lo, hi = cfg.goal_row_bounds
    return (x >= lo) & (x <= hi)


def next_cell(xp, x, y, mc, mr, has_ball, cfg: EnvConfig):
    """Single-player kinematics (reference :364-373).

    Rows clamp to [0, H-1]; a column move that lands in a goal column
    bounces back unless the mover is on a goal row AND carries the ball.
    ``mc``/``mr`` are (dcol, drow); ``x`` is the row, ``y`` the column.
    """
    xp = _xp(xp)
    nx = xp.clip(x + mr, 0, cfg.H - 1)
    ny_try = y + mc
    xoob = (ny_try == 0) | (ny_try == cfg.W - 1)
    goal = xoob & in_goal_rows(nx, cfg) & has_ball
    ny = xp.where(xoob & ~goal, y, ny_try)
    return nx, ny


def resolve_outcomes(xp, xa, ya, xb, yb, p, aa, ab, mca, mra, mcb, mrb,
                     cfg: EnvConfig):
    """Resolve one joint (possibly slipped) move into the 4 ordered outcome
    slots of the reference's collision chain (:296-362).

    Args are broadcastable integer arrays: state fields, ORIGINAL action ints
    (the chain keys on those, not on the slipped moves — :330-335), and the
    effective (dcol, drow) displacements after slip resolution.

    Returns a dict of arrays with a trailing axis of size 4:
      rows_a, cols_a, rows_b, cols_b, poss : outcome states
      weight : per-slot probability weight (0.0 on invalid slots); float64
               under numpy, float32 under torch (the weights are exact in
               either).

    Goal (absorbing) input states yield slot0 = the state itself with
    weight 1.0 (:300-301).
    """
    is_np = xp is np
    xp = _xp(xp)
    xa, ya, xb, yb, p, aa, ab, mca, mra, mcb, mrb = (
        xp.ascontiguousarray(a) for a in xp.broadcast_arrays(
            xa, ya, xb, yb, p, aa, ab, mca, mra, mcb, mrb))
    one = xp.ones_like(xa)
    has_a = p == 0
    has_b = p == 1

    gst = is_goal_state(xp, xa, ya, xb, yb, p, cfg)

    nxa, nya = next_cell(xp, xa, ya, mca, mra, has_a, cfg)
    nxb, nyb = next_cell(xp, xb, yb, mcb, mrb, has_b, cfg)

    # Case 1 — swap-through (:315-327).
    c1 = ((xa == xb) & (xp.abs(ya - yb) == 1) & (nya == yb) & (nyb == ya)) | \
         ((ya == yb) & (xp.abs(xa - xb) == 1) & (nxa == xb) & (nxb == xa))
    # Case 2 — moving into a standing (NOOP) opponent (:330-335).
    c2 = ~c1 & (((nxa == xb) & (nya == yb) & (ab == NOOP)) |
                ((nxb == xa) & (nyb == ya) & (aa == NOOP)))
    # Case 3 — a bounced non-NOOP player's cell is invaded (:338-344).
    c3 = ~c1 & ~c2 & (
        ((xa == nxa) & (ya == nya) & (aa != NOOP) & (nxb == xa) & (nyb == ya)) |
        ((xb == nxb) & (yb == nyb) & (ab != NOOP) & (nxa == xb) & (nya == yb)))
    # Case 4 — race to the same cell (:347-356).
    c4 = ~c1 & ~c2 & ~c3 & (nxa == nxb) & (nya == nyb)
    # Else — clean move (:357-360).
    c5 = ~c1 & ~c2 & ~c3 & ~c4

    fw = np.float64 if is_np else xp.float32

    # ---- slot 0 ----
    xa0 = xp.where(c5, nxa, xa)
    ya0 = xp.where(c5, nya, ya)
    xb0 = xp.where(c4 | c5, nxb, xb)
    yb0 = xp.where(c4 | c5, nyb, yb)
    p0 = xp.where(c2, 1 - p, xp.where(c5, p, 0 * one))
    w0 = xp.where(c1 | c3, fw(0.5), xp.where(c4, fw(0.25), fw(1.0)))

    # ---- slot 1 ---- (cases 1/3: bounce with possession B; case 4: A
    # bounces & B moves with possession B)
    xb1 = xp.where(c4, nxb, xb)
    yb1 = xp.where(c4, nyb, yb)
    w1 = xp.where(c4, fw(0.25), xp.where(c1 | c3, fw(0.5), fw(0.0)))

    # ---- slots 2 & 3 ---- (case 4 only: B bounces & A moves, possession
    # A then B)
    w23 = xp.where(c4, fw(0.25), fw(0.0))

    zero = 0 * one
    rows_a = xp.stack([xa0, xa, nxa, nxa], axis=-1)
    cols_a = xp.stack([ya0, ya, nya, nya], axis=-1)
    rows_b = xp.stack([xb0, xb1, xb, xb], axis=-1)
    cols_b = xp.stack([yb0, yb1, yb, yb], axis=-1)
    poss = xp.stack([p0, one, zero, one], axis=-1)
    weight = xp.stack([w0, w1, w23, w23], axis=-1)

    # Absorbing goal states override everything: slot0 = self, weight 1.
    g = gst[..., None]
    rows_a = xp.where(g, _bcast4(xp, xa), rows_a)
    cols_a = xp.where(g, _bcast4(xp, ya), cols_a)
    rows_b = xp.where(g, _bcast4(xp, xb), rows_b)
    cols_b = xp.where(g, _bcast4(xp, yb), cols_b)
    poss = xp.where(g, _bcast4(xp, p), poss)
    gw = xp.stack([xp.ones_like(w0), xp.zeros_like(w0),
                   xp.zeros_like(w0), xp.zeros_like(w0)], axis=-1)
    weight = xp.where(g, gw, weight)

    return {
        "rows_a": rows_a, "cols_a": cols_a,
        "rows_b": rows_b, "cols_b": cols_b,
        "poss": poss, "weight": weight,
    }


def _bcast4(xp, v):
    return xp.stack([v, v, v, v], axis=-1)


def is_goal_state(xp, xa, ya, xb, yb, p, cfg: EnvConfig):
    """Terminal classification (:91-102): the possessing player sits in a
    goal row AND a goal column."""
    ga = (p == 0) & in_goal_rows(xa, cfg) & ((ya == 0) | (ya == cfg.W - 1))
    gb = (p == 1) & in_goal_rows(xb, cfg) & ((yb == 0) | (yb == cfg.W - 1))
    return ga | gb


def goal_reward_a(xp, xa, ya, xb, yb, p, cfg: EnvConfig):
    """Player-A-perspective float64 reward of a goal state (:94-102): +1 if
    the ball sits in the right goal column, -1 if the left; 0 for non-goal
    states.  Host tables only (numpy)."""
    ball_col = xp.where(p == 0, ya, yb)
    g = is_goal_state(xp, xa, ya, xb, yb, p, cfg)
    r = xp.where(ball_col == cfg.W - 1, xp.float64(1.0), xp.float64(-1.0))
    return xp.where(g, r, xp.float64(0.0))


def is_unreachable(xp, xa, ya, xb, yb, p, cfg: EnvConfig):
    """States excluded from the dense index (:74-88): corners of the goal
    columns, goal cells without possession, and co-located players."""
    gr_a, gr_b = in_goal_rows(xa, cfg), in_goal_rows(xb, cfg)
    gc_a = (ya == 0) | (ya == cfg.W - 1)
    gc_b = (yb == 0) | (yb == cfg.W - 1)
    corner = (gc_a & ~gr_a) | (gc_b & ~gr_b)
    goal_no_ball = (gr_a & gc_a & (p != 0)) | (gr_b & gc_b & (p != 1))
    same_cell = (xa == xb) & (ya == yb)
    return corner | goal_no_ball | same_cell


def n_cells(cfg: EnvConfig) -> int:
    """Number of VALID board cells: interior columns are fully valid; the
    two goal columns only at the goal rows."""
    lo, hi = cfg.goal_row_bounds
    return (cfg.W - 2) * cfg.H + 2 * (hi - lo + 1)


def n_cellpairs(cfg: EnvConfig) -> int:
    """Size of the compact (cell_a, cell_b != cell_a, poss) code space."""
    nc = n_cells(cfg)
    return 2 * nc * (nc - 1)


def cell_encode(xp, r, c, cfg: EnvConfig):
    """Closed-form rank of a VALID cell (see n_cells).  Inputs must be
    valid cells (every state the rules can produce is)."""
    xp = _xp(xp)
    lo, hi = cfg.goal_row_bounds
    ni = (cfg.W - 2) * cfg.H
    interior = (c - 1) * cfg.H + r
    goal = ni + xp.where(c == cfg.W - 1, r - lo + (hi - lo + 1), r - lo)
    return xp.where((c == 0) | (c == cfg.W - 1), goal, interior)


def cellpair_encode(xp, xa, ya, xb, yb, p, cfg: EnvConfig):
    """Compact closed-form state code over (valid cell A, valid cell B,
    possession) with the always-true A != B constraint folded in (1104
    codes on 5x4 against 1568 raw codes)."""
    nc = n_cells(cfg)
    a = cell_encode(xp, xa, ya, cfg)
    b = cell_encode(xp, xb, yb, cfg)
    b_rank = _xp(xp).where(b > a, b - 1, b)  # remove the diagonal
    return (a * (nc - 1) + b_rank) * 2 + p


def raw_encode(xp, xa, ya, xb, yb, p, cfg: EnvConfig):
    """Mixed-radix raw code in the reference's enumeration order
    (xa, ya, xb, yb, p ascending, :66-70)."""
    W, H = cfg.W, cfg.H
    return (((xa * W + ya) * H + xb) * W + yb) * 2 + p


def raw_decode(xp, code, cfg: EnvConfig):
    W, H = cfg.W, cfg.H
    p = code % 2
    code = code // 2
    yb = code % W
    code = code // W
    xb = code % H
    code = code // H
    ya = code % W
    xa = code // W
    return xa, ya, xb, yb, p
