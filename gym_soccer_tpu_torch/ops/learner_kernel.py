"""Fused minimax-Q training: CUDA kernels K5, K6 and K7, their plain
versions, and the chunked trainers.

The port of gym_soccer_tpu/ops/learner_kernel.py.  A chunk runs ``n_steps``
act -> step -> TD steps for ``batch`` lanes against a table that stays
frozen for the chunk: each lane samples both players' actions from the
exploration-mixed policies of its state, steps the game (ops/step_kernel's
transition and autoreset, the same counter PRNG), and accumulates per
(state, joint action) the visit count and a sum:

* the packed layout (the trainers' default): the Bellman residual
  r + gamma * v(s') - v(s); between chunks the trainer completes the TD
  sums with cnt * (v - q), constant within a chunk.
  ``packed_learner_chunk`` (kernel K5) on one board,
  ``multigrid_packed_learner_chunk`` (kernel K6) on a mixture;
* the unpacked layout (``packed=False``): the full TD
  r + gamma * v(s') - q(s, a).  ``learner_chunk`` and
  ``multigrid_learner_chunk`` (kernel K7, its two call sites).

Both layouts step the same trajectories and count the same visits for the
same policy columns.  Between chunks ``fused_minimax_train`` applies the
count-normalised Q update, re-solves every state's 5x5 matrix game by RM+
(agents/learners) and repacks the table; ``fused_best_response_train``
runs the same chunks against a frozen opponent.

The table is indexed by the compact cellpair code (core/rules
``cellpair_encode``): float32 [n_codes, 11] (``pack_m2``) holding pi_a (5),
pi_b (5) and v, or [n_codes, 36] (``pack_m``) with q (25) after them.  The
pi values are the JAX package's: exploration-mixed in float32 and rounded
to bfloat16, so that both packages and both layouts sample the same
actions; v and q are kept exact (the JAX kernels read double-bfloat16
hi + lo, which moves the sums by ~2**-18 relative and never a
trajectory).  The accumulators are int64 sums in units of 2**-32 and int32
counts, [n_codes, 25] each, exact in any order of addition;
``unpack_acc2``/``unpack_acc`` convert them to float32 per dense state.

A mixture of boards (a tuple of EnvConfigs, BASELINE config 4) trains one
table concatenated over the variants: each variant's codes form a block,
8-aligned as in the JAX package (``mg_offsets``), so a JAX table carries
over row for row, and the dense states concatenate in variant order
(core/multigrid ``build_codec``).  Lanes are assigned variants in
contiguous blocks (``init_state_fields``), and six per-lane planes give
each lane its board (H, W, goal rows, slip) and its block's row offset.

A wrapper runs the plain PyTorch version when its tensors lie on the CPU
and launches the kernel (``csrc/learner_kernel.cu``: K5, K6 and K7 one
split template) when they lie on a CUDA device; there is no fallback from
one to the other.  The chunk wrappers take their device
from their tensors; the functions that make their own tensors (the
trainers, ``init_state_fields``) default to "cuda": CPU callers pass
"cpu".

The trainers' grouped dispatch modes (``single_dispatch``,
``chunks_per_dispatch``) run g chunks and the work between them as one
CUDA-graph replay (ops/dispatch), with the chunk's seed read from device
memory; the re-solve is kernel R1 (agents/learners ``solve_matrix_games``)
on the card.  ``mesh`` (parallel/mesh) trains data-parallel: each rank
runs its block of the lanes and the chunks' sums are all-reduced.  The JAX
wrappers' VMEM guards (tables over ~14 MB) have no counterpart: the port
reads its tables from device memory and takes any grid and any mixture.
"""
from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from ..agents import learners
from ..agents.learners import solve_matrix_games
from ..config import N_ACTIONS, EnvConfig
from ..core import rules, tables
from . import dispatch
from . import step_kernel as sk

LANES = 128                 # batch granularity (the JAX wrapper's lane tile)
NJ = N_ACTIONS * N_ACTIONS  # 25 joint actions
TABLE_COLS = 11             # packed row: pi_a[5], pi_b[5], v
TABLE_COLS_UNPACKED = 36    # unpacked row: pi_a[5], pi_b[5], v, q[25]
COL_PI_A, COL_PI_B, COL_V, COL_Q = 0, 5, 10, 11
FIX_SCALE = 2.0 ** 32       # sums count units of 2**-32
VARIANT_ALIGN = 8           # a variant's block of rows starts 8-aligned
# The int32 counts and the int64 sums' reward term stay exact up to
# batch * n_steps = 2**29; that cap also keeps ``value_limit`` >= 1, so a
# table with |v|, |q| <= 1 counts nothing out of range.
MAX_LANE_STEPS = 2 ** 29

# Launches of the CUDA kernels in this process, counted by the wrapper
# where it launches and nowhere else.
launch_counts = {"packed_learner_chunk": 0,
                 "multigrid_packed_learner_chunk": 0,
                 "learner_chunk": 0, "multigrid_learner_chunk": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=64)
def value_limit(batch: int, n_steps: int) -> float:
    """The float32 bound on the table values a chunk reads (v, and q(s, a)
    unpacked) within which its int64 sums stay exact.  Each summed value
    is r + cont * v' - v (or - q) with |r| <= 1 and 0 <= cont <= 1, so at
    most 1 + 2 * limit; batch * n_steps of them, each rounded to units of
    2**-32, sum below 2**32 * batch * n_steps + 2**62 + batch * n_steps,
    within int64 while batch * n_steps <= 2**29 (``MAX_LANE_STEPS``)."""
    return float(np.float32(2.0 ** 29 / (batch * n_steps)))


# ----------------------------------------------------------------------
# Table layout, packing and unpacking
# ----------------------------------------------------------------------

def mg_offsets(cfgs: tuple) -> np.ndarray:
    """Each variant's first table row in a mixture: the variants' code
    blocks concatenated, each rounded up to a multiple of 8
    (gym_soccer_tpu/ops/learner_kernel.py ``spc_mg``)."""
    sizes = [-(-rules.n_cellpairs(c) // VARIANT_ALIGN) * VARIANT_ALIGN
             for c in cfgs]
    return np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def n_codes(cfg) -> int:
    """(cached) Rows of the table and of the accumulators: the compact
    codes of one board, or of a mixture's 8-aligned blocks."""
    if isinstance(cfg, tuple):
        return int(sum(-(-rules.n_cellpairs(c) // VARIANT_ALIGN)
                       * VARIANT_ALIGN for c in cfg))
    return rules.n_cellpairs(cfg)


def n_states(cfg) -> int:
    """Dense states of one board, or of a mixture's variants together."""
    if isinstance(cfg, tuple):
        return int(sum(tables.build_statespace(c).nS for c in cfg))
    return tables.build_statespace(cfg).nS


@functools.lru_cache(maxsize=None)
def _cell_rows(cfg) -> np.ndarray:
    """Table row of each dense state: its compact cellpair code, for a
    mixture shifted by its variant's offset, in variant order."""
    if isinstance(cfg, tuple):
        return np.concatenate([_cell_rows(c) + o
                               for c, o in zip(cfg, mg_offsets(cfg))])
    d2r = tables.build_statespace(cfg).dense_to_raw.astype(np.int64)
    xa, ya, xb, yb, p = rules.raw_decode(np, d2r, cfg)
    return rules.cellpair_encode(np, xa, ya, xb, yb, p, cfg).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _codes(cfg, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_cell_rows(cfg), device=device).long()


def init_state_fields(cfg, batch: int, device="cuda"):
    """Initial state: lane i on ISD entry i % nI, t = 0 (six int32 [batch]
    tensors ra, ca, rb, cb, p, t).

    For a mixture (a tuple of EnvConfigs) returns ``(planes, fields)``:
    lane i plays on variant i * nV // batch (contiguous blocks), its six
    planes are H, W, glo, ghi, q_int and its variant's table row offset,
    and it starts on its board's ISD entry (i // nV) % nI."""
    device = torch.device(device)
    zeros = torch.zeros(batch, dtype=torch.int32, device=device)
    if isinstance(cfg, tuple):
        cfgs = sk.check_variants(cfg)
        geo, start = sk.mg_planes(cfgs, batch, device, layout="blocked")
        offs = torch.as_tensor(mg_offsets(cfgs), device=device)
        planes = (*(g.clone() for g in geo[:5]), offs[geo[5].long()])
        return planes, (*start, zeros)
    return (*sk.isd_spread_fields(cfg, batch, device), zeros)


_FIFTH = float(np.float32(0.2))


def _mix_eps(pi, eps):
    """pi * (1 - eps) + eps / 5, rounded to bfloat16, as the JAX package
    computes it under jit on the CPU: eps in float32, eps / 5 as
    eps * float32(0.2), and one fused multiply-add.  The FMA is formed in
    float64, where the product of two float32 is exact, and rounded once
    to float32 (see agents/learners._fma_dot for the one case where that
    differs from a true FMA).  ``eps`` is a number, or a float32 scalar
    tensor on pi's device (a grouped run's schedule), whose 1 - eps and
    eps * 0.2 are the same float32 operations on the device."""
    if isinstance(eps, torch.Tensor):
        e1, e2 = (1.0 - eps).double(), (eps * _FIFTH).double()
    else:
        e = np.float32(eps)
        e1 = float(np.float32(1.0) - e)
        e2 = float(e * np.float32(0.2))
    mixed = (pi.double() * e1 + e2).float()
    return mixed.to(torch.bfloat16).float()


def _pack(cfg, cols, pi_a, pi_b, v, eps, eps_b):
    if eps_b is None:
        eps_b = eps
    dev = v.device
    codes = _codes(cfg, dev)
    table = torch.zeros((n_codes(cfg), cols), dtype=torch.float32, device=dev)
    table[codes, COL_PI_A:COL_PI_A + N_ACTIONS] = _mix_eps(pi_a, eps)
    table[codes, COL_PI_B:COL_PI_B + N_ACTIONS] = _mix_eps(pi_b, eps_b)
    table[codes, COL_V] = v.float()
    return table, codes


def pack_m2(cfg, pi_a, pi_b, v, eps, eps_b=None) -> torch.Tensor:
    """The packed chunk's table [n_codes, 11] float32 on the tensors'
    device.

    ``pi_a``/``pi_b`` [nS, 5] and ``v`` [nS] are float32 per dense state
    (``cfg`` a mixture: the variants' states concatenated).  Columns 0-4
    hold pi_a mixed with uniform exploration ``eps``, columns 5-9 pi_b
    mixed with ``eps_b`` (default ``eps``), both rounded to bfloat16 like
    the JAX package's packed M; column 10 holds v exactly.  Rows of codes
    that are no dense state stay zero."""
    return _pack(cfg, TABLE_COLS, pi_a, pi_b, v, eps, eps_b)[0]


def pack_m(cfg, pi_a, pi_b, q, v, eps, eps_b=None) -> torch.Tensor:
    """The unpacked chunk's table [n_codes, 36] float32: ``pack_m2``'s
    columns, then q [nS, 5, 5] exactly in columns 11-35 (joint action
    aa * 5 + ab)."""
    table, codes = _pack(cfg, TABLE_COLS_UNPACKED, pi_a, pi_b, v, eps, eps_b)
    table[codes, COL_Q:COL_Q + NJ] = q.float().reshape(-1, NJ)
    return table


def unpack_acc2(cfg, acc):
    """acc = (sums int64, counts int32), each [n_codes, 25] -> dense (sum,
    cnt), each float32 [nS, 5, 5].  For the packed chunks the sums are
    residual sums, and the TD sum of a cell is sum + cnt * (v - q) for the
    chunk's frozen v and q; for the unpacked chunks (``unpack_acc``) they
    are the TD sums."""
    sums, cnt = acc
    codes = _codes(cfg, sums.device)
    nS = codes.shape[0]
    dense = (sums[codes].double() * (1.0 / FIX_SCALE)).float()
    return (dense.reshape(nS, N_ACTIONS, N_ACTIONS),
            cnt[codes].float().reshape(nS, N_ACTIONS, N_ACTIONS))


unpack_acc = unpack_acc2


# ----------------------------------------------------------------------
# One chunk: plain versions and wrappers
# ----------------------------------------------------------------------

def _check_chunk_args(cfg, table, fields, batch: int, n_steps: int,
                      cols: int = TABLE_COLS, n_fields: int = 6, n=None,
                      global_batch=None):
    """The fields as a tuple, once the shapes, types and the one device of
    the table (``n`` rows: by default ``n_codes(cfg)``) and the
    ``n_fields`` fields are checked, and the lane-steps whose sums are
    added together (``global_batch``, by default ``batch``, times
    ``n_steps``) within ``MAX_LANE_STEPS``."""
    if batch <= 0 or batch % LANES:
        raise ValueError(f"batch must be a positive multiple of {LANES}, "
                         f"got {batch}")
    if n_steps <= 0:
        raise ValueError(f"n_steps must be positive, got {n_steps}")
    total = sum_batch(batch, global_batch)
    if total * n_steps > MAX_LANE_STEPS:
        raise ValueError(
            f"batch * n_steps = {total * n_steps} exceeds 2**29: the int64 "
            "fixed-point sums could overflow")
    device = table.device
    shape = (n_codes(cfg) if n is None else n, cols)
    if (table.dtype != torch.float32 or tuple(table.shape) != shape
            or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous float32 {shape} tensor; "
                         f"got {table.dtype} {tuple(table.shape)}")
    return _check_planes("fields", fields, batch, device, n_fields)


def sum_batch(batch: int, global_batch) -> int:
    """The lanes whose sums a chunk's are added to: ``global_batch`` (a
    data-parallel run's whole batch, parallel/mesh), a multiple of the
    chunk's ``batch``, or ``batch`` itself."""
    if global_batch is None:
        return batch
    if global_batch < batch or global_batch % batch:
        raise ValueError(f"global_batch {global_batch} is not a multiple of "
                         f"batch {batch}")
    return int(global_batch)


def _check_planes(what: str, planes, batch: int, device, n: int = 6):
    planes = tuple(planes)
    if len(planes) != n:
        raise ValueError(f"{what} = {n} tensors")
    for f in planes:
        if (f.dtype != torch.int32 or tuple(f.shape) != (batch,)
                or not f.is_contiguous() or f.device != device):
            raise ValueError(
                f"{what} must be contiguous int32 [{batch}] tensors on "
                f"{device}; got {f.dtype} {tuple(f.shape)} on {f.device}")
    return planes


def _sample5(pi, u):
    """First exceedance of u * total over the running sums of the five
    columns of ``pi``, summed in index order (the JAX kernel's sample5)."""
    c = pi.unbind(1)
    total = c[0] + c[1] + c[2] + c[3] + c[4]
    target = u * total
    s = c[0]
    a = (s <= target).to(torch.int32)
    for k in range(2, N_ACTIONS):
        s = s + c[k - 1]
        a += s <= target
    return a


def _retire(sums, cnt, idx, r, cont, v_next, base):
    """Add the values (r + cont * v_next) - base at cells ``idx``."""
    delta = (r + cont * v_next) - base
    fixed = torch.round(delta.double() * FIX_SCALE).long()
    sums.index_add_(0, idx, fixed)
    cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def _out_of_range(x, limit):
    return (~(x.abs() <= limit)).sum()


def _plain(cfg, seed: int, table, fields, n_steps: int, gamma: float,
           packed: bool, planes, total: int):
    ra, ca, rb, cb, p, t = fields
    dev = ra.device
    B = ra.shape[0]
    if planes is None:
        geo, cpo = cfg, 0
    else:
        geo = sk.GeoPlanes(*planes[:5], cfg[0].max_steps)
        cpo = planes[5].long()
    q_int = sk._q_int(geo)
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    sums = torch.zeros(n_codes(cfg) * NJ, dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_codes(cfg) * NJ, dtype=torch.int32, device=dev)
    rew = torch.zeros(B, dtype=torch.int64, device=dev)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    out_of_range = torch.zeros((), dtype=torch.int64, device=dev)
    gamma_f = torch.tensor(np.float32(gamma), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    limit = value_limit(total, n_steps)
    inv = 1.0 / 65536.0   # u16 * 2**-16 is exact in float32

    def cell(ra, ca, rb, cb, p):
        return rules.cellpair_encode(torch, ra, ca, rb, cb, p, geo).long() \
            + cpo

    pend = None
    for i in range(n_steps):
        bits0, bits1, bits2 = (sk._random_word(seed, i, w, lane)
                               for w in range(3))
        cp = cell(ra, ca, rb, cb, p)
        row = table[cp]
        v_here = row[:, COL_V]
        out_of_range += _out_of_range(v_here, limit)
        if pend is not None:   # the previous step, bootstrapped from v_here
            _retire(sums, cnt, *pend[:3], v_here, pend[3])
        aa = _sample5(row[:, COL_PI_A:COL_PI_A + 5],
                      sk._u16(bits0, 0).float() * inv)
        ab = _sample5(row[:, COL_PI_B:COL_PI_B + 5],
                      sk._u16(bits0, 1).float() * inv)
        ra, ca, rb, cb, p, goal, r = sk.transition_core(
            ra, ca, rb, cb, p, aa, ab, bits1, bits2, geo, q_int)
        ra, ca, rb, cb, p, t, trunc = sk.autoreset_core(
            ra, ca, rb, cb, p, t, goal, bits2, geo)
        cont = torch.where(goal | trunc, zero, gamma_f)
        ja = (aa * N_ACTIONS + ab).long()
        if packed:
            base = v_here
        else:
            base = row.gather(1, (COL_Q + ja)[:, None])[:, 0]
            out_of_range += _out_of_range(base, limit)
        pend = (cp * NJ + ja, r.float(), cont, base)
        rew += r
        goals += goal
        truncs += trunc
    v_end = table[cell(ra, ca, rb, cb, p), COL_V]
    out_of_range += _out_of_range(v_end, limit)
    _retire(sums, cnt, *pend[:3], v_end, pend[3])   # the last step
    acc = (sums.reshape(-1, NJ), cnt.reshape(-1, NJ))
    return ((ra, ca, rb, cb, p, t), acc,
            (rew.sum(), goals.sum(), truncs.sum(), out_of_range))


_NAMES = {(True, False): "packed_learner_chunk",
          (True, True): "multigrid_packed_learner_chunk",
          (False, False): "learner_chunk",
          (False, True): "multigrid_learner_chunk"}

# The mixture and the planes the mixture wrappers checked last, with what
# they found: a trainer passes the same ones every chunk.
_seen = {"mixture": None, "planes": None}


def _mixture(cfgs):
    """(the variants as ``check_variants`` returns them, their n_codes).  A
    tuple is remembered by identity: a tuple of frozen EnvConfigs cannot
    change, and holding it keeps its id its own."""
    seen = _seen["mixture"]
    if seen is not None and cfgs is seen[0]:
        return seen[1]
    checked = sk.check_variants(cfgs)
    found = (checked, n_codes(checked))
    if type(cfgs) is tuple:
        _seen["mixture"] = (cfgs, found)
    return found


def _versions(planes):
    """The planes' version counters, which an in-place change (``add_``,
    ``resize_``, ``set_``) moves on; None if a plane keeps none (an
    inference tensor)."""
    if any(p.is_inference() for p in planes):
        return None
    return tuple(p._version for p in planes)


def _mixture_planes(planes, batch: int, device):
    """(the six geometry planes as a tuple, once ``_check_planes`` passes
    them, and their device pointers).  The last planes passed are
    remembered: the same six tensors at the versions they were checked at,
    for the same batch and device, are not checked again (planes without
    version counters are checked every call).  Holding them keeps their
    ids their own."""
    planes = tuple(planes)
    seen = _seen["planes"]
    if (seen is not None and seen[2] == batch and seen[3] == device
            and len(planes) == 6
            and all(a is b for a, b in zip(planes, seen[0]))
            and _versions(planes) == seen[1]):
        return seen[0], seen[4]
    planes = _check_planes("planes", planes, batch, device)
    ptrs = sk.ptr_array(planes)
    versions = _versions(planes)
    if versions is not None:
        _seen["planes"] = (planes, versions, batch, device, ptrs)
    return planes, ptrs


def check_scalars(scalars, n: int, device) -> torch.Tensor:
    """A chunk's scalars given as a tensor (its seed; for K8-K11 the seed,
    eps_int and step offset), checked to be a contiguous int32 [n] tensor
    on ``device``, where the chunk runs.  A kernel reads them from device
    memory when it runs, so a call captured in a CUDA graph takes the
    values the graph has written there."""
    if (not isinstance(scalars, torch.Tensor) or scalars.dtype != torch.int32
            or tuple(scalars.shape) != (n,) or not scalars.is_contiguous()
            or scalars.device != device):
        raise ValueError(f"scalars must be a contiguous int32 [{n}] tensor on "
                         f"{device}")
    return scalars


def _chunk(packed: bool, cfg, seed, table, planes, fields, batch, n_steps,
           gamma, threads, plain: bool, global_batch=None):
    multi = planes is not None
    name = _NAMES[packed, multi]
    if multi:
        cfg, n = _mixture(cfg)
    elif isinstance(cfg, tuple):
        raise ValueError(f"{name} takes one EnvConfig; a mixture runs "
                         f"{_NAMES[packed, True]}")
    else:
        n = n_codes(cfg)
    if not 0.0 <= gamma <= 1.0:
        raise ValueError(f"gamma must lie in [0, 1], got {gamma}")
    fields = _check_chunk_args(
        cfg, table, fields, batch, n_steps,
        TABLE_COLS if packed else TABLE_COLS_UNPACKED, n=n,
        global_batch=global_batch)
    total = sum_batch(batch, global_batch)
    geo_ptrs = None
    if multi:
        planes, geo_ptrs = _mixture_planes(planes, batch, table.device)
    scalars = None
    if isinstance(seed, torch.Tensor):
        scalars = check_scalars(seed, 1, table.device)
        seed = int(scalars[0]) & sk.M32 if plain or not table.is_cuda \
            else 0
    if plain or table.device.type == "cpu":
        return _plain(cfg, seed, table, fields, n_steps, gamma, packed,
                      planes, total)
    return _launch_chunk(name, cfg, n, seed, scalars, table, geo_ptrs, fields,
                         batch, n_steps, gamma, threads, total)


def packed_learner_chunk(cfg: EnvConfig, seed: int, table, fields,
                         batch: int, n_steps: int, gamma: float = 0.99,
                         threads=None, global_batch=None):
    """Run one fused minimax-Q chunk with residual accumulation (kernel
    K5).

    ``table``: float32 [n_codes, 11] from ``pack_m2``; ``fields``: six
    int32 [batch] tensors (ra, ca, rb, cb, p, t), e.g. from
    ``init_state_fields``; both on one device, where the chunk runs.
    ``batch`` is a multiple of 128 and batch * n_steps at most 2**29;
    ``gamma`` lies in [0, 1].  ``seed`` keys the counter PRNG with the
    steps numbered from 0; it may instead be an int32 [1] tensor holding
    it on the chunk's device (``check_scalars``), which the kernel reads
    when it runs.  Returns ``(fields, (sums, cnt), (reward_sum,
    goals, truncs, out_of_range))``: the final state, the int64 residual
    sums (units of 2**-32) and int32 visit counts [n_codes, 25] (decode
    with ``unpack_acc2``), and the int64 totals.  The sums are exact when
    ``out_of_range``, the number of table values read that lie outside
    +-``value_limit(batch, n_steps)`` or are not finite, is 0 (always
    while |v| <= 1); it is counted on the device, so the call does not wait
    for the chunk.  ``threads`` is the kernel's lanes per block: a multiple
    of 32 in [32, 512], by default the fewest that keep the grid to one
    wave of 132 blocks (``learner_codes.check_lanes``: 64 at 8192 lanes, 512
    at 65536; ValueError otherwise, on any device); it does not change the
    result.  On the card the outputs are views of one allocation.
    ``global_batch``: where the sums are added to other chunks' (a
    data-parallel run, parallel/mesh), the lanes of them all, whose
    ``value_limit`` and 2**29 cap apply in place of ``batch``'s.

    On a CPU device this runs ``packed_learner_chunk_plain``; on a CUDA
    device it launches the K5 kernel.
    """
    from . import learner_codes
    threads = learner_codes.check_lanes(batch, threads)
    return _chunk(True, cfg, seed, table, None, fields, batch, n_steps,
                  gamma, threads, plain=False, global_batch=global_batch)


def packed_learner_chunk_plain(cfg: EnvConfig, seed: int, table, fields,
                               batch: int, n_steps: int, gamma: float = 0.99):
    """Plain PyTorch version of ``packed_learner_chunk``, on any device."""
    return _chunk(True, cfg, seed, table, None, fields, batch, n_steps,
                  gamma, None, plain=True)


def multigrid_packed_learner_chunk(cfgs: tuple, seed: int, table, planes,
                                   fields, batch: int, n_steps: int,
                                   gamma: float = 0.99, threads=None,
                                   global_batch=None):
    """``packed_learner_chunk`` over a mixture of boards (kernel K6).

    ``cfgs``: a tuple of 1 to 16 EnvConfigs sharing max_steps; ``table``:
    float32 [n_codes(cfgs), 11] from ``pack_m2(cfgs, ...)``; ``planes`` and
    ``fields``: the six int32 [batch] geometry planes and state fields from
    ``init_state_fields(cfgs, ...)``.  Each lane steps on its own board and
    accumulates into its variant's block.  Returns what
    ``packed_learner_chunk`` returns, the accumulators [n_codes(cfgs), 25].
    ``threads`` is the kernel's lanes per block, as for
    ``packed_learner_chunk`` (by default one wave: 64 at 8192 lanes, 128 at
    16384, 256 at 32768).  A trainer passes the same mixture and planes
    every chunk; they are checked on the first (``_mixture``,
    ``_mixture_planes``).  ``global_batch`` as for
    ``packed_learner_chunk``.

    On a CPU device this runs ``multigrid_packed_learner_chunk_plain``; on
    a CUDA device it launches the K6 kernel (K7 multigrid's split kernel on
    the packed table) after its prep pass.
    """
    from . import learner_codes
    threads = learner_codes.check_lanes(batch, threads)
    return _chunk(True, cfgs, seed, table, planes, fields, batch, n_steps,
                  gamma, threads, plain=False, global_batch=global_batch)


def multigrid_packed_learner_chunk_plain(cfgs: tuple, seed: int, table,
                                         planes, fields, batch: int,
                                         n_steps: int, gamma: float = 0.99):
    """Plain PyTorch version of ``multigrid_packed_learner_chunk``."""
    return _chunk(True, cfgs, seed, table, planes, fields, batch, n_steps,
                  gamma, None, plain=True)


def learner_chunk(cfg: EnvConfig, seed: int, table, fields, batch: int,
                  n_steps: int, gamma: float = 0.99, threads=None,
                  global_batch=None):
    """``packed_learner_chunk`` accumulating the full TD sums
    r + cont * v(s') - q(s, a) (kernel K7; decode with ``unpack_acc``).
    ``table``: float32 [n_codes, 36] from ``pack_m``; the out-of-range
    count covers the q(s, a) read too.  The fields, stats and counts equal
    ``packed_learner_chunk``'s for a table with the same pi columns.
    ``threads`` is the kernel's lanes per block and ``global_batch`` the
    lanes of the summed chunks, as for ``packed_learner_chunk``.

    On a CPU device this runs ``learner_chunk_plain``; on a CUDA device it
    launches the K7 kernel.
    """
    from . import learner_codes
    threads = learner_codes.check_lanes(batch, threads)
    return _chunk(False, cfg, seed, table, None, fields, batch, n_steps,
                  gamma, threads, plain=False, global_batch=global_batch)


def learner_chunk_plain(cfg: EnvConfig, seed: int, table, fields,
                        batch: int, n_steps: int, gamma: float = 0.99):
    """Plain PyTorch version of ``learner_chunk``, on any device."""
    return _chunk(False, cfg, seed, table, None, fields, batch, n_steps,
                  gamma, None, plain=True)


def multigrid_learner_chunk(cfgs: tuple, seed: int, table, planes, fields,
                            batch: int, n_steps: int, gamma: float = 0.99,
                            threads=None, global_batch=None):
    """``learner_chunk`` over a mixture of boards (kernel K7, its
    multigrid call site): ``table`` from ``pack_m(cfgs, ...)``, ``planes``
    and ``fields`` as for ``multigrid_packed_learner_chunk``; ``threads``
    and ``global_batch`` as for ``packed_learner_chunk``.

    On a CPU device this runs ``multigrid_learner_chunk_plain``; on a CUDA
    device it launches the K7 kernel's multigrid instance.
    """
    from . import learner_codes
    threads = learner_codes.check_lanes(batch, threads)
    return _chunk(False, cfgs, seed, table, planes, fields, batch, n_steps,
                  gamma, threads, plain=False, global_batch=global_batch)


def multigrid_learner_chunk_plain(cfgs: tuple, seed: int, table, planes,
                                  fields, batch: int, n_steps: int,
                                  gamma: float = 0.99):
    """Plain PyTorch version of ``multigrid_learner_chunk``."""
    return _chunk(False, cfgs, seed, table, planes, fields, batch, n_steps,
                  gamma, None, plain=True)


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared."""
    from . import _build
    return declare(_build.load("learner_kernel"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``csrc/learner_kernel.cu``."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # params, n_codes, B, T, seed, scalars, gamma, limit, lanes, stream
    tail = [vp, i32, i32, i32, ctypes.c_uint32, vp, f32, f32, i32, vp]
    for fn in (lib.gst_packed_learner_chunk, lib.gst_learner_chunk):
        fn.argtypes = [i32, vp, vp, vp] + tail   # device, in, buf, table
        fn.restype = i32
    # device, in, geo, buf, table
    for fn in (lib.gst_multigrid_packed_learner_chunk,
               lib.gst_multigrid_learner_chunk):
        fn.argtypes = [i32, vp, vp, vp, vp] + tail
        fn.restype = i32
    lib.gst_chunk_layout.argtypes = [i32, i32, vp]
    lib.gst_chunk_layout.restype = None
    lib.gst_chunk_smem_bytes.argtypes = [i32, i32, i32]
    lib.gst_chunk_smem_bytes.restype = i32
    lib.gst_chunk_shape.argtypes = [vp]
    lib.gst_chunk_shape.restype = None
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _entry(name: str, key):
    """(cached per kernel and board) A split chunk's entry point and the
    game description its call passes unchanged: board ``key``'s, or for a
    mixture ({max_steps}) ``key`` the max_steps."""
    params = (sk._game_params(key) if isinstance(key, EnvConfig)
              else (ctypes.c_int32 * 1)(key))
    return getattr(_library(), "gst_" + name), params


def _launch_chunk(name: str, cfg, n: int, seed: int, scalars, table,
                  geo_ptrs, fields, batch: int, n_steps: int, gamma: float,
                  lanes: int, total: int):
    """Launch K5, K6 or K7 (``geo_ptrs``: a mixture's planes, K6 and K7
    multigrid) on ``n`` codes at ``lanes`` lanes per block, with the seed
    ``seed`` or, where ``scalars`` is a tensor, the one it holds, counting
    the values outside ``value_limit(total, n_steps)``.  Its outputs
    (the six planes, the sums, the counts and the stats) and the prep
    pass's rows are one allocation, zeroed where it sums by one memset in
    the launch."""
    from . import learner_codes
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    multi = geo_ptrs is not None
    fn, params = _entry(name, cfg[0].max_steps if multi else cfg)
    lay = learner_codes.layout(n, batch)
    b64 = torch.empty(lay.total // 8, dtype=torch.int64, device=dev)
    in_ptrs = sk.ptr_array(fields)
    geo = (ctypes.addressof(geo_ptrs),) if multi else ()
    rc = fn(dev.index, ctypes.addressof(in_ptrs), *geo, b64.data_ptr(),
            table.data_ptr(), ctypes.addressof(params), n, batch, n_steps,
            seed & sk.M32, None if scalars is None else scalars.data_ptr(),
            _f32(gamma), value_limit(total, n_steps), lanes,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{_library().gst_error_string(rc).decode()} "
                           f"({rc})")
    launch_counts[name] += 1
    b32 = b64.view(torch.int32)
    return (b32.as_strided((6, batch), (batch, 1), lay.fields // 4).unbind(0),
            (b64.as_strided((n, NJ), (NJ, 1), 0),
             b32.as_strided((n, NJ), (NJ, 1), lay.cnt // 4)),
            b64.as_strided((4,), (1,), lay.stats // 8).unbind())


# ----------------------------------------------------------------------
# Chunked trainers
# ----------------------------------------------------------------------

def _f32(x: float) -> float:
    """A host schedule value rounded to float32, as the JAX trainer's
    ``jnp.float32(lr_at(k))``."""
    return float(np.float32(x))


def _float_tensor(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or an array; arrays
    are copied (a JAX array's numpy view is read-only)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _check_seeds(seed: int, start_chunk: int, end_chunk: int) -> None:
    """Refuse a run, before its first chunk, whose chunk seeds seed *
    1_000_003 + k (k in [start_chunk, end_chunk)) do not all fit int32:
    the JAX trainers raise OverflowError for those chunks."""
    if end_chunk <= start_chunk:
        return
    for k in (start_chunk, end_chunk - 1):   # the seed grows with k
        s = seed * 1_000_003 + k
        if not -2 ** 31 <= s < 2 ** 31:
            raise OverflowError(
                f"chunk seed {seed} * 1_000_003 + {k} = {s} does not fit "
                "int32")


def _chunk_seed(seed: int, k: int) -> int:
    """The JAX trainer's int32 chunk seed (``_check_seeds`` has checked that
    it fits), as the uint32 the kernel reads."""
    return (seed * 1_000_003 + k) & sk.M32


def _chunk_fn(cfg, packed: bool, batch: int, chunk_len: int, gamma: float,
              device, mesh=None):
    """(chunk(seed, table, fields) -> chunk result, initial fields): the
    trainer's chunk for one board or a mixture, packed or unpacked.  A
    mixture's planes are rebuilt here, never carried in a resume dict.
    Under ``mesh`` the chunk is the data-parallel one over the global
    ``batch`` (parallel/mesh ``sharded_learner_chunk_fn``), and the fields
    and a mixture's planes are the rank's block of the global batch's: a
    lane's variant and ISD entry follow from its global index."""
    if mesh is not None:
        from ..parallel import mesh as pmesh
        sharded = pmesh.sharded_learner_chunk_fn(cfg, mesh, batch, chunk_len,
                                                 gamma, packed)
        if not isinstance(cfg, tuple):
            return sharded, pmesh.shard_fields(
                init_state_fields(cfg, batch, device), mesh, batch)
        planes, fields = init_state_fields(cfg, batch, device)
        planes = pmesh.shard_fields(planes, mesh, batch)
        return ((lambda seed, m, fields: sharded(seed, m, fields, planes)),
                pmesh.shard_fields(fields, mesh, batch))
    if not isinstance(cfg, tuple):
        fn = packed_learner_chunk if packed else learner_chunk
        return (lambda seed, m, fields:
                fn(cfg, seed, m, fields, batch, chunk_len, gamma),
                init_state_fields(cfg, batch, device))
    planes, fields = init_state_fields(cfg, batch, device)
    fn = multigrid_packed_learner_chunk if packed else multigrid_learner_chunk
    return (lambda seed, m, fields:
            fn(cfg, seed, m, planes, fields, batch, chunk_len, gamma)), fields


def _td_sums(cfg, packed: bool, acc, v_chunk, q):
    """(TD sums, counts) per dense state of a chunk: the unpacked chunk's
    sums as they are, the packed one's residual sums completed with
    cnt * (v - q) for the chunk's frozen v and q."""
    sums, cnt = unpack_acc2(cfg, acc)
    if packed:
        sums = sums + cnt * (v_chunk[:, None, None] - q)
    return sums, cnt


def _trainer_device(device, mesh) -> torch.device:
    """The device a trainer runs on: ``device``, which under a mesh must
    name the mesh's."""
    if mesh is None:
        return torch.device(device)
    from ..parallel import mesh as pmesh
    return pmesh.check_device(mesh, device)


def _raise_out_of_range(out_of_range, batch: int, chunk_len: int, v):
    n = int(out_of_range)   # the run's one read of the device's count
    if n:
        raise ValueError(
            f"{n} table values read left +-{value_limit(batch, chunk_len)}"
            f": the int64 fixed-point sums could overflow (batch * "
            f"chunk_len = {batch * chunk_len}, max|v| up to "
            f"{float(v.abs().max())})")


class _Timing:
    """Optional split of a trainer's time into chunk calls and the work
    between them: CUDA events on the device's stream, or the host clock on
    the CPU.  Fills ``out`` with kernel_ms, between_ms and chunks."""

    def __init__(self, out, device: torch.device):
        self.out, self.cuda, self.marks = out, device.type == "cuda", []

    def mark(self):
        if self.out is None:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def finish(self):
        if self.out is None:
            return
        self.mark()
        if self.cuda:
            torch.cuda.synchronize()
            spans = [a.elapsed_time(b)
                     for a, b in zip(self.marks, self.marks[1:])]
        else:
            spans = [(b - a) * 1e3
                     for a, b in zip(self.marks, self.marks[1:])]
        self.out.update(kernel_ms=sum(spans[0::2]),
                        between_ms=sum(spans[1::2]),
                        chunks=len(self.marks) // 2)


def fused_minimax_train(cfg, batch: int, n_chunks: int,
                        chunk_len: int = 64, lr: float = 0.3,
                        gamma: float = 0.99, eps: float = 0.3,
                        lr_halflife: int = 0, eps_halflife: int = 0,
                        solver_iters: int = 200, seed: int = 0,
                        count_lr_tau: float = 0.0,
                        count_lr_pow: float = 0.85,
                        eps_min: float = 0.0,
                        lr_anneal_start: int = 0,
                        lr_anneal_tau: float = 0.0,
                        lr_anneal_pow: float = 1.0,
                        avg_after: int = 0,
                        avg_q: bool = False,
                        final_solver_iters: int = 0,
                        init: tuple | None = None,
                        start_chunk: int = 0,
                        fields_init: tuple | None = None,
                        return_state: bool = False,
                        device="cuda", timing: dict | None = None,
                        mesh=None, packed: bool | None = None,
                        single_dispatch: bool = False,
                        chunks_per_dispatch: int = 1):
    """Chunked fused minimax-Q training.  Returns (q, v, pi_a, pi_b,
    stats_history), tensors on ``device``; the arguments mean what they
    mean in the JAX package (gym_soccer_tpu/ops/learner_kernel.py
    ``fused_minimax_train``):

    * ``cfg``: one EnvConfig, or a tuple of them: one table concatenated
      over the variants is trained on a mixed batch (lanes in contiguous
      blocks per variant), and the results are per dense state of the
      variants in order (core/multigrid ``build_codec``'s offsets);
    * ``packed`` (default True): the residual layout (K5, or K6 for a
      mixture), whose sums the trainer completes with cnt * (v - q);
      False: the TD layout (K7, at its multigrid site for a mixture), whose
      table carries q.  Both step the
      same trajectories for the same policies;
    * schedules over the chunk index k, computed on the host in float64
      and rounded to float32: lr_k = lr * 0.5**(k * chunk_len /
      lr_halflife) * (1 + max(0, k - lr_anneal_start) / lr_anneal_tau)
      ** -lr_anneal_pow; eps_k = max(eps * 0.5**(k * chunk_len /
      eps_halflife), eps_min); ``count_lr_tau`` > 0 scales lr per cell by
      (1 + n / tau) ** -count_lr_pow over lifetime visit counts n;
    * between chunks: q += lr * sum_td / max(cnt, 1), then RM+ with
      ``solver_iters`` iterations and a repack with eps_k;
    * ``avg_after``: return strategies averaged over chunks >= avg_after
      (``avg_q``: the equilibrium of the averaged Q instead);
      ``final_solver_iters``: re-solve the final Q with more iterations;
    * ``init``: (q, v, pi_a, pi_b) or (q, v, pi_a, pi_b, n) warm start,
      tensors or numpy arrays (a JAX run's, as ``np.asarray``);
    * ``return_state=True`` adds a sixth element, the resume dict (q, v,
      pi_a, pi_b, n, fields, next_chunk, packed) before post-processing;
      ``init``/``fields_init``/``start_chunk`` from it, under the same
      ``packed``, continue bit for bit like an uninterrupted run (a
      mixture's planes are rebuilt, not resumed).  Averaging windows
      restart on resume.
    * ``stats_history`` holds (reward_sum, goals, truncs) of every 16th
      chunk and of the last in the per-chunk mode, of every chunk in the
      grouped modes (the JAX package's cadences);
    * ``chunks_per_dispatch`` = g > 1: the grouped mode, g chunks and the
      work after each as one CUDA-graph replay on the card (ops/dispatch);
      ``single_dispatch``: the same in segments of
      ``dispatch.SINGLE_DISPATCH_CHUNKS`` (no host round trip between
      chunks).  Their schedules are the per-chunk mode's host values, read
      from a table on the device, so every mode gives the same q, v, pi, n
      and fields bit for bit, and exact resume holds in each (the JAX
      package computes its grouped schedules in float32 in the graph:
      eps within an ulp of these, lr within a few).
    * ``mesh`` (parallel/mesh ``env_mesh``): data-parallel training over
      the global ``batch`` (a multiple of the world size, 128 lanes a rank
      at least): each rank runs its block of the lanes with its shard seed
      (``sharded_learner_chunk_fn``), the sums, counts and stats are
      all-reduced, and every rank re-solves every game with R1, so every
      rank holds the same tables, equal bit for bit to the sum of the
      ranks' chunks; ``device`` must name the mesh's.  (JAX shards the
      re-solve by state.  On H100s over NCCL the port's
      ``sharded_solve_fn``, bit-equal, was slower than the replicated
      solve at 761 and 2502 games on 2 and 4 cards and at 11705 games on
      4, and faster only at 11705 games on 2: tools/bench_scaling.py
      ``--solve-split``.)  ``fields_init`` and the resume dict's fields
      are the rank's block; the grouped modes need a mesh a CUDA graph can
      capture (NCCL on the card; ``dispatch.run`` refuses gloo there).

    On a CUDA device every chunk launches K5, K6 or K7 and every re-solve
    R1, and no chunk waits for the one before: the chunks' out-of-range
    counts (see ``packed_learner_chunk``) are summed on the device and read
    once, at the end, and a run in which a table value left the int64
    sums' exact range raises ValueError.  ``timing``, if a dict, is filled
    with the time spent in chunk calls and between them (the per-chunk
    mode), or with ``dispatch.run``'s capture, replay and remainder times.
    """
    g = dispatch.group_size(n_chunks, single_dispatch, chunks_per_dispatch)
    _check_seeds(seed, start_chunk, start_chunk + n_chunks)
    packed = True if packed is None else bool(packed)
    device = _trainer_device(device, mesh)
    nS = n_states(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    n = torch.zeros((nS, N_ACTIONS, N_ACTIONS), **f32)
    if init is None:
        q = torch.zeros((nS, N_ACTIONS, N_ACTIONS), **f32)
        v = torch.zeros(nS, **f32)
        pi_a = torch.full((nS, N_ACTIONS), 0.2, **f32)
        pi_b = torch.full((nS, N_ACTIONS), 0.2, **f32)
    else:
        init = list(init)
        if len(init) == 5:
            n = _float_tensor(init.pop(), device)
        q, v, pi_a, pi_b = (_float_tensor(x, device) for x in init)
        if tuple(q.shape) != (nS, 5, 5) or tuple(v.shape) != (nS,):
            raise ValueError(f"init q must be [{nS}, 5, 5] and v [{nS}]")
    chunk, fields = _chunk_fn(cfg, packed, batch, chunk_len, gamma, device,
                              mesh)
    if fields_init is not None:
        fields = tuple(torch.as_tensor(f, dtype=torch.int32, device=device)
                       for f in fields_init)
    def solve(q):
        return solve_matrix_games(q, iters=solver_iters)

    def repack(pa, pb, q, v, eps_now):
        return (pack_m2(cfg, pa, pb, v, eps_now) if packed
                else pack_m(cfg, pa, pb, q, v, eps_now))

    def between(q, n, v_chunk, acc, lr_now, eps_now):
        """Count-normalised Q update, RM+ re-solve and repack.  ``v_chunk``
        is the v packed into the chunk's table (the residuals' baseline)."""
        sum_td, cnt = _td_sums(cfg, packed, acc, v_chunk, q)
        n = n + cnt
        lr_cell = lr_now
        if count_lr_tau > 0:
            lr_cell = lr_now * (1.0 + n / count_lr_tau) ** (-count_lr_pow)
        q = q + lr_cell * sum_td / cnt.clamp_min(1.0)
        v, pa, pb = solve(q)
        return q, n, v, pa, pb, repack(pa, pb, q, v, eps_now)

    def decay(base, hl, k, floor=0.0):
        return max(base * (0.5 ** (k * chunk_len / hl) if hl else 1.0), floor)

    def lr_at(k):
        d = decay(lr, lr_halflife, k)
        if lr_anneal_tau > 0:
            over = max(k - lr_anneal_start, 0)
            d = d * (1.0 + over / lr_anneal_tau) ** (-lr_anneal_pow)
        return d

    # On resume, chunk start_chunk sees the table the continuous run packed
    # after chunk start_chunk - 1, with that chunk's epsilon.
    eps0 = eps if start_chunk == 0 else decay(eps, eps_halflife,
                                              start_chunk - 1, eps_min)
    m = repack(pi_a, pi_b, q, v, eps0)
    end_chunk = start_chunk + n_chunks
    pa_sum = pb_sum = q_sum = None
    if g is not None:
        ks = range(start_chunk, end_chunk)
        sched = dispatch.Schedule(
            [(_f32(lr_at(k)), _f32(decay(eps, eps_halflife, k, eps_min)),
              float(bool(avg_after) and k >= avg_after)) for k in ks],
            [(seed * 1_000_003 + k,) for k in ks], device)
        # copies: the bodies overwrite them, not the caller's init tensors
        carry = [t.clone() for t in (*fields, q, n, v, pi_a, pi_b, m)]
        if avg_after:
            carry += [torch.zeros_like(pi_a), torch.zeros_like(pi_b),
                      torch.zeros_like(q)]
        *fields, q, n, v, pi_a, pi_b, m = carry[:len(fields) + 6]
        fields = tuple(fields)
        if avg_after:
            pa_sum, pb_sum, q_sum = carry[-3:]

        def body():
            lr_eps_w, ints = sched.row()
            new_fields, acc, stats = chunk(ints, m, fields)
            new = between(q, n, v, acc, lr_eps_w[0], lr_eps_w[1])
            for dst, src in zip((*fields, q, n, v, pi_a, pi_b, m),
                                (*new_fields, *new)):
                dst.copy_(src)
            if avg_after:
                w = lr_eps_w[2]
                pa_sum.add_(w * new[3])
                pb_sum.add_(w * new[4])
                if avg_q:
                    q_sum.add_(w * new[0])
            sched.record(stats)

        dispatch.run(body, carry + sched.state(), n_chunks, g,
                     (launch_counts, learners.launch_counts), timing,
                     mesh=mesh)
        history, out_of_range = sched.history()
    else:
        history = []
        out_of_range = 0
        clock = _Timing(timing, device)
        for k in range(start_chunk, end_chunk):
            clock.mark()
            fields, acc, stats = chunk(_chunk_seed(seed, k), m, fields)
            clock.mark()
            q, n, v, pi_a, pi_b, m = between(
                q, n, v, acc, _f32(lr_at(k)),
                _f32(decay(eps, eps_halflife, k, eps_min)))
            out_of_range = out_of_range + stats[3]
            if avg_after and k >= avg_after:
                pa_sum = pi_a if pa_sum is None else pa_sum + pi_a
                pb_sum = pi_b if pb_sum is None else pb_sum + pi_b
                if avg_q:
                    q_sum = q if q_sum is None else q_sum + q
            if k % 16 == 0 or k == end_chunk - 1:
                history.append(stats[:3])
        clock.finish()
        history = [tuple(int(x) for x in row) for row in history]
    _raise_out_of_range(out_of_range, batch, chunk_len, v)
    resume = {"q": q, "v": v, "pi_a": pi_a, "pi_b": pi_b, "n": n,
              "fields": fields, "next_chunk": end_chunk, "packed": packed}
    averaged = bool(avg_after) and end_chunk - 1 >= avg_after
    if averaged and avg_q:
        W = end_chunk - max(avg_after, start_chunk)
        v, pi_a, pi_b = solve_matrix_games(
            q_sum / W, iters=final_solver_iters or solver_iters)
    elif averaged:
        pi_a = pa_sum / pa_sum.sum(-1, keepdim=True)
        pi_b = pb_sum / pb_sum.sum(-1, keepdim=True)
    if final_solver_iters and not averaged:
        v, pi_a, pi_b = solve_matrix_games(q, iters=final_solver_iters)
    if return_state:
        return q, v, pi_a, pi_b, history, resume
    return q, v, pi_a, pi_b, history


def fused_best_response_train(cfg: EnvConfig, opp_policy, side: str,
                              batch: int, n_chunks: int,
                              chunk_len: int = 64, lr: float = 1.0,
                              gamma: float = 0.99, eps: float = 0.3,
                              eps_halflife: int = 0, eps_min: float = 0.05,
                              lr_anneal_start: int = 0,
                              lr_anneal_tau: float = 0.0,
                              lr_anneal_pow: float = 1.0,
                              seed: int = 0, init: tuple | None = None,
                              start_chunk: int = 0,
                              fields_init: tuple | None = None,
                              return_state: bool = False,
                              device="cuda", mesh=None,
                              packed: bool | None = None,
                              chunks_per_dispatch: int = 1,
                              timing: dict | None = None):
    """Fused single-agent training: the best response of ``side``
    ('player_a' or 'player_b') to a frozen deterministic opponent
    ``opp_policy`` (int [nS]), with the same chunks as
    ``fused_minimax_train`` (K5, or K7 with ``packed=False``).  The frozen
    side's table columns hold its one-hot policy with no exploration; the
    learner's hold its greedy policy mixed with eps_k; between chunks the
    game solve is replaced by the best-response backup (v = max over A's
    actions of q[s, a, opp(s)], or min over B's of q[s, opp(s), b]; q and
    v stay in A's reward perspective).

    Returns (q, v, pi_a, pi_b, history); ``init`` is (q,) or (q, n); with
    ``return_state=True`` a sixth element is the resume dict (q, n, fields,
    next_chunk, packed), from which ``init``/``fields_init``/
    ``start_chunk`` continue bit for bit.  As in the JAX package, one
    board only.  A run in which a table value left the int64 sums' exact
    range raises ValueError, and ``chunks_per_dispatch`` runs the grouped
    mode, ``timing`` splits the time and ``mesh`` trains data-parallel, as
    in ``fused_minimax_train``."""
    g = dispatch.group_size(n_chunks, False, chunks_per_dispatch)
    _check_seeds(seed, start_chunk, start_chunk + n_chunks)
    if isinstance(cfg, tuple):
        raise ValueError("fused_best_response_train takes one EnvConfig")
    if side not in ("player_a", "player_b"):
        raise ValueError(f"side must be 'player_a' or 'player_b', got {side!r}")
    packed = True if packed is None else bool(packed)
    device = _trainer_device(device, mesh)
    nS = tables.build_statespace(cfg).nS
    f32 = dict(dtype=torch.float32, device=device)
    opp = torch.as_tensor(np.asarray(opp_policy), device=device).long()
    if tuple(opp.shape) != (nS,):
        raise ValueError(f"opp_policy must be dense [{nS}]")
    opp_oh = torch.nn.functional.one_hot(opp, N_ACTIONS).float()
    learn_a = side == "player_a"

    q = torch.zeros((nS, N_ACTIONS, N_ACTIONS), **f32)
    n = torch.zeros((nS, N_ACTIONS, N_ACTIONS), **f32)
    if init is not None:
        q = _float_tensor(init[0], device)
        if len(init) > 1:
            n = _float_tensor(init[1], device)
    chunk, fields = _chunk_fn(cfg, packed, batch, chunk_len, gamma, device,
                              mesh)
    if fields_init is not None:
        fields = tuple(torch.as_tensor(f, dtype=torch.int32, device=device)
                       for f in fields_init)

    def repack(pa, pb, q, v, ea, eb):
        return (pack_m2(cfg, pa, pb, v, ea, eps_b=eb) if packed
                else pack_m(cfg, pa, pb, q, v, ea, eps_b=eb))

    def between(q, n, v_chunk, acc, lr_now, eps_now):
        sum_td, cnt = _td_sums(cfg, packed, acc, v_chunk, q)
        n = n + cnt
        q = q + lr_now * sum_td / cnt.clamp_min(1.0)
        if learn_a:
            q_eff = q.gather(2, opp[:, None, None].expand(nS, N_ACTIONS, 1))
            q_eff = q_eff[..., 0]                        # [nS, 5] over a
            v = q_eff.max(-1).values
            pi_l = torch.nn.functional.one_hot(q_eff.argmax(-1),
                                               N_ACTIONS).float()
            pa, pb = pi_l, opp_oh
            m = repack(pa, pb, q, v, eps_now, 0.0)
        else:
            q_eff = q.gather(1, opp[:, None, None].expand(nS, 1, N_ACTIONS))
            q_eff = q_eff[:, 0, :]                       # [nS, 5] over b
            v = q_eff.min(-1).values
            pi_l = torch.nn.functional.one_hot(q_eff.argmin(-1),
                                               N_ACTIONS).float()
            pa, pb = opp_oh, pi_l
            m = repack(pa, pb, q, v, 0.0, eps_now)
        return q, n, v, pa, pb, m

    def eps_at(k):
        d = eps * (0.5 ** (k * chunk_len / eps_halflife)
                   if eps_halflife else 1.0)
        return max(d, eps_min)

    def lr_at(k):
        d = lr
        if lr_anneal_tau > 0:
            over = max(k - lr_anneal_start, 0)
            d = d * (1.0 + over / lr_anneal_tau) ** (-lr_anneal_pow)
        return d

    end_chunk = start_chunk + n_chunks
    if start_chunk == 0:
        uni = torch.full((nS, N_ACTIONS), 0.2, **f32)
        pi_a, pi_b = (uni, opp_oh) if learn_a else (opp_oh, uni)
        ea0, eb0 = (eps, 0.0) if learn_a else (0.0, eps)
        v = torch.zeros(nS, **f32)
        m = repack(pi_a, pi_b, q, v, ea0, eb0)
    else:
        # Rebuild what the continuous run packed after chunk start_chunk-1:
        # greedy pi and v are functions of q, repacked with that chunk's
        # eps by a `between` with empty accumulators and lr 0.
        empty = (torch.zeros((n_codes(cfg), NJ), dtype=torch.int64,
                             device=device),
                 torch.zeros((n_codes(cfg), NJ), dtype=torch.int32,
                             device=device))
        q, n, v, pi_a, pi_b, m = between(
            q, n, torch.zeros(nS, **f32), empty, 0.0,
            _f32(eps_at(start_chunk - 1)))
    if g is not None:
        ks = range(start_chunk, end_chunk)
        sched = dispatch.Schedule(
            [(_f32(lr_at(k)), _f32(eps_at(k))) for k in ks],
            [(seed * 1_000_003 + k,) for k in ks], device)
        carry = [t.clone() for t in (*fields, q, n, v, pi_a, pi_b, m)]
        *fields, q, n, v, pi_a, pi_b, m = carry
        fields = tuple(fields)

        def body():
            lr_eps, ints = sched.row()
            new_fields, acc, stats = chunk(ints, m, fields)
            new = between(q, n, v, acc, lr_eps[0], lr_eps[1])
            for dst, src in zip((*fields, q, n, v, pi_a, pi_b, m),
                                (*new_fields, *new)):
                dst.copy_(src)
            sched.record(stats)

        dispatch.run(body, carry + sched.state(), n_chunks, g,
                     (launch_counts,), timing, mesh=mesh)
        history, out_of_range = sched.history()
    else:
        history = []
        out_of_range = 0
        clock = _Timing(timing, device)
        for k in range(start_chunk, end_chunk):
            clock.mark()
            fields, acc, stats = chunk(_chunk_seed(seed, k), m, fields)
            clock.mark()
            q, n, v, pi_a, pi_b, m = between(q, n, v, acc, _f32(lr_at(k)),
                                             _f32(eps_at(k)))
            out_of_range = out_of_range + stats[3]
            if k % 16 == 0 or k == end_chunk - 1:
                history.append(stats[:3])
        clock.finish()
        history = [tuple(int(x) for x in row) for row in history]
    _raise_out_of_range(out_of_range, batch, chunk_len, v)
    if return_state:
        return q, v, pi_a, pi_b, history, {
            "q": q, "n": n, "fields": fields, "next_chunk": end_chunk,
            "packed": packed}
    return q, v, pi_a, pi_b, history
