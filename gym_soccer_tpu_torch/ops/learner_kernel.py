"""Fused minimax-Q training: CUDA kernel K5, its plain version, and the
chunked trainers.

The port of gym_soccer_tpu/ops/learner_kernel.py's packed path.
``packed_learner_chunk`` runs one act -> step -> TD chunk for ``batch``
lanes and ``n_steps`` steps against a table that stays frozen for the
chunk: each lane samples both players' actions from the exploration-mixed
policies of its state, steps the game (ops/step_kernel's transition and
autoreset, the same counter PRNG), and accumulates per (state, joint
action) the visit count and the Bellman residual r + gamma * v(s') - v(s).
Between chunks, ``fused_minimax_train`` turns the residual sums into TD
sums (adding cnt * (v - q), constant within a chunk), applies the
count-normalised Q update, re-solves every state's 5x5 matrix game by RM+
(agents/learners) and repacks the table.  ``fused_best_response_train``
runs the same chunk against a frozen opponent.

The table is indexed by the compact cellpair code (core/rules
``cellpair_encode``): float32 [n_codes, 11] holding pi_a (5), pi_b (5) and
v.  The pi values are the JAX package's: exploration-mixed in float32 and
rounded to bfloat16 (``pack_m2``), so that both packages sample the same
actions; v is kept exact.  The accumulators are int64 residual sums in
units of 2**-32 and int32 counts, [n_codes, 25] each, exact in any order
of addition; ``unpack_acc2`` converts them to float32 per dense state.

A wrapper runs the plain PyTorch version (``packed_learner_chunk_plain``)
when its tensors lie on the CPU and launches K5 (``csrc/learner_kernel.cu``)
when they lie on a CUDA device; there is no fallback from one to the other.
The chunk wrappers take their device from their tensors; the functions
that make their own tensors (the trainers, ``init_state_fields``) default
to "cuda": CPU callers pass "cpu".

Not ported yet: the mixed-geometry trainer (a tuple of configs, kernel K6),
the unpacked layout (``packed=False``, kernel K7), data parallelism
(``mesh``) and the grouped dispatch modes (``single_dispatch``,
``chunks_per_dispatch``); the trainers raise NotImplementedError for them.
"""
from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from ..agents.learners import solve_matrix_games
from ..config import N_ACTIONS, EnvConfig
from ..core import rules, tables
from . import step_kernel as sk

LANES = 128                 # batch granularity (the JAX wrapper's lane tile)
NJ = N_ACTIONS * N_ACTIONS  # 25 joint actions
TABLE_COLS = 11             # pi_a[5], pi_b[5], v
COL_PI_A, COL_PI_B, COL_V = 0, 5, 10
FIX_SCALE = 2.0 ** 32       # residual sums count units of 2**-32
# |residual| <= 1 + 2 * max|v| <= 3 for values in [-1, 1]: int64 sums stay
# exact while batch * n_steps * 3 * 2**32 < 2**63, i.e. below ~2**29.4.
MAX_LANE_STEPS = 2 ** 29

# Launches of the CUDA kernel in this process, counted by the wrapper
# where it launches and nowhere else.
launch_counts = {"packed_learner_chunk": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------------------
# Table layout, packing and unpacking
# ----------------------------------------------------------------------

def n_codes(cfg: EnvConfig) -> int:
    """Rows of the table and of the accumulators: the compact codes."""
    return rules.n_cellpairs(cfg)


@functools.lru_cache(maxsize=None)
def _cell_rows(cfg: EnvConfig) -> np.ndarray:
    """Compact cellpair code of each dense state (dense row -> table row)."""
    d2r = tables.build_statespace(cfg).dense_to_raw.astype(np.int64)
    xa, ya, xb, yb, p = rules.raw_decode(np, d2r, cfg)
    return rules.cellpair_encode(np, xa, ya, xb, yb, p, cfg).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _codes(cfg: EnvConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_cell_rows(cfg), device=device).long()


def init_state_fields(cfg: EnvConfig, batch: int, device="cuda"):
    """Initial state: lane i on ISD entry i % nI, t = 0 (six int32 [batch]
    tensors ra, ca, rb, cb, p, t)."""
    device = torch.device(device)
    return (*sk.isd_spread_fields(cfg, batch, device),
            torch.zeros(batch, dtype=torch.int32, device=device))


def _mix_eps(pi, eps):
    """pi * (1 - eps) + eps / 5, rounded to bfloat16, as the JAX package
    computes it under jit on the CPU: eps in float32, eps / 5 as
    eps * float32(0.2), and one fused multiply-add.  The FMA is formed in
    float64, where the product of two float32 is exact, and rounded once
    to float32 (see agents/learners._fma_dot for the one case where that
    differs from a true FMA)."""
    e = np.float32(eps)
    e1 = float(np.float32(1.0) - e)
    e2 = float(e * np.float32(0.2))
    mixed = (pi.double() * e1 + e2).float()
    return mixed.to(torch.bfloat16).float()


def pack_m2(cfg: EnvConfig, pi_a, pi_b, v, eps, eps_b=None) -> torch.Tensor:
    """The chunk's table [n_codes, 11] float32 on the tensors' device.

    ``pi_a``/``pi_b`` [nS, 5] and ``v`` [nS] are float32 per dense state.
    Columns 0-4 hold pi_a mixed with uniform exploration ``eps``, columns
    5-9 pi_b mixed with ``eps_b`` (default ``eps``), both rounded to
    bfloat16 like the JAX package's packed M; column 10 holds v exactly.
    Rows of codes that are no dense state stay zero."""
    if eps_b is None:
        eps_b = eps
    dev = v.device
    codes = _codes(cfg, dev)
    table = torch.zeros((n_codes(cfg), TABLE_COLS), dtype=torch.float32,
                        device=dev)
    table[codes, COL_PI_A:COL_PI_A + N_ACTIONS] = _mix_eps(pi_a, eps)
    table[codes, COL_PI_B:COL_PI_B + N_ACTIONS] = _mix_eps(pi_b, eps_b)
    table[codes, COL_V] = v.float()
    return table


def unpack_acc2(cfg: EnvConfig, acc):
    """acc = (residual sums int64, counts int32), each [n_codes, 25] ->
    dense (sum_residual, cnt), each float32 [nS, 5, 5].  The TD sum of a
    cell is sum_residual + cnt * (v - q) for the chunk's frozen v and q."""
    res, cnt = acc
    codes = _codes(cfg, res.device)
    nS = codes.shape[0]
    sum_res = (res[codes].double() * (1.0 / FIX_SCALE)).float()
    return (sum_res.reshape(nS, N_ACTIONS, N_ACTIONS),
            cnt[codes].float().reshape(nS, N_ACTIONS, N_ACTIONS))


# ----------------------------------------------------------------------
# One chunk: plain version and wrapper
# ----------------------------------------------------------------------

def _check_chunk_args(cfg: EnvConfig, table, fields, batch: int,
                      n_steps: int, cols: int = TABLE_COLS):
    """The fields as a tuple, once the shapes, types and the one device of
    the table and the fields are checked."""
    if batch <= 0 or batch % LANES:
        raise ValueError(f"batch must be a positive multiple of {LANES}, "
                         f"got {batch}")
    if n_steps <= 0:
        raise ValueError(f"n_steps must be positive, got {n_steps}")
    if batch * n_steps > MAX_LANE_STEPS:
        raise ValueError(
            f"batch * n_steps = {batch * n_steps} exceeds 2**29: the int64 "
            "fixed-point residual sums could overflow")
    device = table.device
    shape = (n_codes(cfg), cols)
    if (table.dtype != torch.float32 or tuple(table.shape) != shape
            or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous float32 {shape} tensor; "
                         f"got {table.dtype} {tuple(table.shape)}")
    fields = tuple(fields)
    if len(fields) != 6:
        raise ValueError("fields = 6 tensors (ra, ca, rb, cb, p, t)")
    for f in fields:
        if (f.dtype != torch.int32 or tuple(f.shape) != (batch,)
                or not f.is_contiguous() or f.device != device):
            raise ValueError(
                f"fields must be contiguous int32 [{batch}] tensors on "
                f"{device}; got {f.dtype} {tuple(f.shape)} on {f.device}")
    return fields


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


def _retire(res, cnt, idx, r, cont, v_next, v_prev):
    """Add the residuals (r + cont * v_next) - v_prev at cells ``idx``."""
    delta = (r + cont * v_next) - v_prev
    fixed = torch.round(delta.double() * FIX_SCALE).long()
    res.index_add_(0, idx, fixed)
    cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def _plain(cfg: EnvConfig, seed: int, table, fields, n_steps: int,
           gamma: float):
    ra, ca, rb, cb, p, t = fields
    dev = ra.device
    B = ra.shape[0]
    q_int = sk._q_int(cfg)
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    res = torch.zeros(n_codes(cfg) * NJ, dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_codes(cfg) * NJ, dtype=torch.int32, device=dev)
    rew = torch.zeros(B, dtype=torch.int64, device=dev)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    gamma_f = torch.tensor(np.float32(gamma), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inv = 1.0 / 65536.0   # u16 * 2**-16 is exact in float32
    pend = None
    for i in range(n_steps):
        bits0, bits1, bits2 = (sk._random_word(seed, i, w, lane)
                               for w in range(3))
        cp = rules.cellpair_encode(torch, ra, ca, rb, cb, p, cfg).long()
        row = table[cp]
        v_here = row[:, COL_V]
        if pend is not None:   # the previous step, bootstrapped from v_here
            idx, r, cont, v_prev = pend
            _retire(res, cnt, idx, r, cont, v_here, v_prev)
        aa = _sample5(row[:, COL_PI_A:COL_PI_A + 5],
                      sk._u16(bits0, 0).float() * inv)
        ab = _sample5(row[:, COL_PI_B:COL_PI_B + 5],
                      sk._u16(bits0, 1).float() * inv)
        ra, ca, rb, cb, p, goal, r = sk.transition_core(
            ra, ca, rb, cb, p, aa, ab, bits1, bits2, cfg, q_int)
        ra, ca, rb, cb, p, t, trunc = sk.autoreset_core(
            ra, ca, rb, cb, p, t, goal, bits2, cfg)
        cont = torch.where(goal | trunc, zero, gamma_f)
        pend = (cp * NJ + aa * N_ACTIONS + ab, r.float(), cont, v_here)
        rew += r
        goals += goal
        truncs += trunc
    cp = rules.cellpair_encode(torch, ra, ca, rb, cb, p, cfg).long()
    idx, r, cont, v_prev = pend   # the last step, against the final state
    _retire(res, cnt, idx, r, cont, table[cp, COL_V], v_prev)
    acc = (res.reshape(-1, NJ), cnt.reshape(-1, NJ))
    return (ra, ca, rb, cb, p, t), acc, (rew.sum(), goals.sum(), truncs.sum())


def packed_learner_chunk_plain(cfg: EnvConfig, seed: int, table, fields,
                               batch: int, n_steps: int, gamma: float = 0.99):
    """Plain PyTorch version of ``packed_learner_chunk``, on any device."""
    fields = _check_chunk_args(cfg, table, fields, batch, n_steps)
    return _plain(cfg, seed, table, fields, n_steps, gamma)


def packed_learner_chunk(cfg: EnvConfig, seed: int, table, fields,
                         batch: int, n_steps: int, gamma: float = 0.99,
                         threads: int = 128):
    """Run one fused minimax-Q chunk.

    ``table``: float32 [n_codes, 11] from ``pack_m2``; ``fields``: six
    int32 [batch] tensors (ra, ca, rb, cb, p, t), e.g. from
    ``init_state_fields``; both on one device, where the chunk runs.
    ``batch`` is a multiple of 128 and batch * n_steps at most 2**29.
    ``seed`` keys the counter PRNG with the steps numbered from 0.  Returns ``(fields, (res, cnt),
    (reward_sum, goals, truncs))``: the final state, the int64 residual
    sums (units of 2**-32) and int32 visit counts [n_codes, 25] (decode
    with ``unpack_acc2``), and the int64 totals.  ``threads`` is the CUDA
    block size (a multiple of 32); it does not change the result.

    On a CPU device this runs ``packed_learner_chunk_plain``; on a CUDA
    device it launches the K5 kernel.
    """
    fields = _check_chunk_args(cfg, table, fields, batch, n_steps)
    if table.device.type == "cpu":
        return _plain(cfg, seed, table, fields, n_steps, gamma)
    return _launch(cfg, seed, table, fields, n_steps, gamma, threads)


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signature declared."""
    from . import _build
    lib = _build.load("learner_kernel")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gst_packed_learner_chunk.argtypes = [
        i32, vp, vp, vp, vp, vp, vp,   # device, in, out, table, res, cnt, stats
        vp, i32, i32, ctypes.c_uint32, ctypes.c_float, i32, vp]
    #    params, B, T, seed, gamma, threads, stream
    lib.gst_packed_learner_chunk.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


def _launch(cfg: EnvConfig, seed: int, table, fields, n_steps: int,
            gamma: float, threads: int):
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"packed_learner_chunk: no kernel for device {dev}")
    if threads <= 0 or threads > 1024 or threads % 32:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    lib = _library()
    B = fields[0].shape[0]
    out = tuple(torch.empty_like(f) for f in fields)
    res = torch.zeros((n_codes(cfg), NJ), dtype=torch.int64, device=dev)
    cnt = torch.zeros((n_codes(cfg), NJ), dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    in_ptrs = (ctypes.c_void_p * 6)(*(f.data_ptr() for f in fields))
    out_ptrs = (ctypes.c_void_p * 6)(*(f.data_ptr() for f in out))
    params = sk._game_params(cfg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gst_packed_learner_chunk(
        dev.index, ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
        table.data_ptr(), res.data_ptr(), cnt.data_ptr(), stats.data_ptr(),
        ctypes.addressof(params), B, n_steps, seed & sk.M32,
        float(np.float32(gamma)), threads, stream)
    if rc:
        raise RuntimeError(f"packed_learner_chunk: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    launch_counts["packed_learner_chunk"] += 1
    return out, (res, cnt), tuple(stats.unbind())


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


def _chunk_seed(seed: int, k: int) -> int:
    """The JAX trainer's int32 chunk seed, as the uint32 the kernel reads."""
    return (seed * 1_000_003 + k) & sk.M32


def _unsupported(cfg, mesh, packed, single_dispatch, chunks_per_dispatch):
    if isinstance(cfg, tuple):
        raise NotImplementedError(
            "a tuple of configs (mixed-geometry training, kernel K6) is not "
            "ported yet")
    if packed is False:
        raise NotImplementedError(
            "packed=False (the unpacked layout, kernel K7) is not ported yet")
    if mesh is not None:
        raise NotImplementedError(
            "mesh (data-parallel training) is not ported yet")
    if single_dispatch or chunks_per_dispatch != 1:
        raise NotImplementedError(
            "single_dispatch / chunks_per_dispatch are not ported yet; the "
            "port runs one chunk per dispatch")


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


def fused_minimax_train(cfg: EnvConfig, batch: int, n_chunks: int,
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
    stats_history), tensors on ``device``, in the JAX package's per-chunk
    dispatch mode; the arguments mean what they mean there
    (gym_soccer_tpu/ops/learner_kernel.py ``fused_minimax_train``):

    * schedules over the chunk index k, computed on the host in float64
      and rounded to float32: lr_k = lr * 0.5**(k * chunk_len /
      lr_halflife) * (1 + max(0, k - lr_anneal_start) / lr_anneal_tau)
      ** -lr_anneal_pow; eps_k = max(eps * 0.5**(k * chunk_len /
      eps_halflife), eps_min); ``count_lr_tau`` > 0 scales lr per cell by
      (1 + n / tau) ** -count_lr_pow over lifetime visit counts n;
    * between chunks: q += lr * (sum_residual + cnt * (v - q)) /
      max(cnt, 1), then RM+ with ``solver_iters`` iterations and a repack
      with eps_k;
    * ``avg_after``: return strategies averaged over chunks >= avg_after
      (``avg_q``: the equilibrium of the averaged Q instead);
      ``final_solver_iters``: re-solve the final Q with more iterations;
    * ``init``: (q, v, pi_a, pi_b) or (q, v, pi_a, pi_b, n) warm start,
      tensors or numpy arrays (a JAX run's, as ``np.asarray``);
    * ``return_state=True`` adds a sixth element, the resume dict (q, v,
      pi_a, pi_b, n, fields, next_chunk, packed) before post-processing;
      ``init``/``fields_init``/``start_chunk`` from it continue bit for bit
      like an uninterrupted run.  Averaging windows restart on resume.
    * ``stats_history`` holds (reward_sum, goals, truncs) of every 16th
      chunk and of the last.

    On a CUDA device every chunk launches K5.  ``timing``, if a dict, is
    filled with the time spent in chunk calls and between them.
    """
    _unsupported(cfg, mesh, packed, single_dispatch, chunks_per_dispatch)
    device = torch.device(device)
    nS = tables.build_statespace(cfg).nS
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
    if fields_init is None:
        fields = init_state_fields(cfg, batch, device)
    else:
        fields = tuple(torch.as_tensor(f, dtype=torch.int32, device=device)
                       for f in fields_init)

    def between(q, n, v_chunk, acc, lr_now, eps_now):
        """Count-normalised Q update, RM+ re-solve and repack.  ``v_chunk``
        is the v packed into the chunk's table (the residuals' baseline)."""
        sum_res, cnt = unpack_acc2(cfg, acc)
        sum_td = sum_res + cnt * (v_chunk[:, None, None] - q)
        n = n + cnt
        lr_cell = lr_now
        if count_lr_tau > 0:
            lr_cell = lr_now * (1.0 + n / count_lr_tau) ** (-count_lr_pow)
        q = q + lr_cell * sum_td / cnt.clamp_min(1.0)
        v, pa, pb = solve_matrix_games(q, iters=solver_iters)
        return q, n, v, pa, pb, pack_m2(cfg, pa, pb, v, eps_now)

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
    m = pack_m2(cfg, pi_a, pi_b, v, eps0)
    end_chunk = start_chunk + n_chunks
    pa_sum = pb_sum = q_sum = None
    history = []
    clock = _Timing(timing, device)
    for k in range(start_chunk, end_chunk):
        clock.mark()
        fields, acc, stats = packed_learner_chunk(
            cfg, _chunk_seed(seed, k), m, fields, batch, chunk_len, gamma)
        clock.mark()
        q, n, v, pi_a, pi_b, m = between(
            q, n, v, acc, _f32(lr_at(k)),
            _f32(decay(eps, eps_halflife, k, eps_min)))
        if avg_after and k >= avg_after:
            pa_sum = pi_a if pa_sum is None else pa_sum + pi_a
            pb_sum = pi_b if pb_sum is None else pb_sum + pi_b
            if avg_q:
                q_sum = q if q_sum is None else q_sum + q
        if k % 16 == 0 or k == end_chunk - 1:
            history.append(stats)
    clock.finish()
    history = [tuple(int(x) for x in row) for row in history]
    resume = {"q": q, "v": v, "pi_a": pi_a, "pi_b": pi_b, "n": n,
              "fields": fields, "next_chunk": end_chunk, "packed": True}
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
                              chunks_per_dispatch: int = 1):
    """Fused single-agent training: the best response of ``side``
    ('player_a' or 'player_b') to a frozen deterministic opponent
    ``opp_policy`` (int [nS]), with the same K5 chunk as
    ``fused_minimax_train``.  The frozen side's table columns hold its
    one-hot policy with no exploration; the learner's hold its greedy
    policy mixed with eps_k; between chunks the game solve is replaced by
    the best-response backup (v = max over A's actions of q[s, a,
    opp(s)], or min over B's of q[s, opp(s), b]; q and v stay in A's
    reward perspective).

    Returns (q, v, pi_a, pi_b, history); ``init`` is (q,) or (q, n); with
    ``return_state=True`` a sixth element is the resume dict (q, n, fields,
    next_chunk, packed), from which ``init``/``fields_init``/
    ``start_chunk`` continue bit for bit.  As in the JAX package."""
    _unsupported(cfg, mesh, packed, False, chunks_per_dispatch)
    if side not in ("player_a", "player_b"):
        raise ValueError(f"side must be 'player_a' or 'player_b', got {side!r}")
    device = torch.device(device)
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
    if fields_init is None:
        fields = init_state_fields(cfg, batch, device)
    else:
        fields = tuple(torch.as_tensor(f, dtype=torch.int32, device=device)
                       for f in fields_init)

    def between(q, n, v_chunk, acc, lr_now, eps_now):
        sum_res, cnt = unpack_acc2(cfg, acc)
        sum_td = sum_res + cnt * (v_chunk[:, None, None] - q)
        n = n + cnt
        q = q + lr_now * sum_td / cnt.clamp_min(1.0)
        if learn_a:
            q_eff = q.gather(2, opp[:, None, None].expand(nS, N_ACTIONS, 1))
            q_eff = q_eff[..., 0]                        # [nS, 5] over a
            v = q_eff.max(-1).values
            pi_l = torch.nn.functional.one_hot(q_eff.argmax(-1),
                                               N_ACTIONS).float()
            pa, pb = pi_l, opp_oh
            m = pack_m2(cfg, pa, pb, v, eps_now, eps_b=0.0)
        else:
            q_eff = q.gather(1, opp[:, None, None].expand(nS, 1, N_ACTIONS))
            q_eff = q_eff[:, 0, :]                       # [nS, 5] over b
            v = q_eff.min(-1).values
            pi_l = torch.nn.functional.one_hot(q_eff.argmin(-1),
                                               N_ACTIONS).float()
            pa, pb = opp_oh, pi_l
            m = pack_m2(cfg, pa, pb, v, 0.0, eps_b=eps_now)
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
        m = pack_m2(cfg, pi_a, pi_b, v, ea0, eps_b=eb0)
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
    history = []
    for k in range(start_chunk, end_chunk):
        fields, acc, stats = packed_learner_chunk(
            cfg, _chunk_seed(seed, k), m, fields, batch, chunk_len, gamma)
        q, n, v, pi_a, pi_b, m = between(q, n, v, acc, _f32(lr_at(k)),
                                         _f32(eps_at(k)))
        if k % 16 == 0 or k == end_chunk - 1:
            history.append(stats)
    history = [tuple(int(x) for x in row) for row in history]
    if return_state:
        return q, v, pi_a, pi_b, history, {
            "q": q, "n": n, "fields": fields, "next_chunk": end_chunk,
            "packed": True}
    return q, v, pi_a, pi_b, history
