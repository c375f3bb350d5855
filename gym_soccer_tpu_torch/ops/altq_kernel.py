"""Fused alternating-turn Q-learning: CUDA kernels K10 and K11, their
plain versions, and the chunked trainer.

The port of gym_soccer_tpu/ops/altq_kernel.py.  In the alternating game
(envs/soccer_alternating_env) one player moves a tick, so Q-learning needs
no matrix-game solve: Q is A-perspective, A maximises and B minimises, and
the fixpoint of the max/min backup is ``alt_value_iteration``'s exact
minimax value.  A chunk runs ``n_steps`` act -> step -> TD steps for
``batch`` lanes against a table that stays frozen for the chunk: each lane
reads the mover's Q values at its state, takes an eps-greedy action
(argmax for A, argmin for B), steps the game (ops/step_kernel's
``alt_transition_core`` and ``autoreset_core``, the same counter PRNG,
steps numbered from ``step_offset``), and accumulates per (state, action)
of the mover the visit count and a sum:

* ``altq_packed_chunk`` (kernel K10, the trainer's default): the Bellman
  residual r + cont * V(s') - V(s), with V the mover's max (A) or min (B);
  between chunks the trainer completes the TD sum with cnt * (V - q);
* ``altq_chunk`` (kernel K11, ``packed=False``): the full TD
  r + cont * V(s') - q(s, a).

Both step the same trajectories and count the same visits for the same
table.  Between chunks ``fused_altq_train`` applies the count-normalised
update q += lr * sum / max(cnt, 1) and repacks the table.

The table is indexed by the TURNLESS compact cellpair code (core/rules
``cellpair_encode``), the turn picking the column block: float32
[n_codes, 10] holds the A-to-move Q values in columns 0-4 and the
B-to-move values in 5-9.  Each value is the JAX package's double-bfloat16
hi + lo (ops/iql_kernel ``double_bf16``), the value its kernels act on.
The accumulators are int64 sums in units of 2**-32 and int32 counts,
[n_codes, 10] each, exact in any order of addition; ``unpack_alt_acc2``/
``unpack_alt_acc`` convert them to float32 per dense state.

A wrapper runs the plain PyTorch version when its tensors lie on the CPU
and launches the kernel (``csrc/altq_kernel.cu``, its two stages twinned
in ``ops/altq_codes.py``) when they lie on a CUDA device; there is no
fallback from one to the other.  The chunk wrappers
take their device from their tensors; ``fused_altq_train`` and
``init_alt_state_fields`` default to "cuda": CPU callers pass "cpu".

``chunks_per_dispatch`` > 1 runs g chunks and the work between them as
one CUDA-graph replay (ops/dispatch), the chunk's seed, eps_int and step
offset read from device memory.  ``mesh`` (parallel/mesh) trains
data-parallel: each rank runs its block of the lanes and the chunks' sums
are all-reduced.  The JAX wrappers' VMEM
guard (a grid over ~14 MB of tables) has no
counterpart: the port takes any grid.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import N_ACTIONS, EnvConfig
from ..core import rules
from ..envs.soccer_alternating_env import build_alt_tables
from . import dispatch
from . import iql_kernel as ik
from . import learner_kernel as lk
from . import step_kernel as sk

ALT_COLS = 2 * N_ACTIONS   # A-to-move Q[5], then B-to-move Q[5]; acc alike
FIX_SCALE = lk.FIX_SCALE   # sums count units of 2**-32
EPS_ONE = ik.EPS_ONE       # eps_int of always-explore
# The int64 sums of batch * n_steps values (one per lane-step: only the
# mover learns), each rounded to units of 2**-32, stay exact while every
# value lies within +-2**30 / (batch * n_steps); a chunk counts the values
# outside (or not finite) in its fourth stat, as K8/K9 do.
value_limit = ik.value_limit
double_bf16 = ik.double_bf16
n_codes = lk.n_codes
init_alt_state_fields = sk.init_alt_fields

# Launches of the CUDA kernels in this process, counted by the wrapper
# where it launches and nowhere else.
launch_counts = {"altq_packed_chunk": 0, "altq_chunk": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------------------
# Table layout, packing and unpacking
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _alt_rows(cfg: EnvConfig) -> tuple[np.ndarray, np.ndarray]:
    """(turnless cellpair row, turn) of each alternating dense state.
    (row, turn) is unique per dense state; dense 0 (the absorbing
    terminal) maps to a goal state's cellpair, which no other state shares
    and the autoresetting kernels never visit."""
    tb = build_alt_tables(cfg)
    f = tb.fields.astype(np.int64)
    rows = rules.cellpair_encode(np, f[:, 0], f[:, 1], f[:, 2], f[:, 3],
                                 f[:, 4], cfg).astype(np.int32)
    return rows, tb.turn.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _cells(cfg: EnvConfig, device: torch.device) -> torch.Tensor:
    """Flat table index of each dense state's five actions, [nS, 5]:
    row * 10 + turn * 5 + a."""
    rows, turn = _alt_rows(cfg)
    base = rows.astype(np.int64) * ALT_COLS + turn * N_ACTIONS
    return torch.as_tensor(base[:, None] + np.arange(N_ACTIONS),
                           device=device)


def _check_cfg(cfg) -> None:
    if not isinstance(cfg, EnvConfig):
        raise ValueError("the alternating learner takes one EnvConfig, got "
                         f"{type(cfg).__name__}")


def pack_alt_table(cfg: EnvConfig, q) -> torch.Tensor:
    """The alternating Q table [nS, 5] (A-perspective) -> the chunks' table
    float32 [n_codes, 10] on its device: A-to-move states' values in
    columns 0-4 and B-to-move states' in 5-9 of the state's turnless
    cellpair row, each as its double-bfloat16 value (``double_bf16``).
    Cells of no dense state stay zero."""
    _check_cfg(cfg)
    q = torch.as_tensor(q)
    table = torch.zeros(n_codes(cfg) * ALT_COLS, dtype=torch.float32,
                        device=q.device)
    table[_cells(cfg, q.device)] = double_bf16(q)
    return table.reshape(-1, ALT_COLS)


def _unpack(cfg: EnvConfig, acc):
    """acc = (sums int64, counts int32), each [n_codes, 10] -> (sum, cnt),
    each float32 [nS, 5]."""
    sums, cnt = acc
    cells = _cells(cfg, sums.device)
    s = (sums.reshape(-1)[cells].double() * (1.0 / FIX_SCALE)).float()
    return s, cnt.reshape(-1)[cells].float()


# K10's acc (residual sums; the TD sum of a cell is sum_res + cnt * (V(s) -
# q(s, a)) for the chunk's frozen q) and K11's acc (TD sums) decode alike.
unpack_alt_acc2 = unpack_alt_acc = _unpack


# ----------------------------------------------------------------------
# One chunk: plain version and wrappers
# ----------------------------------------------------------------------

def _plain(cfg: EnvConfig, seed: int, eps_int: int, table, fields,
           n_steps: int, gamma: float, step_offset: int, packed: bool,
           total: int):
    ra, ca, rb, cb, p, turn, t = fields
    dev = ra.device
    B = ra.shape[0]
    q_int = sk._q_int(cfg)
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    sums = torch.zeros(n_codes(cfg) * ALT_COLS, dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_codes(cfg) * ALT_COLS, dtype=torch.int32, device=dev)
    rew = torch.zeros(B, dtype=torch.int64, device=dev)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    out_of_range = torch.zeros((), dtype=torch.int64, device=dev)
    gamma_f = torch.tensor(np.float32(gamma), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    limit = value_limit(total, n_steps)
    flat = table.reshape(-1)
    five = torch.arange(N_ACTIONS, device=dev)

    def mover(ra, ca, rb, cb, p, turn):
        """The flat index of the mover's five cells, their Q values and V:
        max (NaN-propagating, as the kernel's) for A, min for B."""
        cp = rules.cellpair_encode(torch, ra, ca, rb, cb, p, cfg).long()
        base = cp * ALT_COLS + turn.long() * N_ACTIONS
        q = flat[base[:, None] + five]
        cols = q.unbind(1)
        vmax = vmin = cols[0]
        for k in range(1, N_ACTIONS):
            vmax = torch.maximum(vmax, cols[k])
            vmin = torch.minimum(vmin, cols[k])
        return base, q, torch.where(turn == 0, vmax, vmin)

    pend = None
    for i in range(n_steps):
        b0, b1, b2 = (sk._random_word(seed, i + step_offset, w, lane)
                      for w in range(3))
        base, q, v = mover(ra, ca, rb, cb, p, turn)
        if pend is not None:   # the previous step, bootstrapped from here
            out_of_range += ik._retire(sums, cnt, *pend[:3], v, pend[3],
                                       limit)
        # greedy on sgn * q (strict > from action 0: the lowest index wins
        # a tie for either player)
        sgn = torch.where(turn == 0, 1.0, -1.0)
        best = torch.zeros(B, dtype=torch.int64, device=dev)
        bestv = sgn * q[:, 0]
        for k in range(1, N_ACTIONS):
            sc = sgn * q[:, k]
            best = torch.where(sc > bestv, k, best)
            bestv = torch.maximum(bestv, sc)
        a = torch.where(sk._u16(b0, 0) < eps_int,
                        sk._u16(b0, 1).long() % N_ACTIONS, best)
        ra, ca, rb, cb, p, goal, r = sk.alt_transition_core(
            ra, ca, rb, cb, p, turn, a.int(), b1, cfg, q_int)
        ra, ca, rb, cb, p, t, trunc = sk.autoreset_core(
            ra, ca, rb, cb, p, t, goal, b2, cfg)
        term = goal | trunc
        cont = torch.where(term, zero, gamma_f)
        baseline = v if packed else q.gather(1, a[:, None])[:, 0]
        pend = (base + a, r.float(), cont, baseline)
        turn = torch.where(term, 0, 1 - turn)
        rew += r
        goals += goal
        truncs += trunc
    _, _, v = mover(ra, ca, rb, cb, p, turn)
    out_of_range += ik._retire(sums, cnt, *pend[:3], v, pend[3], limit)
    acc = (sums.reshape(-1, ALT_COLS), cnt.reshape(-1, ALT_COLS))
    return ((ra, ca, rb, cb, p, turn, t), acc,
            (rew.sum(), goals.sum(), truncs.sum(), out_of_range))


def _chunk(packed: bool, cfg, seed, eps_int, table, fields, batch, n_steps,
           gamma, step_offset, threads, plain: bool, global_batch=None):
    _check_cfg(cfg)
    if not plain:
        threads = _check_lanes(batch, threads)
    seed, eps_int, step_offset, scalars = ik.scalar_args(
        seed, eps_int, step_offset, table, plain)
    fields = ik._check_args(cfg, eps_int, table, fields, batch, n_steps,
                            step_offset, n_fields=7,
                            global_batch=global_batch)
    total = lk.sum_batch(batch, global_batch)
    if plain or table.device.type == "cpu":
        return _plain(cfg, seed, eps_int, table, fields, n_steps, gamma,
                      step_offset, packed, total)
    return _launch(packed, cfg, seed, eps_int, table, fields, n_steps, gamma,
                   step_offset, threads, scalars, total)


def altq_packed_chunk(cfg: EnvConfig, seed: int, eps_int: int, table,
                      fields, batch: int, n_steps: int, gamma: float = 0.99,
                      step_offset: int = 0, threads=None, global_batch=None):
    """Run one fused alternating-turn Q chunk with residual accumulation
    (kernel K10).

    ``table``: float32 [n_codes, 10] from ``pack_alt_table``; ``fields``:
    seven int32 [batch] tensors (ra, ca, rb, cb, p, turn, t), e.g. from
    ``init_alt_state_fields``; all on one device, where the chunk runs.
    ``batch`` is a multiple of 128 and batch * n_steps at most 2**29.
    ``eps_int`` = round(eps * 65536) in [0, 65536].  ``seed`` keys the
    counter PRNG with the steps numbered from ``step_offset``; the three
    may instead come in an int32 [3] tensor passed as ``seed``
    (``iql_kernel.scalar_args``), which the kernel reads when it runs.
    Returns ``(fields, (res, cnt), (reward_sum, goals, truncs,
    out_of_range))``: the final state, the int64 residual sums (units of
    2**-32) and int32 visit counts [n_codes, 10] (decode with
    ``unpack_alt_acc2``), and the
    int64 totals.  The sums are exact when ``out_of_range``, the number of
    values outside +-``value_limit(batch, n_steps)`` or not finite, is 0;
    it is counted on the device, so the call does not wait for the chunk.
    ``threads`` is the kernel's lanes per block: a multiple of 32 in [32,
    512], by default the fewest that keep the grid to one wave of 132
    blocks (``altq_codes.check_lanes``: 64 at 8192 lanes, 512 at 65536;
    ValueError otherwise, on any device); it does not change the result.
    On the card the outputs are views of one allocation.  ``fields`` hold
    the alternating game's turns, 0 or 1, as ``init_alt_state_fields``
    makes them; a lane with another turn reads its table row block
    ``turn`` as the plain version does.  ``global_batch``: where the sums
    are added to other chunks' (a data-parallel run, parallel/mesh), the
    lanes of them all, whose ``value_limit`` and 2**29 cap apply in place
    of ``batch``'s.

    On a CPU device this runs ``altq_packed_chunk_plain``; on a CUDA device
    it launches the K10 kernel.
    """
    return _chunk(True, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, threads, plain=False,
                  global_batch=global_batch)


def altq_packed_chunk_plain(cfg: EnvConfig, seed: int, eps_int: int, table,
                            fields, batch: int, n_steps: int,
                            gamma: float = 0.99, step_offset: int = 0):
    """Plain PyTorch version of ``altq_packed_chunk``, on any device."""
    return _chunk(True, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, None, plain=True)


def altq_chunk(cfg: EnvConfig, seed: int, eps_int: int, table, fields,
               batch: int, n_steps: int, gamma: float = 0.99,
               step_offset: int = 0, threads=None, global_batch=None):
    """``altq_packed_chunk`` accumulating the full TD sums
    r + cont * V(s') - q(s, a) (kernel K11; decode with
    ``unpack_alt_acc``).  The fields, stats and counts equal
    ``altq_packed_chunk``'s for the same arguments; ``threads`` and
    ``global_batch`` are as there.

    On a CPU device this runs ``altq_chunk_plain``; on a CUDA device it
    launches the K11 kernel.
    """
    return _chunk(False, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, threads, plain=False,
                  global_batch=global_batch)


def altq_chunk_plain(cfg: EnvConfig, seed: int, eps_int: int, table, fields,
                     batch: int, n_steps: int, gamma: float = 0.99,
                     step_offset: int = 0):
    """Plain PyTorch version of ``altq_chunk``, on any device."""
    return _chunk(False, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, None, plain=True)


def _check_lanes(batch: int, threads) -> int:
    from . import altq_codes
    return altq_codes.check_lanes(batch, threads)


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared."""
    from . import _build
    return declare(_build.load("altq_kernel"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``csrc/altq_kernel.cu``."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gst_altq_chunk.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, ctypes.c_uint32, i32, i32,
        vp, f32, f32, i32, i32, vp]
    #    device, in, buf, table, tick, code_raw, params, n_codes, B, T, seed,
    #    eps_int, step_offset, scalars, gamma, limit, packed, lanes, stream
    lib.gst_altq_chunk.restype = i32
    lib.gst_altq_layout.argtypes = [i32, i32, vp]
    lib.gst_altq_layout.restype = None
    lib.gst_altq_smem_bytes.argtypes = [i32, i32, i32, i32, vp]
    lib.gst_altq_smem_bytes.restype = i32
    lib.gst_altq_shape.argtypes = [vp]
    lib.gst_altq_shape.restype = None
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _host(cfg: EnvConfig, device: torch.device):
    """(cached per board and device) The game description, the number of
    codes and K4's tick table with its raw codes (None where the kernel
    walks by arithmetic: ``altq_codes.uses_table``)."""
    from . import altq_codes
    from . import rollout_codes as rc
    tick = rc.device_alt_table(cfg, device) if altq_codes.uses_table(cfg) \
        else None
    return sk._game_params(cfg), n_codes(cfg), tick


def _launch(packed: bool, cfg: EnvConfig, seed: int, eps_int: int, table,
            fields, n_steps: int, gamma: float, step_offset: int,
            lanes: int, scalars, total: int):
    """Launch K10 or K11 at ``lanes`` lanes per block (``scalars``: the
    device tensor of ``iql_kernel.scalar_args`` or None), counting the
    values outside ``value_limit(total, n_steps)``.  Its outputs (the
    seven planes, the sums, the counts and the stats) and the prep pass's
    rows are one allocation, zeroed where it sums by one memset in the
    launch."""
    from . import altq_codes
    name = "altq_packed_chunk" if packed else "altq_chunk"
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    params, n, tick = _host(cfg, dev)
    B = fields[0].shape[0]
    lay = altq_codes.layout(n, B)
    b64 = torch.empty(lay.total // 8, dtype=torch.int64, device=dev)
    in_ptrs = sk.ptr_array(fields)
    tick_ptrs = ((tick.table.data_ptr(), tick.code_raw.data_ptr())
                 if tick is not None else (None, None))
    rc = _library().gst_altq_chunk(
        dev.index, ctypes.addressof(in_ptrs), b64.data_ptr(),
        table.data_ptr(), *tick_ptrs, ctypes.addressof(params), n, B,
        n_steps, seed & sk.M32, eps_int, step_offset,
        None if scalars is None else scalars.data_ptr(), lk._f32(gamma),
        value_limit(total, n_steps), int(packed), lanes,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{_library().gst_error_string(rc).decode()} "
                           f"({rc})")
    launch_counts[name] += 1
    b32 = b64.view(torch.int32)
    return (b32.as_strided((7, B), (B, 1), lay.fields // 4).unbind(0),
            (b64.as_strided((n, ALT_COLS), (ALT_COLS, 1), 0),
             b32.as_strided((n, ALT_COLS), (ALT_COLS, 1), lay.cnt // 4)),
            b64.as_strided((4,), (1,), lay.stats // 8).unbind())


# ----------------------------------------------------------------------
# Chunked trainer
# ----------------------------------------------------------------------

def fused_altq_train(cfg: EnvConfig, batch: int, n_chunks: int,
                     chunk_len: int = 64, lr: float = 0.5,
                     gamma: float = 0.99, eps: float = 0.3,
                     eps_min: float = 0.0, eps_halflife: int = 0,
                     lr_anneal_start: int = 0, lr_anneal_tau: float = 0.0,
                     lr_anneal_pow: float = 1.0, seed: int = 0,
                     init=None, mesh=None, start_chunk: int = 0,
                     fields_init: tuple | None = None,
                     return_state: bool = False,
                     packed: bool | None = None,
                     chunks_per_dispatch: int = 1,
                     device="cuda", timing: dict | None = None):
    """Chunked fused alternating-turn Q-learning.  Returns (q,
    stats_history), ``q`` [nS_alt, 5] A-perspective on ``device``, whose
    fixpoint is ``alt_value_iteration``'s exact minimax values (extract a
    policy with agents/learners ``altq_greedy_policy``).  The arguments
    mean what they mean in the JAX package
    (gym_soccer_tpu/ops/altq_kernel.py ``fused_altq_train``):

    * chunk k runs with seed ``seed * 1_000_003 + k`` (a run whose chunk
      seeds do not fit int32 raises OverflowError before its first chunk,
      as JAX raises), its steps numbered from ``k * chunk_len``, eps_int =
      round(eps_k * 65536) with eps_k = max(eps * 0.5**(k * chunk_len /
      eps_halflife), eps_min) on the host in float64, and lr_k = lr * (1 +
      max(0, k - lr_anneal_start) / lr_anneal_tau) ** -lr_anneal_pow
      rounded to float32;
    * ``packed`` (default True) runs K10 and completes the TD sums with
      cnt * (V - q), V = max q at A-to-move states and min q at B-to-move
      ones, between chunks; False runs K11.  Both step the same
      trajectories;
    * between chunks: q += lr_k * sum_td / max(cnt, 1), then a repack;
    * ``init``: a warm-start q [nS_alt, 5], a tensor or an array;
    * ``return_state=True`` adds a third element, the resume dict (q,
      fields, next_chunk, packed); ``init``/``fields_init``/``start_chunk``
      from it continue bit for bit like an uninterrupted run;
    * ``stats_history`` holds (reward_sum, goals, truncs) of every 16th
      chunk and of the last, or of every chunk in the grouped mode;
    * ``chunks_per_dispatch`` = g > 1: the grouped mode, as in
      ``iql_kernel.fused_iql_train``: the same q and fields bit for bit;
    * ``mesh``: data-parallel training (``sharded_altq_chunk_fn``), as in
      ``iql_kernel.fused_iql_train``.

    On a CUDA device every chunk launches K10 (or K11), and no chunk waits
    for the one before: the chunks' out-of-range counts (see
    ``altq_packed_chunk``) are summed on the device and read once, at the
    end, and a run in which any value left the int64 sums' exact range
    raises ValueError.  ``timing``, if a dict, is filled with the time
    spent in chunk calls and between them (the per-chunk mode), or with
    ``dispatch.run``'s capture, replay and remainder times.
    """
    g = dispatch.group_size(n_chunks, False, chunks_per_dispatch)
    _check_cfg(cfg)
    lk._check_seeds(seed, start_chunk, start_chunk + n_chunks)
    packed = True if packed is None else bool(packed)
    device = lk._trainer_device(device, mesh)
    tb = build_alt_tables(cfg)
    if init is None:
        q = torch.zeros((tb.nS, N_ACTIONS), dtype=torch.float32,
                        device=device)
    else:
        q = lk._float_tensor(init, device)
        if tuple(q.shape) != (tb.nS, N_ACTIONS):
            raise ValueError(f"init q must be [{tb.nS}, 5]")
    if fields_init is None:
        fields = init_alt_state_fields(cfg, batch, device)
    else:
        fields = tuple(torch.as_tensor(f, dtype=torch.int32, device=device)
                       for f in fields_init)
    if mesh is None:
        chunk_fn = altq_packed_chunk if packed else altq_chunk

        def chunk(seed, eps_int, m, fields, step_offset):
            return chunk_fn(cfg, seed, eps_int, m, fields, batch, chunk_len,
                            gamma, step_offset)
    else:   # the global batch's fields, or the rank's own from a resume
        from ..parallel import mesh as pmesh
        chunk = pmesh.sharded_altq_chunk_fn(cfg, mesh, batch, chunk_len,
                                            gamma, packed)
        if fields_init is None:
            fields = pmesh.shard_fields(fields, mesh, batch)
    is_a = torch.as_tensor(tb.turn == 0, device=device)

    def between(q, acc, lr_now):
        sum_td, cnt = _unpack(cfg, acc)
        if packed:
            v = torch.where(is_a, q.max(-1).values, q.min(-1).values)
            sum_td = sum_td + cnt * (v[:, None] - q)
        q = q + lr_now * sum_td / cnt.clamp_min(1.0)
        return q, pack_alt_table(cfg, q)

    def lr_at(k):
        d = lr
        if lr_anneal_tau > 0:
            d = d * (1.0 + max(k - lr_anneal_start, 0) / lr_anneal_tau) \
                ** (-lr_anneal_pow)
        return d

    def eps_at(k):
        d = eps * (0.5 ** (k * chunk_len / eps_halflife)
                   if eps_halflife else 1.0)
        return max(d, eps_min)

    m = pack_alt_table(cfg, q)
    end_chunk = start_chunk + n_chunks
    if g is not None:
        sched = ik.schedule(seed, start_chunk, end_chunk, chunk_len,
                            lambda k: lk._f32(lr_at(k)),
                            lambda k: int(round(eps_at(k) * 65536)), device)
        carry = [t.clone() for t in (*fields, q, m)]
        *fields, q, m = carry
        fields = tuple(fields)

        def body():
            lr, ints = sched.row()
            new_fields, acc, stats = chunk(ints, None, m, fields, 0)
            new = between(q, acc, lr[0])
            for dst, src in zip((*fields, q, m), (*new_fields, *new)):
                dst.copy_(src)
            sched.record(stats)

        dispatch.run(body, carry + sched.state(), n_chunks, g,
                     (launch_counts,), timing, mesh=mesh)
        history, out_of_range = sched.history()
    else:
        history = []
        out_of_range = 0
        clock = lk._Timing(timing, device)
        for k in range(start_chunk, end_chunk):
            clock.mark()
            fields, acc, stats = chunk(
                lk._chunk_seed(seed, k), int(round(eps_at(k) * 65536)), m,
                fields, k * chunk_len)
            clock.mark()
            q, m = between(q, acc, lk._f32(lr_at(k)))
            out_of_range = out_of_range + stats[3]
            if k % 16 == 0 or k == end_chunk - 1:
                history.append(stats[:3])
        clock.finish()
        history = [tuple(int(x) for x in row) for row in history]
    if int(out_of_range):
        raise ValueError(
            f"{int(out_of_range)} values left +-{value_limit(batch, chunk_len)}"
            f": the int64 fixed-point sums could overflow (batch * chunk_len "
            f"= {batch * chunk_len}, max|q| up to {float(q.abs().max())})")
    if return_state:
        return q, history, {"q": q, "fields": fields,
                            "next_chunk": end_chunk, "packed": packed}
    return q, history
