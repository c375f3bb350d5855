"""Fused independent-Q (IQL) self-play: CUDA kernels K8 and K9, their
plain versions, and the chunked trainer.

The port of gym_soccer_tpu/ops/iql_kernel.py.  Both players run
eps-greedy Q-learning on their own table, A on the reward r and B on -r.
A chunk runs ``n_steps`` act -> step -> TD steps for ``batch`` lanes
against a table that stays frozen for the chunk: each lane takes both
players' eps-greedy actions on their own Q values at its state, steps the
game (ops/step_kernel's transition and autoreset, the same counter PRNG,
with the steps numbered from ``step_offset``), and accumulates per
(state, player, action) the visit count and a sum:

* ``iql_packed_chunk`` (kernel K8, the trainer's default): the Bellman
  residual r + cont * max q(s') - max q(s); between chunks the trainer
  completes the TD sum with cnt * (max q(s) - q(s, a));
* ``iql_chunk`` (kernel K9, ``packed=False``): the full TD
  r + cont * max q(s') - q(s, a).

Both step the same trajectories and count the same visits for the same
table.  Between chunks ``fused_iql_train`` applies the count-normalised
update q += lr * sum / max(cnt, 1) and repacks the table.

The table is indexed by the compact cellpair code (core/rules
``cellpair_encode``): float32 [n_codes, 10] holding A's five Q values,
then B's.  Each value is the JAX package's double-bfloat16 pair hi + lo
(hi = bf16(q), lo = bf16(q - hi)), which is exact in float32: the JAX
kernel takes its greedy actions and its max-bootstraps from those values,
and an exact-q table would act differently at near-ties.  The trainer's
update uses the exact q.  The accumulators are int64 sums in units of
2**-32 and int32 counts, [n_codes, 10] each, exact in any order of
addition; ``unpack_iql_acc2``/``unpack_iql_acc`` convert them to float32
per dense state.

A wrapper runs the plain PyTorch version when its tensors lie on the CPU
and launches the kernel (``csrc/iql_kernel.cu``, its two stages twinned in
``ops/iql_codes.py``) when they lie on a CUDA device; there is no fallback
from one to the other.  The chunk wrappers take their device from their
tensors; ``fused_iql_train`` and ``init_iql_state_fields`` default to
"cuda": CPU callers pass "cpu".

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
from ..core import rules, tables
from . import dispatch
from . import learner_kernel as lk
from . import step_kernel as sk

IQL_COLS = 2 * N_ACTIONS   # A's Q[5], then B's Q[5]; the accumulators alike
COL_A, COL_B = 0, N_ACTIONS
FIX_SCALE = lk.FIX_SCALE   # sums count units of 2**-32
# The int64 sums of batch * n_steps values, each rounded to units of
# 2**-32, stay exact while every value lies within +-2**30 / (batch *
# n_steps): the total is then below 2**62 + batch * n_steps.  A chunk
# counts the values outside that range (or not finite) in its fourth stat;
# a value is at most 1 + (1 + gamma) * max|q|, so at the cap of batch *
# n_steps = 2**29 (lk.MAX_LANE_STEPS, which also keeps the int32 counts
# exact) none is outside while max|q| <= 0.5, and at 2**28 while max|q|
# <= 1.
EPS_ONE = 65536            # eps_int of always-explore

# Launches of the CUDA kernels in this process, counted by the wrapper
# where it launches and nowhere else.
launch_counts = {"iql_packed_chunk": 0, "iql_chunk": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------------------
# Table layout, packing and unpacking
# ----------------------------------------------------------------------

n_codes = lk.n_codes


def double_bf16(q) -> torch.Tensor:
    """hi + lo with hi = bf16(q) and lo = bf16(q - hi), in float32: the
    value the JAX kernel reads from its double-bfloat16 M (exact: q - hi
    is exact, and hi + lo has at most 17 significant bits)."""
    q = q.float()
    hi = q.to(torch.bfloat16).float()
    return hi + (q - hi).to(torch.bfloat16).float()


def pack_iql_table(cfg: EnvConfig, q_a, q_b) -> torch.Tensor:
    """Both players' Q tables [nS, 5] -> the chunk's table float32
    [n_codes, 10] on their device: A's values in columns 0-4, B's in 5-9,
    each as its double-bfloat16 value (``double_bf16``).  Rows of codes
    that are no dense state stay zero."""
    dev = q_a.device
    codes = lk._codes(cfg, dev)
    table = torch.zeros((n_codes(cfg), IQL_COLS), dtype=torch.float32,
                        device=dev)
    table[codes, COL_A:COL_A + N_ACTIONS] = double_bf16(q_a)
    table[codes, COL_B:COL_B + N_ACTIONS] = double_bf16(q_b)
    return table


def _unpack(cfg: EnvConfig, acc):
    """acc = (sums int64, counts int32), each [n_codes, 10] -> (sum_a,
    cnt_a, sum_b, cnt_b), each float32 [nS, 5]."""
    sums, cnt = acc
    codes = lk._codes(cfg, sums.device)
    s = (sums[codes].double() * (1.0 / FIX_SCALE)).float()
    c = cnt[codes].float()
    a, b = slice(COL_A, COL_A + N_ACTIONS), slice(COL_B, COL_B + N_ACTIONS)
    return s[:, a], c[:, a], s[:, b], c[:, b]


# K8's acc (residual sums; the TD sum of a cell is sum_res + cnt * (max
# q(s) - q(s, a)) for the chunk's frozen q) and K9's acc (TD sums) decode
# alike.
unpack_iql_acc2 = unpack_iql_acc = _unpack
init_iql_state_fields = lk.init_state_fields


# ----------------------------------------------------------------------
# One chunk: plain version and wrappers
# ----------------------------------------------------------------------

def _check_args(cfg: EnvConfig, eps_int: int, table, fields, batch: int,
                n_steps: int, step_offset: int, n_fields: int = 6,
                global_batch=None):
    fields = lk._check_chunk_args(cfg, table, fields, batch, n_steps,
                                  cols=IQL_COLS, n_fields=n_fields,
                                  global_batch=global_batch)
    if not 0 <= eps_int <= EPS_ONE:
        raise ValueError(f"eps_int must lie in [0, {EPS_ONE}], got {eps_int}")
    if step_offset < 0 or step_offset + n_steps >= 2 ** 31:
        raise ValueError(f"steps [{step_offset}, {step_offset + n_steps}) "
                         "must lie in [0, 2**31)")
    return fields


def value_limit(batch: int, n_steps: int) -> float:
    """The float32 bound on |value| within which the int64 sums of a chunk
    of ``batch`` x ``n_steps`` stay exact."""
    return float(np.float32(2.0 ** 30 / (batch * n_steps)))


def _greedy(q):
    """Greedy action (strict > scan from action 0: the lowest index wins a
    tie) and max of the five columns of ``q``."""
    cols = q.unbind(1)
    best = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    v = cols[0]
    for k in range(1, N_ACTIONS):
        upd = cols[k] > v
        best = torch.where(upd, k, best)
        v = torch.where(upd, cols[k], v)
    return best, v


def _retire(sums, cnt, idx, r, cont, v_next, base, limit):
    """Add the values (r + cont * v_next) - base at cells ``idx``; return
    how many lie outside +-limit or are not finite."""
    delta = (r + cont * v_next) - base
    fixed = torch.round(delta.double() * FIX_SCALE).long()
    sums.index_add_(0, idx, fixed)
    cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return (~(delta.abs() <= limit)).sum()


def _plain(cfg: EnvConfig, seed: int, eps_int: int, table, fields,
           n_steps: int, gamma: float, step_offset: int, packed: bool,
           total: int):
    ra, ca, rb, cb, p, t = fields
    dev = ra.device
    B = ra.shape[0]
    q_int = sk._q_int(cfg)
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    sums = torch.zeros(n_codes(cfg) * IQL_COLS, dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_codes(cfg) * IQL_COLS, dtype=torch.int32, device=dev)
    rew = torch.zeros(B, dtype=torch.int64, device=dev)
    goals, truncs = torch.zeros_like(rew), torch.zeros_like(rew)
    out_of_range = torch.zeros((), dtype=torch.int64, device=dev)
    gamma_f = torch.tensor(np.float32(gamma), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    limit = value_limit(total, n_steps)

    def maxes(cp):
        row = table[cp]
        qa, qb = row[:, COL_A:COL_A + 5], row[:, COL_B:COL_B + 5]
        return qa, qb, _greedy(qa), _greedy(qb)

    def retire(pend, va, vb):
        nonlocal out_of_range
        ia, ib, r, cont, base_a, base_b = pend
        out_of_range = (out_of_range
                        + _retire(sums, cnt, ia, r, cont, va, base_a, limit)
                        + _retire(sums, cnt, ib, -r, cont, vb, base_b, limit))

    pend = None
    for i in range(n_steps):
        b0, b1, b2, b3 = (sk._random_word(seed, i + step_offset, w, lane)
                          for w in range(4))
        cp = rules.cellpair_encode(torch, ra, ca, rb, cb, p, cfg).long()
        qa, qb, (ga, va), (gb, vb) = maxes(cp)
        if pend is not None:   # the previous step, bootstrapped from here
            retire(pend, va, vb)
        aa = torch.where(sk._u16(b0, 0) < eps_int,
                         sk._u16(b0, 1).long() % N_ACTIONS, ga)
        ab = torch.where(sk._u16(b3, 0) < eps_int,
                         sk._u16(b3, 1).long() % N_ACTIONS, gb)
        ra, ca, rb, cb, p, goal, r = sk.transition_core(
            ra, ca, rb, cb, p, aa.int(), ab.int(), b1, b2, cfg, q_int)
        ra, ca, rb, cb, p, t, trunc = sk.autoreset_core(
            ra, ca, rb, cb, p, t, goal, b2, cfg)
        cont = torch.where(goal | trunc, zero, gamma_f)
        if packed:
            base_a, base_b = va, vb
        else:
            base_a = qa.gather(1, aa[:, None])[:, 0]
            base_b = qb.gather(1, ab[:, None])[:, 0]
        pend = (cp * IQL_COLS + COL_A + aa, cp * IQL_COLS + COL_B + ab,
                r.float(), cont, base_a, base_b)
        rew += r
        goals += goal
        truncs += trunc
    cp = rules.cellpair_encode(torch, ra, ca, rb, cb, p, cfg).long()
    _, _, (_, va), (_, vb) = maxes(cp)
    retire(pend, va, vb)   # the last step, against the final state
    acc = (sums.reshape(-1, IQL_COLS), cnt.reshape(-1, IQL_COLS))
    return ((ra, ca, rb, cb, p, t), acc,
            (rew.sum(), goals.sum(), truncs.sum(), out_of_range))


def scalar_args(seed, eps_int, step_offset, table, plain: bool):
    """(seed, eps_int, step_offset, scalars) of a K8-K11 call.  ``seed``
    may be an int32 [3] tensor holding (seed, eps_int, step_offset) on the
    table's device (``eps_int`` then None and ``step_offset`` 0): a plain
    version reads them now, a kernel when it runs (``scalars``; the three
    ints are then 0, and the caller keeps the values in range)."""
    if not isinstance(seed, torch.Tensor):
        return seed, eps_int, step_offset, None
    if eps_int is not None or step_offset != 0:
        raise ValueError("with scalars in a tensor, eps_int is None and "
                         "step_offset 0")
    scalars = lk.check_scalars(seed, 3, table.device)
    if plain or not table.is_cuda:
        seed, eps_int, step_offset = (int(x) for x in scalars.tolist())
        return seed & sk.M32, eps_int, step_offset, None
    return 0, 0, 0, scalars


def _chunk(packed: bool, cfg, seed, eps_int, table, fields, batch, n_steps,
           gamma, step_offset, threads, plain: bool, global_batch=None):
    seed, eps_int, step_offset, scalars = scalar_args(
        seed, eps_int, step_offset, table, plain)
    fields = _check_args(cfg, eps_int, table, fields, batch, n_steps,
                         step_offset, global_batch=global_batch)
    total = lk.sum_batch(batch, global_batch)
    if plain or table.device.type == "cpu":
        return _plain(cfg, seed, eps_int, table, fields, n_steps, gamma,
                      step_offset, packed, total)
    return _launch(packed, cfg, seed, eps_int, table, fields, n_steps, gamma,
                   step_offset, threads, scalars, total)


def iql_packed_chunk(cfg: EnvConfig, seed: int, eps_int: int, table, fields,
                     batch: int, n_steps: int, gamma: float = 0.99,
                     step_offset: int = 0, threads=None, global_batch=None):
    """Run one fused IQL chunk with residual accumulation (kernel K8).

    ``table``: float32 [n_codes, 10] from ``pack_iql_table``; ``fields``:
    six int32 [batch] tensors (ra, ca, rb, cb, p, t), e.g. from
    ``init_iql_state_fields``; all on one device, where the chunk runs.
    ``batch`` is a multiple of 128 and batch * n_steps at most 2**29.
    ``eps_int`` = round(eps * 65536) in [0, 65536].  ``seed`` keys the
    counter PRNG with the steps numbered from ``step_offset``; the three
    may instead come in an int32 [3] tensor passed as ``seed``
    (``scalar_args``), which the kernel reads when it runs.  Returns
    ``(fields, (res, cnt), (reward_sum, goals, truncs, out_of_range))``:
    the final state, the int64 residual sums (units of 2**-32) and int32
    visit counts [n_codes, 10] (decode with ``unpack_iql_acc2``), and the
    int64 totals.  The sums are exact when ``out_of_range``, the number of
    values outside +-``value_limit(batch, n_steps)`` or not finite, is 0
    (always while max|q| <= 0.5); it is counted on the device, so the call
    does not wait for the chunk.  ``threads`` is the kernel's lanes per
    block: a multiple of 32 in [32, 512], by default the fewest that keep
    the grid to one wave of 132 blocks (``iql_codes.check_lanes``: 64 at
    8192 lanes, 512 at 65536; ValueError otherwise, on any device); it does
    not change the result.  On the card the outputs are views of one
    allocation.  ``global_batch``: where the sums are added to other
    chunks' (a data-parallel run, parallel/mesh), the lanes of them all,
    whose ``value_limit`` and 2**29 cap apply in place of ``batch``'s.

    On a CPU device this runs ``iql_packed_chunk_plain``; on a CUDA device
    it launches the K8 kernel.
    """
    threads = _check_lanes(batch, threads)
    return _chunk(True, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, threads, plain=False,
                  global_batch=global_batch)


def iql_packed_chunk_plain(cfg: EnvConfig, seed: int, eps_int: int, table,
                           fields, batch: int, n_steps: int,
                           gamma: float = 0.99, step_offset: int = 0):
    """Plain PyTorch version of ``iql_packed_chunk``, on any device."""
    return _chunk(True, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, None, plain=True)


def iql_chunk(cfg: EnvConfig, seed: int, eps_int: int, table, fields,
              batch: int, n_steps: int, gamma: float = 0.99,
              step_offset: int = 0, threads=None, global_batch=None):
    """``iql_packed_chunk`` accumulating the full TD sums
    r + cont * max q(s') - q(s, a) (kernel K9; decode with
    ``unpack_iql_acc``).  The fields, stats and counts equal
    ``iql_packed_chunk``'s for the same arguments; ``threads`` and
    ``global_batch`` are as there.

    On a CPU device this runs ``iql_chunk_plain``; on a CUDA device it
    launches the K9 kernel.
    """
    threads = _check_lanes(batch, threads)
    return _chunk(False, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, threads, plain=False,
                  global_batch=global_batch)


def iql_chunk_plain(cfg: EnvConfig, seed: int, eps_int: int, table, fields,
                    batch: int, n_steps: int, gamma: float = 0.99,
                    step_offset: int = 0):
    """Plain PyTorch version of ``iql_chunk``, on any device."""
    return _chunk(False, cfg, seed, eps_int, table, fields, batch, n_steps,
                  gamma, step_offset, None, plain=True)


def _check_lanes(batch: int, threads) -> int:
    from . import iql_codes
    return iql_codes.check_lanes(batch, threads)


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared."""
    from . import _build
    return declare(_build.load("iql_kernel"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``csrc/iql_kernel.cu``."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gst_iql_chunk.argtypes = [
        i32, vp, vp, vp, vp, i32, i32, i32, ctypes.c_uint32, i32, i32, vp,
        f32, f32, i32, i32, vp]
    #    device, in, buf, table, params, n_codes, B, T, seed, eps_int,
    #    step_offset, scalars, gamma, limit, packed, lanes, stream
    lib.gst_iql_chunk.restype = i32
    lib.gst_iql_layout.argtypes = [i32, i32, vp]
    lib.gst_iql_layout.restype = None
    lib.gst_iql_smem_bytes.argtypes = [i32, i32, i32]
    lib.gst_iql_smem_bytes.restype = i32
    lib.gst_iql_shape.argtypes = [vp]
    lib.gst_iql_shape.restype = None
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _host(cfg: EnvConfig):
    """(cached per board) The game description and the number of codes."""
    return sk._game_params(cfg), n_codes(cfg)


def _launch(packed: bool, cfg: EnvConfig, seed: int, eps_int: int, table,
            fields, n_steps: int, gamma: float, step_offset: int,
            lanes: int, scalars, total: int):
    """Launch K8 or K9 at ``lanes`` lanes per block (``scalars``: the
    device tensor of ``scalar_args`` or None), counting the values outside
    ``value_limit(total, n_steps)``.  Its outputs (the six
    planes, the sums, the counts and the stats) and the prep pass's rows
    are one allocation, zeroed where it sums by one memset in the
    launch."""
    from . import iql_codes
    name = "iql_packed_chunk" if packed else "iql_chunk"
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    params, n = _host(cfg)
    B = fields[0].shape[0]
    lay = iql_codes.layout(n, B)
    b64 = torch.empty(lay.total // 8, dtype=torch.int64, device=dev)
    in_ptrs = sk.ptr_array(fields)
    rc = _library().gst_iql_chunk(
        dev.index, ctypes.addressof(in_ptrs), b64.data_ptr(),
        table.data_ptr(), ctypes.addressof(params), n, B, n_steps,
        seed & sk.M32, eps_int, step_offset,
        None if scalars is None else scalars.data_ptr(), lk._f32(gamma),
        value_limit(total, n_steps), int(packed), lanes,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{_library().gst_error_string(rc).decode()} "
                           f"({rc})")
    launch_counts[name] += 1
    b32 = b64.view(torch.int32)
    return (b32.as_strided((6, B), (B, 1), lay.fields // 4).unbind(0),
            (b64.as_strided((n, IQL_COLS), (IQL_COLS, 1), 0),
             b32.as_strided((n, IQL_COLS), (IQL_COLS, 1), lay.cnt // 4)),
            b64.as_strided((4,), (1,), lay.stats // 8).unbind())


# ----------------------------------------------------------------------
# Chunked trainer
# ----------------------------------------------------------------------

def schedule(seed: int, start_chunk: int, end_chunk: int, chunk_len: int,
             lr_at, eps_int_at, device) -> dispatch.Schedule:
    """A grouped IQL or turn-based Q run's schedule: chunk k's lr
    (``lr_at(k)``, a float32 value) and its scalars (seed * 1_000_003 + k,
    ``eps_int_at(k)``, k * chunk_len), the per-chunk mode's values.  The
    kernel cannot check them when it runs, so they are checked here, before
    the first chunk, as the per-chunk mode checks each chunk's."""
    ks = range(start_chunk, end_chunk)
    ints = [(seed * 1_000_003 + k, eps_int_at(k), k * chunk_len) for k in ks]
    for _, eps_int, offset in ints:
        if not 0 <= eps_int <= EPS_ONE:
            raise ValueError(f"eps_int must lie in [0, {EPS_ONE}], got "
                             f"{eps_int}")
        if offset + chunk_len >= 2 ** 31:
            raise ValueError(f"steps [{offset}, {offset + chunk_len}) must "
                             "lie in [0, 2**31)")
    return dispatch.Schedule([(lr_at(k),) for k in ks], ints, device)


def fused_iql_train(cfg: EnvConfig, batch: int, n_chunks: int,
                    chunk_len: int = 64, lr: float = 0.3,
                    gamma: float = 0.99, eps: float = 0.3,
                    eps_min: float = 0.0, eps_halflife: int = 0,
                    lr_anneal_start: int = 0, lr_anneal_tau: float = 0.0,
                    lr_anneal_pow: float = 1.0, seed: int = 0,
                    init: tuple | None = None, mesh=None,
                    start_chunk: int = 0, fields_init: tuple | None = None,
                    return_state: bool = False,
                    packed: bool | None = None,
                    chunks_per_dispatch: int = 1,
                    device="cuda", timing: dict | None = None):
    """Chunked fused independent-Q self-play.  Returns (q_a, q_b,
    stats_history), tensors on ``device``; the arguments mean what they
    mean in the JAX package (gym_soccer_tpu/ops/iql_kernel.py
    ``fused_iql_train``):

    * chunk k runs with seed ``seed * 1_000_003 + k``, its steps numbered
      from ``k * chunk_len``, eps_int = round(eps_k * 65536) with eps_k =
      max(eps * 0.5**(k * chunk_len / eps_halflife), eps_min) on the host
      in float64, and lr_k = lr * (1 + max(0, k - lr_anneal_start) /
      lr_anneal_tau) ** -lr_anneal_pow rounded to float32;
    * ``packed`` (default True) runs K8 and completes the TD sums with
      cnt * (max q - q) between chunks; False runs K9.  Both step the same
      trajectories;
    * between chunks: q += lr_k * sum_td / max(cnt, 1) for both players,
      then a repack;
    * ``init``: (q_a, q_b) warm start, tensors or numpy arrays;
    * ``return_state=True`` adds a fourth element, the resume dict (q_a,
      q_b, fields, next_chunk, packed); ``init``/``fields_init``/
      ``start_chunk`` from it continue bit for bit like an uninterrupted
      run;
    * ``stats_history`` holds (reward_sum, goals, truncs) of every 16th
      chunk and of the last, or of every chunk in the grouped mode;
    * ``chunks_per_dispatch`` = g > 1: the grouped mode, g chunks and the
      work after each as one CUDA-graph replay on the card (ops/dispatch),
      with the per-chunk mode's host schedule (lr_k, and eps_int and the
      step offset beside the seed) read from tables on the device: the
      same q and fields bit for bit (the JAX package's grouped mode rounds
      eps_int in the graph, within one count of these);
    * ``mesh`` (parallel/mesh ``env_mesh``): data-parallel training over
      the global ``batch``, each rank on its block of the lanes with its
      shard seed and the sums, counts and stats all-reduced
      (``sharded_iql_chunk_fn``), as in
      ``learner_kernel.fused_minimax_train``.

    On a CUDA device every chunk launches K8 (or K9), and no chunk waits
    for the one before: the chunks' out-of-range counts (see
    ``iql_packed_chunk``) are summed on the device and read once, at the
    end, and a run in which any value left the int64 sums' exact range
    raises ValueError.  ``timing``, if a dict, is filled with the time
    spent in chunk calls and between them (the per-chunk mode), or with
    ``dispatch.run``'s capture, replay and remainder times.
    """
    g = dispatch.group_size(n_chunks, False, chunks_per_dispatch)
    lk._check_seeds(seed, start_chunk, start_chunk + n_chunks)
    if packed is None:
        packed = True
    device = lk._trainer_device(device, mesh)
    nS = tables.build_statespace(cfg).nS
    if init is None:
        q_a = torch.zeros((nS, N_ACTIONS), dtype=torch.float32, device=device)
        q_b = torch.zeros_like(q_a)
    else:
        q_a, q_b = (lk._float_tensor(x, device) for x in init)
        for q in (q_a, q_b):
            if tuple(q.shape) != (nS, N_ACTIONS):
                raise ValueError(f"init q_a and q_b must be [{nS}, 5]")
    if fields_init is None:
        fields = init_iql_state_fields(cfg, batch, device)
    else:
        fields = tuple(torch.as_tensor(f, dtype=torch.int32, device=device)
                       for f in fields_init)
    if mesh is None:
        chunk_fn = iql_packed_chunk if packed else iql_chunk

        def chunk(seed, eps_int, m, fields, step_offset):
            return chunk_fn(cfg, seed, eps_int, m, fields, batch, chunk_len,
                            gamma, step_offset)
    else:   # the global batch's fields, or the rank's own from a resume
        from ..parallel import mesh as pmesh
        chunk = pmesh.sharded_iql_chunk_fn(cfg, mesh, batch, chunk_len, gamma,
                                           packed)
        if fields_init is None:
            fields = pmesh.shard_fields(fields, mesh, batch)

    def between(q_a, q_b, acc, lr_now):
        sum_a, cnt_a, sum_b, cnt_b = _unpack(cfg, acc)
        if packed:
            sum_a = sum_a + cnt_a * (q_a.max(-1).values[:, None] - q_a)
            sum_b = sum_b + cnt_b * (q_b.max(-1).values[:, None] - q_b)
        q_a = q_a + lr_now * sum_a / cnt_a.clamp_min(1.0)
        q_b = q_b + lr_now * sum_b / cnt_b.clamp_min(1.0)
        return q_a, q_b, pack_iql_table(cfg, q_a, q_b)

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

    m = pack_iql_table(cfg, q_a, q_b)
    end_chunk = start_chunk + n_chunks
    if g is not None:
        sched = schedule(seed, start_chunk, end_chunk, chunk_len,
                         lambda k: lk._f32(lr_at(k)),
                         lambda k: int(round(eps_at(k) * 65536)), device)
        carry = [t.clone() for t in (*fields, q_a, q_b, m)]
        *fields, q_a, q_b, m = carry
        fields = tuple(fields)

        def body():
            lr, ints = sched.row()
            new_fields, acc, stats = chunk(ints, None, m, fields, 0)
            new = between(q_a, q_b, acc, lr[0])
            for dst, src in zip((*fields, q_a, q_b, m), (*new_fields, *new)):
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
            q_a, q_b, m = between(q_a, q_b, acc, lk._f32(lr_at(k)))
            out_of_range = out_of_range + stats[3]
            if k % 16 == 0 or k == end_chunk - 1:
                history.append(stats[:3])
        clock.finish()
        history = [tuple(int(x) for x in row) for row in history]
    if int(out_of_range):
        raise ValueError(
            f"{int(out_of_range)} values left +-{value_limit(batch, chunk_len)}"
            f": the int64 fixed-point sums could overflow (batch * chunk_len "
            f"= {batch * chunk_len}, max|q| up to "
            f"{float(max(q_a.abs().max(), q_b.abs().max()))})")
    if return_state:
        return q_a, q_b, history, {"q_a": q_a, "q_b": q_b, "fields": fields,
                                   "next_chunk": end_chunk, "packed": packed}
    return q_a, q_b, history
