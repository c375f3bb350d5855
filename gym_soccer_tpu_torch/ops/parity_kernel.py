"""Bit-exact reference trajectories in event time: CUDA kernels K12/K13 and
their plain versions.

The port of gym_soccer_tpu/ops/parity_kernel.py.  Two public wrappers:

* ``parity_events``: closed loop.  Each lane plays the joint row
  ``jr[raw state]`` (``jointrow_raw``) on the reference env seeded
  ``RandomState(seeds[i])``, one MT19937 draw per EVENT (a reset or a
  transition).  Replaces the Pallas kernel's closed-loop call (K12).
* ``parity_scripted_events``: each lane's k-th transition plays
  ``rows[k, lane]``, row 0 past the script's end; resets spend a draw but
  no script row.  Replaces the scripted call (K13).

Both return a ``ParityEventsOut``: one packed int32 journal word per event
and lane ([n_events, B], decoded by ``unpack_journal``) and the lanes'
final state as eight int32 [B] planes.  Lanes are flat (lane i is the JAX
package's lane row * 128 + col).

The plain versions compose the tensor twins: ``mt19937.device_streams``
then ``parity.parity_event_step`` per event, then the journal packing; they
are independent of the kernel's threshold classes, so holding one against
the other checks the class design.  A wrapper runs the plain version when
its tensors lie on the CPU and launches the CUDA kernel
(``csrc/parity_kernel.cu``) when they lie on a CUDA device; there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import EnvConfig, N_ACTIONS
from ..core import mt19937, parity, rules, tables
from . import step_kernel as sk

LANES = 128            # the JAX wrappers tile lanes as [B/128, 128]
N_CODES = 3 ** 9       # base-3 outcome-count pattern codes of 9 combos
MAX_CLASSES = 512
M32 = 0xFFFFFFFF

# Launches of each CUDA kernel in this process, counted by the wrappers
# where they launch and nowhere else.
launch_counts = {"parity_events": 0, "parity_scripted_events": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class ParityKernelTables(NamedTuple):
    """Host-side (numpy) constants of the kernel for one EnvConfig."""
    n_raw: int
    occ_codes: tuple         # occurring base-3 pattern codes, sorted
    cls_cum: np.ndarray      # [P, 36] float64: each class's thresholds
    code_class: np.ndarray   # [3**9] int16: class of each code (0 if none)
    isd_cum: np.ndarray      # [nI] float64 ISD cumulative thresholds
    isd_fields: np.ndarray   # [nI, 5] int32 ISD states (ra, ca, rb, cb, p)


@functools.lru_cache(maxsize=None)
def build_pk(cfg: EnvConfig) -> ParityKernelTables:
    """Build (cached) the kernel's class tables, verifying that the pattern
    code determines the cumulative row, which the class design rests on."""
    if cfg.n_raw >= 1 << 15:
        raise ValueError(
            f"grid too large for the parity kernel's journal packing "
            f"(n_raw={cfg.n_raw} needs >=15 bits); use core/parity.py")
    tb = tables.build_tables(cfg)

    # Outcome-count digits per combo.  t_mask folds in (combo_prob != 0),
    # so dropped combos get count 0 -> digit 0: the kernel's static masking
    # of zero-probability combos.
    counts = tb.t_mask.reshape(-1, 9, 4).sum(-1)
    digits = np.select([counts == 2, counts == 4], [1, 2], 0)
    code = (digits * (3 ** np.arange(9))).sum(-1)          # [nS*25]
    cum = tb.t_cum.reshape(-1, 36)

    occ, first = np.unique(code, return_index=True)
    for c, f in zip(occ, first):
        rows = cum[code == c]
        if not (rows == rows[0]).all():
            raise AssertionError(
                "pattern code does not determine the cum row "
                f"(code {c}) — parity kernel invariant broken")
    if 0 not in occ:
        raise AssertionError("absorbing pattern (code 0) missing from tables")
    if len(occ) > MAX_CLASSES:
        raise ValueError(f"too many threshold classes ({len(occ)})")
    code_class = np.zeros(N_CODES, np.int16)
    code_class[occ] = np.arange(len(occ))
    return ParityKernelTables(
        n_raw=cfg.n_raw,
        occ_codes=tuple(int(c) for c in occ),
        cls_cum=np.ascontiguousarray(cum[first]),
        code_class=code_class,
        isd_cum=np.cumsum(tb.isd_probs),
        isd_fields=tables.isd_fields(cfg),
    )


def jointrow_raw(cfg: EnvConfig, pol_a, pol_b) -> np.ndarray:
    """Precompose the closed-loop joint table row pol_a[s]*5 + pol_b[s]
    over RAW codes (int32 [n_raw]; goal and unreachable states read dense
    0).  Single-agent (frozen-opponent) runs are the same thing: the
    collapsed table's row for (s, aa) is the joint row (aa, frozen[s])."""
    r2d = np.maximum(tables.build_statespace(cfg).raw_to_dense, 0)
    pa = np.asarray(pol_a, np.int64)[r2d]
    pb = np.asarray(pol_b, np.int64)[r2d]
    return (pa * N_ACTIONS + pb).astype(np.int32)


class ParityEventsOut(NamedTuple):
    journal: torch.Tensor      # [n_events, B] int32 packed (unpack_journal)
    rows_a: torch.Tensor       # final per-lane state fields, int32 [B]
    cols_a: torch.Tensor
    rows_b: torch.Tensor
    cols_b: torch.Tensor
    poss: torch.Tensor
    t: torch.Tensor
    needs_reset: torch.Tensor
    steps: torch.Tensor        # transition events completed per lane


def unpack_journal(journal: torch.Tensor) -> dict:
    """Packed event words -> dict of int32 tensors on the journal's device.
    Word layout: raw | done << 15 | trunc << 16 | was_reset << 17 |
    (reward_a + 1) << 18."""
    j = torch.as_tensor(journal)
    return {
        "raw": j & 0x7FFF,
        "done": (j >> 15) & 1,
        "truncated": (j >> 16) & 1,
        "was_reset": (j >> 17) & 1,
        "reward_a": ((j >> 18) & 3) - 1,
    }


# ----------------------------------------------------------------------
# Arguments
# ----------------------------------------------------------------------

def _seeds(seeds, device) -> torch.Tensor:
    """[B] seeds (taken mod 2**32) as int64 on ``device``; B % 128 == 0."""
    s = torch.as_tensor(seeds, device=device)
    if s.ndim != 1 or s.shape[0] == 0 or s.shape[0] % LANES:
        raise ValueError(f"seeds must be [B] with B a positive multiple of "
                         f"{LANES}, got shape {tuple(s.shape)}")
    return s.to(torch.int64) & M32


def _check_events(n_events: int) -> None:
    if n_events < 0 or n_events >= 2**31:
        raise ValueError(f"n_events must lie in [0, 2**31), got {n_events}")


def _jr(cfg: EnvConfig, jr, device) -> torch.Tensor:
    jr = torch.as_tensor(jr, device=device).to(torch.int32).contiguous()
    if tuple(jr.shape) != (cfg.n_raw,):
        raise ValueError(f"jr must be [{cfg.n_raw}] (jointrow_raw), got "
                         f"{tuple(jr.shape)}")
    return jr


def _pol_rows(cfg: EnvConfig, jr: torch.Tensor) -> torch.Tensor:
    """The dense-observation rows [nS] of a raw-code row table."""
    d2r = torch.as_tensor(tables.build_statespace(cfg).dense_to_raw,
                          device=jr.device).long()
    return jr[d2r].long()


def _script(rows, B: int, device) -> torch.Tensor:
    rows = torch.as_tensor(rows, device=device)
    if rows.ndim != 2 or rows.shape[1] != B:
        raise ValueError(f"rows must be [T, {B}], got {tuple(rows.shape)}")
    return rows.to(torch.int32).contiguous()


# ----------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------

def _plain(cfg: EnvConfig, seeds: torch.Tensor, n_events: int,
           pol_rows=None, script=None) -> ParityEventsOut:
    """Event loop of the tensor twins: closed loop on ``pol_rows`` [nS], or
    scripted on ``script`` [T, B]."""
    dev = seeds.device
    B = seeds.shape[0]
    pt = parity.parity_tables(cfg)
    hi, lo = mt19937.device_streams(seeds, n_events, dev)
    st = parity.parity_init(cfg, B, dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    journal = torch.empty((n_events, B), dtype=torch.int32, device=dev)
    if script is not None:
        T = script.shape[0]
        padded = torch.cat([script, torch.zeros_like(script[:1])])
        lane = torch.arange(B, device=dev)
    for k in range(n_events):
        row = None
        if script is not None:
            row = padded[steps.clamp(max=T).long(), lane]
        nr = st.needs_reset.to(torch.int32)
        st, ev = parity.parity_event_step(cfg, pt, st, pol_rows, hi[:, k],
                                          lo[:, k], row=row)
        journal[k] = (ev.raw | (ev.done.to(torch.int32) << 15)
                      | (ev.truncated.to(torch.int32) << 16) | (nr << 17)
                      | ((ev.reward_a.to(torch.int32) + 1) << 18))
        steps += 1 - nr
    fields = rules.raw_decode(torch, st.raw, cfg)
    return ParityEventsOut(journal, *(f.to(torch.int32) for f in fields),
                           st.t, st.needs_reset.to(torch.int32), steps)


def parity_events_plain(cfg: EnvConfig, seeds, jr, n_events: int,
                        device) -> ParityEventsOut:
    """Plain PyTorch version of ``parity_events``, on any device."""
    build_pk(cfg)  # the kernel's checks, so both paths refuse alike
    _check_events(n_events)
    seeds = _seeds(seeds, device)
    return _plain(cfg, seeds, n_events,
                  pol_rows=_pol_rows(cfg, _jr(cfg, jr, seeds.device)))


def parity_scripted_events_plain(cfg: EnvConfig, seeds, rows, n_events: int,
                                 device) -> ParityEventsOut:
    """Plain PyTorch version of ``parity_scripted_events``, on any
    device."""
    build_pk(cfg)
    _check_events(n_events)
    seeds = _seeds(seeds, device)
    return _plain(cfg, seeds, n_events,
                  script=_script(rows, seeds.shape[0], seeds.device))


# ----------------------------------------------------------------------
# Public wrappers
# ----------------------------------------------------------------------

def parity_events(cfg: EnvConfig, seeds, jr, n_events: int, device,
                  threads: int = 128) -> ParityEventsOut:
    """Run ``n_events`` reference-exact events for ``len(seeds)`` lanes.

    ``seeds``: [B] integers; lane i reproduces the reference env seeded
    ``RandomState(seeds[i])``.  ``jr``: int32 [n_raw] joint-row table from
    `jointrow_raw`.  B must be a multiple of 128.  ``threads`` is the CUDA
    block size (a multiple of 32); it does not change the result.

    On a CPU device this runs ``parity_events_plain``; on a CUDA device it
    launches the K12 kernel.
    """
    seeds = _seeds(seeds, device)
    if seeds.device.type == "cpu":
        return parity_events_plain(cfg, seeds, jr, n_events, "cpu")
    pk = build_pk(cfg)
    _check_events(n_events)
    return _launch("parity_events", cfg, pk, seeds,
                   _jr(cfg, jr, seeds.device), n_events, threads)


def parity_scripted_events(cfg: EnvConfig, seeds, rows, n_events: int,
                           device, threads: int = 128) -> ParityEventsOut:
    """SCRIPTED bit-exact parity rollout (the golden-fixture harness shape:
    one host-chosen action row per step, soccer_simultaneous_env.py:394-396).

    ``rows``: int32 [T, B] per-step joint-row script (aa*5+ab, or the
    single-agent action; the convention of core/parity.parity_rollout,
    which this reproduces event for event: lane i's k-th transition plays
    rows[k, i]; interleaved reset draws advance the MT19937 stream but not
    the script cursor).  Run enough events to cover the script: n_events >=
    T + (resets incurred); the returned per-lane ``steps`` says how many
    script rows were consumed; lanes past the script's end play row 0.

    On a CPU device this runs ``parity_scripted_events_plain``; on a CUDA
    device it launches the K13 kernel.
    """
    seeds = _seeds(seeds, device)
    if seeds.device.type == "cpu":
        return parity_scripted_events_plain(cfg, seeds, rows, n_events, "cpu")
    pk = build_pk(cfg)
    _check_events(n_events)
    return _launch("parity_scripted_events", cfg, pk, seeds,
                   _script(rows, seeds.shape[0], seeds.device), n_events,
                   threads)


# ----------------------------------------------------------------------
# CUDA launch (K12, K13)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signature declared."""
    from . import _build
    lib = _build.load("parity_kernel")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gst_parity_events.argtypes = [
        i32, i32, vp, vp, vp, i32,   # device, scripted, seeds, mt, rows, T
        vp, i32, vp, vp, vp, i32,    # cls_cum, P, code_class, params,
        #                              isd_cum, combo_mask
        vp, vp, i32, i32, i32, vp]   # journal, out, B, n_events, threads,
    #                                  stream
    lib.gst_parity_events.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _device_pk(cfg: EnvConfig, device: torch.device):
    pk = build_pk(cfg)
    return (torch.as_tensor(pk.cls_cum, device=device),
            torch.as_tensor(pk.code_class, device=device))


@functools.lru_cache(maxsize=None)
def _host_params(cfg: EnvConfig):
    """The kernel's game description (H, W, goal-row bounds, an unused
    slip word, max_steps, nI, ISD fields), the ISD thresholds and the mask
    of combos with non-zero probability."""
    pk = build_pk(cfg)
    lo, hi = cfg.goal_row_bounds
    vals = [cfg.H, cfg.W, lo, hi, 0, cfg.max_steps, len(pk.isd_cum),
            *pk.isd_fields.ravel().tolist()]
    mask = sum(1 << c for c, q in enumerate(cfg.combo_probs()) if q != 0.0)
    return ((ctypes.c_int32 * len(vals))(*vals),
            (ctypes.c_double * len(pk.isd_cum))(*pk.isd_cum.tolist()), mask)


def _launch(name: str, cfg: EnvConfig, pk: ParityKernelTables,
            seeds: torch.Tensor, rows: torch.Tensor, n_events: int,
            threads: int) -> ParityEventsOut:
    dev = seeds.device
    sk.check_threads(name, dev, threads)
    lib = _library()
    B = seeds.shape[0]
    # uint32 seed bits in an int32 buffer
    seeds32 = torch.where(seeds >= 2**31, seeds - 2**32, seeds).to(
        torch.int32)
    mt = torch.empty((mt19937.N, B), dtype=torch.int32, device=dev)
    journal = torch.empty((n_events, B), dtype=torch.int32, device=dev)
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(8)]
    out_ptrs = (ctypes.c_void_p * 8)(*(o.data_ptr() for o in out))
    cls_cum, code_class = _device_pk(cfg, dev)
    params, isd_cum, mask = _host_params(cfg)
    scripted = name == "parity_scripted_events"
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gst_parity_events(
        dev.index, int(scripted), seeds32.data_ptr(), mt.data_ptr(),
        rows.data_ptr(), rows.shape[0] if scripted else 0,
        cls_cum.data_ptr(), cls_cum.shape[0], code_class.data_ptr(),
        ctypes.addressof(params), ctypes.addressof(isd_cum), mask,
        journal.data_ptr(), ctypes.addressof(out_ptrs), B, n_events, threads,
        stream)
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    launch_counts[name] += 1
    return ParityEventsOut(journal, *out)
