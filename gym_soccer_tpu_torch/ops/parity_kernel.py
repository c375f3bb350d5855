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
are independent of the kernel's tables, so holding one against the other
checks the table design.  A wrapper runs the plain version when its
tensors lie on the CPU and launches the CUDA kernel
(``csrc/parity_kernel.cu``) when they lie on a CUDA device; there is no
fallback from one to the other.

The kernel steps a lane by table lookup (`build_lookup`): a lane's state
is one packed word (`pack_word`) whose key picks its row of the class and
next-word tables, so an event is a class lookup, a search of the class's
thresholds and one next-word load.  Closed loop, a prep kernel launched
with K12 (its plain twin: `closed_tables`) gathers the tables by ``jr``
into raw-indexed form, with each next word's key the class of the state
it names, so the class lookup disappears.  Each block keeps its lanes'
MT19937 states and the class thresholds in shared memory; `smem_bytes`
and `lanes_per_block` give the budget and the block size.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import EnvConfig, N_ACTIONS
from ..core import mt19937, parity, rules, tables

LANES = 128            # the JAX wrappers tile lanes as [B/128, 128]
N_CODES = 3 ** 9       # base-3 outcome-count pattern codes of 9 combos
MAX_CLASSES = 512
M32 = 0xFFFFFFFF
N_ROWS = N_ACTIONS * N_ACTIONS
N_SLOTS = 36
# A class's row in shared memory: 36 float64 thresholds, then its fallback
# slot (an odd stride of doubles spreads the classes over the banks).
CLASS_STRIDE = N_SLOTS + 1
SMEM_BUDGET = 232_448  # dynamic shared memory a block may use on an H100
MT_BYTES = 624 * 4     # one lane's MT19937 state
MAX_LANES_PER_BLOCK = 64  # 128 blocks or more at 8192 lanes (132 SMs)

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


def _pattern_codes(tb: tables.GameTables) -> np.ndarray:
    """Base-3 outcome-count pattern code of each (dense state, joint row),
    int64 [nS, 25].  t_mask folds in (combo_prob != 0), so dropped combos
    get count 0 -> digit 0: zero-probability combos are masked."""
    counts = tb.t_mask.reshape(tb.nS, N_ROWS, 9, 4).sum(-1)
    digits = np.select([counts == 2, counts == 4], [1, 2], 0)
    return (digits * (3 ** np.arange(9))).sum(-1)


@functools.lru_cache(maxsize=None)
def build_pk(cfg: EnvConfig) -> ParityKernelTables:
    """Build (cached) the kernel's class tables, verifying that the pattern
    code determines the cumulative row, which the class design rests on."""
    if cfg.n_raw >= 1 << 15:
        raise ValueError(
            f"grid too large for the parity kernel's journal packing "
            f"(n_raw={cfg.n_raw} needs >=15 bits); use core/parity.py")
    tb = tables.build_tables(cfg)
    code = _pattern_codes(tb).ravel()                      # [nS*25]
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


# ----------------------------------------------------------------------
# The kernel's lookup tables
# ----------------------------------------------------------------------

def pack_word(raw, done, reward, key):
    """A lane's state word: raw | outcome << 15 | key << 17, where the
    2-bit outcome is 0 for a transition that does not end the episode and
    reward + 2 (1, 2 or 3) for one that does; ``key`` (15 bits) picks the
    state's row of the kernel's tables.  Works on numpy arrays and ints."""
    return raw | ((reward + 2) * done) << 15 | key << 17


def unpack_word(w) -> dict:
    """``pack_word``'s fields: raw, done, reward, key."""
    o = (w >> 15) & 3
    return {"raw": w & 0x7FFF, "done": (o != 0) * 1,
            "reward": (o - 2) * (o != 0), "key": (w >> 17) & 0x7FFF}


class ParityLookupTables(NamedTuple):
    """Host-side (numpy) tables of the kernel for one EnvConfig.

    Keys index the table rows: 0..nS-1 are the dense states (key 0 the
    goal state dense 0 stands for), then every other goal state in
    enumeration order, so each goal owns a row and self-loops exactly.
    """
    n_classes: int
    raw_to_key: np.ndarray   # [n_raw] int32 (unreachable states -> 0)
    key_raw: np.ndarray      # [n_keys] int32
    cls: np.ndarray          # [n_keys, 25] int16: class of (key, row)
    next_word: np.ndarray    # [n_keys, 25, 36] int32 (pack_word, key of
    #                          the next state)
    cum: np.ndarray          # [n_classes, 37] float64: thresholds, then
    #                          the fallback slot
    isd_word: np.ndarray     # [nI] int32: the ISD states' words (outcome 0,
    #                          keyed by their table rows)


@functools.lru_cache(maxsize=None)
def build_lookup(cfg: EnvConfig) -> ParityLookupTables:
    """Build (cached) the kernel's lookup tables from core/tables: the
    class and the packed next state of every (key, joint row, slot).  Goal
    states take code 0's class (the reference's absorbing row) and step to
    themselves with done set and reward 0; zero-probability combos are
    masked in the class as in `build_pk`."""
    pk = build_pk(cfg)
    tb = tables.build_tables(cfg)
    nS = tb.nS
    rep = tb.dense_to_raw[0]
    key_raw = np.concatenate([tb.dense_to_raw, tb.goal_raw[tb.goal_raw != rep]]
                             ).astype(np.int32)
    n_keys = len(key_raw)
    raw_to_key = np.zeros(cfg.n_raw, np.int32)
    raw_to_key[key_raw] = np.arange(n_keys, dtype=np.int32)

    cls = np.full((n_keys, N_ROWS), pk.code_class[0], np.int16)
    cls[1:nS] = pk.code_class[_pattern_codes(tb)[1:]]
    nxt = tb.t_next_raw[1:].astype(np.int64)
    done = tb.t_done[1:].astype(np.int64)
    reward = tb.t_reward[1:].astype(np.int64)
    if ((done == 1) & (reward == 0)).any() or (reward[done == 0] != 0).any():
        raise AssertionError("a transition's reward does not follow its goal")
    words = np.empty((n_keys, N_ROWS, N_SLOTS), np.int64)
    words[1:nS] = pack_word(nxt, done, reward, raw_to_key[nxt])
    goals = np.concatenate([[0], np.arange(nS, n_keys)])
    words[goals] = pack_word(key_raw[goals], 1, 0, goals)[:, None, None]

    cum = np.zeros((len(pk.occ_codes), CLASS_STRIDE), np.float64)
    cum[:, :N_SLOTS] = pk.cls_cum
    cum[:, N_SLOTS] = np.minimum((pk.cls_cum == 0).sum(-1), N_SLOTS - 1)
    isd = tb.isd_raw.astype(np.int64)
    return ParityLookupTables(
        n_classes=len(pk.occ_codes), raw_to_key=raw_to_key, key_raw=key_raw,
        cls=cls, next_word=words.astype(np.int32), cum=cum,
        isd_word=pack_word(isd, 0, 0, raw_to_key[isd]).astype(np.int32))


class DeviceLookup(NamedTuple):
    """`build_lookup`'s tables on one device, as the kernel reads them."""
    raw_to_key: torch.Tensor   # [n_raw] int32
    cls: torch.Tensor          # [n_keys * 25] int16
    next_word: torch.Tensor    # [n_keys * 25, 36] int32
    cum: torch.Tensor          # [n_classes, 37] float64
    isd_word: torch.Tensor     # [nI] int32


@functools.lru_cache(maxsize=8)
def device_lookup(cfg: EnvConfig, device: torch.device) -> DeviceLookup:
    """(cached) `build_lookup` on ``device``."""
    lt = build_lookup(cfg)
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return DeviceLookup(
        raw_to_key=on(lt.raw_to_key), cls=on(lt.cls.ravel()),
        next_word=on(lt.next_word.reshape(-1, N_SLOTS)), cum=on(lt.cum),
        isd_word=on(lt.isd_word))


def closed_tables(d: DeviceLookup, jr: torch.Tensor):
    """The closed-loop tables for joint-row table ``jr`` [n_raw] (rows in
    [0, 25), as `_jr` leaves them), on its device: the class of each raw
    state (int16 [n_raw]), its next words (int32 [n_raw, 36]) and the ISD
    words (int32 [nI]), each word keyed by the class of the state it names.
    The plain version of the kernel's closed_prep_kernel, which K12's
    launch runs first."""
    row = d.raw_to_key.long() * N_ROWS + jr.long()
    cls = d.cls[row]
    cls32 = cls.to(torch.int32)

    def by_class(w):
        return (w & 0x1FFFF) | (cls32[(w & 0x7FFF).long()] << 17)

    return cls, by_class(d.next_word[row]).contiguous(), by_class(d.isd_word)


def smem_bytes(lanes: int, n_classes: int) -> int:
    """Dynamic shared memory of one block of ``lanes`` lanes: the class
    rows (37 float64 each), the lanes' MT19937 states and 4 ISD words."""
    return n_classes * CLASS_STRIDE * 8 + lanes * MT_BYTES + 16


def lanes_per_block(n_classes: int, threads=None) -> int:
    """The block size (lanes per block) of a launch: ``threads`` if its
    shared memory fits `SMEM_BUDGET`, else ValueError; by default the
    largest multiple of 32 up to 64 that fits."""
    if threads is None:
        fits = [n for n in range(MAX_LANES_PER_BLOCK, 0, -32)
                if smem_bytes(n, n_classes) <= SMEM_BUDGET]
        if not fits:
            raise ValueError(f"{n_classes} classes leave no room for 32 "
                             f"lanes in {SMEM_BUDGET} B of shared memory")
        return fits[0]
    if not 1 <= threads <= 1024:
        raise ValueError(f"threads must lie in [1, 1024], got {threads}")
    need = smem_bytes(threads, n_classes)
    if need > SMEM_BUDGET:
        raise ValueError(
            f"threads={threads} needs {need} B of shared memory with "
            f"{n_classes} classes; the budget is {SMEM_BUDGET} B a block")
    return threads


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


def _rows(rows: torch.Tensor, device) -> torch.Tensor:
    """Joint rows as int32 on ``device``, each clamped into [0, 25): the
    one place that maps a row outside the table, for the kernels and the
    plain versions alike (a check would cost a sync per call)."""
    return rows.to(device).clamp(0, N_ROWS - 1).to(torch.int32).contiguous()


def _jr(cfg: EnvConfig, jr, device) -> torch.Tensor:
    jr = torch.as_tensor(jr)
    if tuple(jr.shape) != (cfg.n_raw,):
        raise ValueError(f"jr must be [{cfg.n_raw}] (jointrow_raw), got "
                         f"{tuple(jr.shape)}")
    return _rows(jr, device)


def _pol_rows(cfg: EnvConfig, jr: torch.Tensor) -> torch.Tensor:
    """The dense-observation rows [nS] of a raw-code row table."""
    d2r = torch.as_tensor(tables.build_statespace(cfg).dense_to_raw,
                          device=jr.device).long()
    return jr[d2r].long()


def _script(rows, B: int, device) -> torch.Tensor:
    rows = torch.as_tensor(rows)
    if rows.ndim != 2 or rows.shape[1] != B:
        raise ValueError(f"rows must be [T, {B}], got {tuple(rows.shape)}")
    return _rows(rows, device)


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
                  threads=None) -> ParityEventsOut:
    """Run ``n_events`` reference-exact events for ``len(seeds)`` lanes.

    ``seeds``: [B] integers; lane i reproduces the reference env seeded
    ``RandomState(seeds[i])``.  ``jr``: int32 [n_raw] joint-row table from
    `jointrow_raw`; a row outside [0, 25) is clamped into it, on every
    device.  B must be a multiple of 128.  ``threads`` is the CUDA
    block size, the lanes one block runs: by default `lanes_per_block`'s
    choice (64 wherever the classes allow it), else any size in [1, 1024]
    whose shared memory (`smem_bytes`) fits `SMEM_BUDGET`, ValueError
    otherwise; it does not change the result.

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
                           device, threads=None) -> ParityEventsOut:
    """SCRIPTED bit-exact parity rollout (the golden-fixture harness shape:
    one host-chosen action row per step, soccer_simultaneous_env.py:394-396).

    ``rows``: int32 [T, B] per-step joint-row script (aa*5+ab, or the
    single-agent action; the convention of core/parity.parity_rollout,
    which this reproduces event for event: lane i's k-th transition plays
    rows[k, i]; interleaved reset draws advance the MT19937 stream but not
    the script cursor).  Run enough events to cover the script: n_events >=
    T + (resets incurred); the returned per-lane ``steps`` says how many
    script rows were consumed; lanes past the script's end play row 0.
    A row outside [0, 25) is clamped into it, on every device.
    ``threads`` as in `parity_events`.

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
    return declare(_build.load("parity_kernel"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a build of ``csrc/parity_kernel.cu``."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gst_parity_events.argtypes = [
        i32, i32, vp, vp, i32,       # device, scripted, seeds, rows, T
        vp, vp, vp, i32,             # raw_to_key, cls, words, n_raw
        vp, i32,                     # cum, n_classes
        vp, vp, i32, vp,             # isd_word, isd_cum, nI, prepared
        i32, i32, i32,               # H, W, max_steps
        vp, vp, i32, i32, i32, vp]   # journal, out, B, n_events, threads,
    #                                  stream
    lib.gst_parity_events.restype = i32
    lib.gst_parity_smem_bytes.argtypes = [i32, i32]
    lib.gst_parity_smem_bytes.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, cfg: EnvConfig, pk: ParityKernelTables,
            seeds: torch.Tensor, rows: torch.Tensor, n_events: int,
            threads) -> ParityEventsOut:
    """Launch K12 (closed loop, ``rows`` the jr table) or K13 (scripted,
    ``rows`` the script).  K12's launch first runs a prep kernel that
    gathers its raw-indexed next words and its ISD words (`closed_tables`)
    into a scratch tensor."""
    dev = seeds.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    lanes = lanes_per_block(len(pk.occ_codes), threads)
    lib = _library()
    B = seeds.shape[0]
    # uint32 seed bits in an int32 buffer
    seeds32 = torch.where(seeds >= 2**31, seeds - 2**32, seeds).to(
        torch.int32)
    journal = torch.empty((n_events, B), dtype=torch.int32, device=dev)
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(8)]
    out_ptrs = (ctypes.c_void_p * 8)(*(o.data_ptr() for o in out))
    d = device_lookup(cfg, dev)
    scripted = name == "parity_scripted_events"
    prepared = (None if scripted else
                torch.empty(cfg.n_raw * N_SLOTS + len(pk.isd_cum),
                            dtype=torch.int32, device=dev))
    isd_cum = (ctypes.c_double * len(pk.isd_cum))(*pk.isd_cum.tolist())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gst_parity_events(
        dev.index, int(scripted), seeds32.data_ptr(), rows.data_ptr(),
        rows.shape[0] if scripted else 0, d.raw_to_key.data_ptr(),
        d.cls.data_ptr(), d.next_word.data_ptr(), cfg.n_raw,
        d.cum.data_ptr(), d.cum.shape[0], d.isd_word.data_ptr(),
        ctypes.addressof(isd_cum), len(pk.isd_cum),
        None if scripted else prepared.data_ptr(), cfg.H, cfg.W,
        cfg.max_steps, journal.data_ptr(), ctypes.addressof(out_ptrs), B,
        n_events, lanes, stream)
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.gst_error_string(rc).decode()} ({rc})")
    launch_counts[name] += 1
    return ParityEventsOut(journal, *out)
