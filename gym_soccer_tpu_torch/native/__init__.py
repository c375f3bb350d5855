"""Native (C++) host components of the port, loaded with ctypes.

The port's copies of gym_soccer_tpu/native's two sources
(``tables_builder.cc``, ``mt19937_stream.cc``: byte for byte, apart from
one comment that names the reference's file by its path in the reference
repo rather than on a local disk; tests/test_torch_native.py compares
the files), and a loader like the JAX package's:

* ``mt19937_streams``: threaded batched MT19937 streams, each row equal to
  numpy's ``RandomState(seed).random_sample(n)`` (used by
  ``core/parity.gen_streams``);
* ``build_tables_arrays``: the threaded transition-table builder, filling
  the padded tensors of ``core/tables`` byte for byte (used by
  ``core/tables.build_tables``; the numpy builder is the fallback and the
  oracle).

Each library is compiled by ``g++ -O3 -shared -fPIC -pthread`` at its
first use, into ``build/gym_soccer_tpu_torch/native/`` at the root of the
checkout, named by a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is not.  A build writes a process-unique
temporary file and renames it into place, so processes racing on a first
build each load a whole library.  A failed build or load is remembered for
the life of the process, and the functions then return None (callers fall
back to numpy).  Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCES = Path(__file__).resolve().parent
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "gym_soccer_tpu_torch" / "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def library_path(name: str) -> Path:
    """Where library ``name`` (from ``name``.cc) is built, keyed on its
    source and the compiler flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SOURCES / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless a build of the same source exists.
    Raises RuntimeError with the compiler's output if g++ fails."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCES / f"{name}.cc"), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=180)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _load(name: str, configure) -> ctypes.CDLL | None:
    """Build (if needed) and load ``name``, declaring its prototypes with
    ``configure(lib)``; None if either fails.  Cached, failure included,
    so each library is tried once a process."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None
        try:
            lib = ctypes.CDLL(str(build(name)))
            configure(lib)
        except (RuntimeError, OSError, AttributeError,
                subprocess.TimeoutExpired):
            # no compiler, a failed build, or a library lacking the
            # expected symbols: the callers fall back to numpy
            return None
        _libs[name] = lib
        return lib


def _cfg_mt19937(lib):
    lib.mt19937_gen_streams.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.mt19937_gen_streams.restype = None


def _cfg_tables(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.soccer_build_tables.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f64p, ctypes.c_int64, i32p, i32p, u8p, f64p,
        f64p, f64p, i32p, i32p, f64p, u8p, u8p, i32p, ctypes.c_int32]
    lib.soccer_build_tables.restype = None


def _default_threads() -> int:
    # oversubscribe a little: bursty/stolen vCPUs (common on shared
    # hosts) schedule better with more runnable threads
    return min(2 * (os.cpu_count() or 1), 16)


def have_native() -> bool:
    """Whether the MT19937 stream library builds and loads."""
    return _load("mt19937_stream", _cfg_mt19937) is not None


def have_native_tables() -> bool:
    """Whether the table-builder library builds and loads."""
    return _load("tables_builder", _cfg_tables) is not None


def mt19937_streams(seeds, n_draws: int,
                    n_threads: int | None = None) -> np.ndarray | None:
    """[B, n_draws] float64 streams identical to numpy's
    RandomState(seed).random_sample(n_draws) per row, or None if the
    native library is unavailable (callers fall back to numpy)."""
    lib = _load("mt19937_stream", _cfg_mt19937)
    if lib is None:
        return None
    seeds = np.ascontiguousarray(np.asarray(seeds, dtype=np.uint64))
    out = np.empty((len(seeds), n_draws), dtype=np.float64)
    lib.mt19937_gen_streams(
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(seeds), n_draws,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(n_threads if n_threads is not None else _default_threads()))
    return out


def build_tables_arrays(W: int, H: int, gr_lo: int, gr_hi: int,
                        combo_probs, dense_to_raw, raw_to_dense,
                        goal_mask_raw, goal_reward_raw,
                        n_threads: int | None = None) -> dict | None:
    """Fill the padded transition tensors (see core/tables.GameTables) for
    the given state space; byte-identical to the numpy builder.  Returns a
    dict of arrays, or None if the native library is unavailable."""
    lib = _load("tables_builder", _cfg_tables)
    if lib is None:
        return None
    mp = np.ascontiguousarray(np.asarray(combo_probs, np.float64))
    d2r = np.ascontiguousarray(np.asarray(dense_to_raw, np.int32))
    r2d = np.ascontiguousarray(np.asarray(raw_to_dense, np.int32))
    gmask = np.ascontiguousarray(
        np.asarray(goal_mask_raw, bool).view(np.uint8))
    grew = np.ascontiguousarray(np.asarray(goal_reward_raw, np.float64))
    nS = int(d2r.shape[0])
    if mp.shape != (9,) or not (r2d.shape == gmask.shape == grew.shape):
        raise ValueError("combo_probs must hold 9 entries, and the raw "
                         "maps one entry per raw code each")

    shape = (nS, 25, 36)
    out = {
        "t_prob": np.empty(shape, np.float64),
        "t_cum": np.empty(shape, np.float64),
        "t_next_raw": np.empty(shape, np.int32),
        "t_next_dense": np.empty(shape, np.int32),
        "t_reward": np.empty(shape, np.float64),
        "t_done": np.empty(shape, bool),
        "t_mask": np.empty(shape, bool),
        "t_first": np.empty((nS, 25), np.int32),
    }

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    lib.soccer_build_tables(
        int(W), int(H), int(gr_lo), int(gr_hi),
        ptr(mp, ctypes.c_double), nS,
        ptr(d2r, ctypes.c_int32), ptr(r2d, ctypes.c_int32),
        ptr(gmask, ctypes.c_uint8), ptr(grew, ctypes.c_double),
        ptr(out["t_prob"], ctypes.c_double),
        ptr(out["t_cum"], ctypes.c_double),
        ptr(out["t_next_raw"], ctypes.c_int32),
        ptr(out["t_next_dense"], ctypes.c_int32),
        ptr(out["t_reward"], ctypes.c_double),
        ptr(out["t_done"].view(np.uint8), ctypes.c_uint8),
        ptr(out["t_mask"].view(np.uint8), ctypes.c_uint8),
        ptr(out["t_first"], ctypes.c_int32),
        int(n_threads if n_threads is not None else _default_threads()))
    return out
