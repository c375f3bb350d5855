"""Tracing, profiling and throughput instrumentation: the port of
gym_soccer_tpu/utils/profiling.py.

* `phase(name)` — wall-clock phase timer with a structured summary;
* `Throughput` — env-steps/s counter for rollout and training loops;
* `trace(dir)` — a ``torch.profiler`` trace (CPU and CUDA activity) around
  a hot section, written as a Chrome trace (view in Perfetto or
  chrome://tracing);
* `log_json` — one structured log line.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

import torch

_PHASES: List[dict] = []


@contextlib.contextmanager
def phase(name: str, sync: bool = True):
    """Time a phase; with ``sync``, wait for the CUDA device's queued work
    before stopping the clock (otherwise asynchronous launches make the
    timings meaningless).  Nothing is waited for where no CUDA context
    exists."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _PHASES.append({"phase": name, "seconds": round(dt, 4)})


def phase_report(clear: bool = True) -> List[dict]:
    out = list(_PHASES)
    if clear:
        _PHASES.clear()
    return out


class Throughput:
    """Steps/s counter: `tick(n_steps)` after each timed chunk."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n_env_steps: int) -> None:
        self.steps += int(n_env_steps)

    @property
    def per_second(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {"env_steps": self.steps,
                "env_steps_per_s": round(self.per_second)}


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace around a hot region: CPU activity, and CUDA
    activity where a CUDA device is present; written to
    ``log_dir/trace.json`` on exit.  Yields the profiler (its
    ``key_averages()`` summarise the region)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def log_json(**fields) -> None:
    """One structured log line (the framework's observability contract)."""
    print(json.dumps(fields, sort_keys=True), flush=True)
