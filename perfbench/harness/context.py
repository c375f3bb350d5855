"""What a run carries from set-up through the window to the checks and
the per-layer readers."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .trace import Tracer


@dataclass
class Check:
    """One number compared with its limit; it passes when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclass
class Unit:
    """One unit of a window's work (a call, a training, a contract), with
    the harness's host spans in it and whatever its kind keeps."""
    index: int
    traced: bool
    spans: dict = field(default_factory=dict)     # span name -> seconds
    data: dict = field(default_factory=dict)


class Context:
    def __init__(self, cell, seed: int, device, program, trace: bool = False,
                 overrides: dict | None = None):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.program = program
        self.params = {**cell.params, **(overrides or {})}
        self.tracer = Tracer() if trace else None
        self.units: list[Unit] = []
        self.state: dict = {}
        self.end_to_end: dict = {}
        self.window_s = self.check_s = 0.0

    # -- seeds ---------------------------------------------------------
    def rng(self, stream: int) -> np.random.Generator:
        """A generator for one purpose (``stream``) of this run's seed."""
        return np.random.default_rng([self.seed, stream])

    # -- the window ----------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin_window(self) -> float:
        return time.perf_counter()

    def new_unit(self) -> Unit:
        """The next unit; the profiler's session opens before unit
        ``trace_from`` (0 by default) in a traced run."""
        i = len(self.units)
        t = self.tracer
        if (t is not None and t.prof is None and t.summary is None
                and i == self.params.get("trace_from", 0)
                and self.params.get("trace_units", 0)):
            t.start()
        u = Unit(i, t is not None and t.active)
        self.units.append(u)
        return u

    def end_unit(self) -> None:
        """After a unit: closes the profiler's session once the traced
        units are done."""
        p = self.params
        if (self.tracer is not None and self.tracer.active and len(self.units)
                >= p.get("trace_from", 0) + p.get("trace_units", 0)):
            self.tracer.stop()

    def stop(self, t0: float, seconds: float) -> bool:
        """Whether the window is over: ``seconds`` passed on the host
        clock, or the ``max_units`` of a shortened run are done."""
        cap = self.params.get("max_units")
        if cap is not None:
            return len(self.units) >= cap
        return time.perf_counter() - t0 >= seconds

    def end_window(self, t0: float) -> float:
        self.sync()
        self.window_s = time.perf_counter() - t0
        if self.tracer is not None:
            self.tracer.stop()
        return self.window_s

    @contextlib.contextmanager
    def span(self, unit: Unit, name: str, sync: bool = False):
        """Host clock around a call (after a synchronise when ``sync``);
        a ``record_function`` range while the profiler runs."""
        rec = (torch.profiler.record_function(name) if unit.traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rec:
            yield
            if sync:
                self.sync()
        unit.spans[name] = unit.spans.get(name, 0.0) + time.perf_counter() - t0

    # -- what the readers see ------------------------------------------
    @property
    def trace(self):
        return None if self.tracer is None else self.tracer.summary

    def measured_units(self) -> list:
        """The units outside the profiler's session, or all where every
        unit was traced."""
        free = [u for u in self.units if not u.traced]
        return free or self.units
