"""The traced run's one ``torch.profiler`` session and its reduction.

A process opens one session at most (later sessions in a process have
lost kernel records).  The session covers ``trace_units`` units of the
window from unit ``trace_from`` on;
``perfbench_traced_window``, a ``record_function`` range closed after a
synchronise, marks the traced window on the host, and the harness's spans
(``rollout_call``, ``decode_call``, ``train_call``, ``eval_call``) name
what the host was doing.  Reduced in memory: nothing is written to disk.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "perfbench_traced_window"


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [seconds]
    gaps: dict = field(default_factory=dict)      # host span -> idle s

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_times(self, needle: str) -> list:
        """Durations of every device operation whose name holds
        ``needle``."""
        return [d for name, ds in self.kernels.items() if needle in name
                for d in ds]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, sum(d)) for n, d in self.kernels.items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")()) * 1000


def _is_device(ev) -> bool:
    return ev.device_type() in (torch.autograd.DeviceType.CUDA,)


class Tracer:
    def __init__(self, spans=("rollout_call", "decode_call", "train_call",
                              "eval_call")):
        self.span_names = set(spans)
        self.prof = None
        self.summary: Summary | None = None
        self._win = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.summary is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._win = torch.profiler.record_function(WINDOW)
        self._win.__enter__()

    def stop(self) -> None:
        if not self.active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.summary = reduce(self.prof.profiler.kineto_results.events(),
                              self.span_names)
        self.prof = None


def reduce(events, span_names) -> Summary:
    """Busy and idle time of the device inside the traced window, the
    device operations' durations by name, and the idle time by the host
    span that was open when each gap began."""
    win = None
    device, spans = [], []
    for ev in events:
        name = ev.name()
        t0 = _ns(ev, "start")
        t1 = t0 + _ns(ev, "duration")
        if _is_device(ev):
            # the host ranges' mirrors on the device's timeline are
            # annotations, not operations
            if name not in span_names and name != WINDOW:
                device.append((t0, t1, name))
        elif name == WINDOW:
            win = (t0, t1)
        elif name in span_names:
            spans.append((t0, t1, name))
    if win is None:
        raise RuntimeError("the profiler recorded no traced window")
    w0, w1 = win
    kernels = defaultdict(list)
    merged = []
    for t0, t1, name in sorted(device):
        kernels[name].append((t1 - t0) * 1e-9)
        a, b = max(t0, w0), min(t1, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    # idle gaps inside the window, named by the host span open at each
    # gap's start (the spans follow one another without nesting)
    spans.sort()
    starts = [s[0] for s in spans]
    gaps = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_right(starts, a) - 1
        name = spans[i][2] if i >= 0 and spans[i][1] >= a else \
            "outside_calls"
        gaps[name] += (b - a) * 1e-9
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                   kernels=dict(kernels), gaps=dict(gaps))
