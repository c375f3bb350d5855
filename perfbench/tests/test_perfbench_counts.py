"""The rooflines' counts of bytes and operations on hand-worked shapes, and
the trace's reduction on hand-made events."""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))

from perfbench.harness import rmplus_counts, trace  # noqa: E402


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k2_bytes():
    k2 = _metric("k2_roofline")
    # 1024 lanes x 16 steps: journal 65,536 B; fields 6 x 4 B read and
    # written a lane, 49,152 B; totals 24 B
    assert k2.k2_bytes(1024, 16) == 65536 + 49152 + 24
    # the cells' call, 8192 x 1024: 33,554,432 + 393,216 + 24
    assert k2.k2_bytes(8192, 1024) == 33947672


def test_rmplus_counts():
    # 761 games x 400 iterations: 761 x (177 x 400 + 77)
    assert rmplus_counts.flops(761, 400) == 53937397
    # 11705 x 600: 11705 x 106277
    assert rmplus_counts.flops(11705, 600) == 1243972285
    assert rmplus_counts.nbytes(761) == 761 * 144
    # bound: operations over 67 TFLOP/s beat the bytes over 3.35 TB/s
    b = rmplus_counts.bound_s(11705, 600, 67e12, 3.35e12)
    assert b == pytest.approx(1243972285 / 67e12)
    assert rmplus_counts.bound_s(1000, 0, 67e12, 3.35e12) == \
        pytest.approx(1000 * 144 / 3.35e12)


class _Ev:
    def __init__(self, name, t0, t1, dev):
        self._n, self._t0, self._d, self._dev = name, t0, t1 - t0, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)


def test_trace_reduction():
    """Busy time is the union of the device's operations inside the
    window; the host ranges' device mirrors do not count; each gap is
    named by the host span open at its start."""
    ev = [_Ev(trace.WINDOW, 0, 1000, False),
          _Ev(trace.WINDOW, 0, 1000, True),          # its device mirror
          _Ev("train_call", 0, 600, False),
          _Ev("train_call", 0, 600, True),           # its device mirror
          _Ev("eval_call", 650, 1000, False),
          _Ev("k_a", 100, 300, True),
          _Ev("k_b", 250, 400, True),                # overlaps k_a
          _Ev("k_d", 550, 610, True),
          _Ev("k_a", 700, 900, True),
          _Ev("k_c", 950, 1100, True)]               # runs past the end
    s = trace.reduce(ev, {"train_call", "eval_call"})
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((300 + 60 + 200 + 50) * 1e-9)
    assert s.idle_share == pytest.approx(0.39)
    # gaps, named by their start: [0,100) and [400,550) in train_call;
    # [610,700) after it and before eval_call; [900,950) in eval_call
    assert s.gaps["train_call"] == pytest.approx(250e-9)
    assert s.gaps["outside_calls"] == pytest.approx(90e-9)
    assert s.gaps["eval_call"] == pytest.approx(50e-9)
    assert sorted(s.kernel_times("k_a")) == pytest.approx([200e-9, 200e-9])
    bd = s.breakdown()
    assert bd["device_ops"][0][0] == "k_a"
    assert len(bd["device_ops"]) == 4 and "train_call" not in dict(
        bd["device_ops"])
