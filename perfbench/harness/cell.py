"""Finding a cell's pieces by name.

Every piece of a cell is a file of its own under ``perfbench/``, found
from the names in ``BENCHMARK.json`` and in the cell's file, so that a
new cell, configuration, traffic kind or per-layer metric is added as new
files only:

* ``workloads/<cell>.json``: the cell (its configuration, traffic kind and
  that kind's parameters, the limits of its checks);
* ``configs/<config>.json``: the deployment (board, lanes, recipe);
* ``traffic/<kind>.py``: the kind's ``setup``, ``window`` and ``check``;
* ``metrics/<metric>.py``: a per-layer metric's ``read(ctx)``; where a
  quantity is split by the end-to-end metric it moves
  (``device_idle.train``, ``device_idle.rollout``), one reader
  ``metrics/<quantity>.py`` serves every part that has no file of its
  own.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]   # perfbench/
ROOT = BENCH.parent                            # the checkout


@dataclass
class Cell:
    name: str
    spec: dict                 # workloads/<cell>.json
    config: dict               # configs/<config>.json
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    root: Path = BENCH         # the perfbench/ directory it was found in

    @property
    def traffic(self) -> str:
        return self.spec["traffic"]

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))

    @property
    def params(self) -> dict:
        return self.spec.get("params", {})

    @property
    def limits(self) -> dict:
        return self.spec.get("limits", {})


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _safe(name: str) -> str:
    if not name or "/" in name or name.startswith(".") or "\\" in name:
        raise ValueError(f"not a name: {name!r}")
    return name


def load_cell(name: str, bench_root: Path = BENCH,
              benchmark: Path | None = None) -> Cell:
    """The cell ``name`` with its configuration and the metrics that
    ``BENCHMARK.json`` declares for it."""
    spec = _json(bench_root / "workloads" / f"{_safe(name)}.json")
    config = _json(bench_root / "configs" / f"{_safe(spec['config'])}.json")
    bj = _json(benchmark or bench_root.parent / "BENCHMARK.json")
    e2e = [m for m in bj["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bj["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name, spec, config, e2e, layer, bench_root)


def _module(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_module(kind: str, bench_root: Path = BENCH):
    return _module(bench_root / "traffic" / f"{_safe(kind)}.py",
                   f"perfbench_traffic_{kind.replace('.', '_')}")


def metric_path(name: str, bench_root: Path = BENCH) -> Path:
    """``metrics/<name>.py``, or else the reader of the quantity the name
    splits, ``metrics/<name up to its first dot>.py``."""
    own = bench_root / "metrics" / f"{_safe(name)}.py"
    shared = bench_root / "metrics" / f"{name.split('.')[0]}.py"
    return own if own.is_file() or not shared.is_file() else shared


def metric_module(name: str, bench_root: Path = BENCH):
    return _module(metric_path(name, bench_root),
                   f"perfbench_metric_{name.replace('.', '_')}")
