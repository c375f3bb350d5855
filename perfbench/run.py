"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell (imports, the port's kernel libraries from the build
cache in ``build/``, host tables, a warm-up of the cell's own shapes),
measures for ``--seconds``, checks what the window produced against the
plain reference in ``perfbench/reference/``, and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit (also the last lines of standard error).
"""
import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness import program as prog  # noqa: E402
from perfbench.harness.context import Context  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             program=None, overrides=None, t0: float | None = None):
    """Set up, measure and check one cell; returns the result's fields,
    the checks and the run's context.
    ``program`` replaces the port's entries (the tests' broken paths, the
    control); ``overrides`` replace the cell's parameters."""
    t0 = T0 if t0 is None else t0
    traffic = cells.traffic_module(cell.traffic, cell.root)
    ctx = Context(cell, seed, device, program or prog.load(), trace,
                  overrides)
    traffic.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0
    traffic.window(ctx, seconds)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                                 if ctx.device.type == "cuda" else 0)}
    metrics = {}
    if trace:
        s = ctx.trace
        if s is not None:
            dev.update(busy_s=s.busy_s, window_s=s.window_s)
        for m in cell.per_layer:
            value = cells.metric_module(m["name"], cell.root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(ctx.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    t_check = time.perf_counter()
    checks, failed = traffic.check(ctx)
    ctx.check_s = time.perf_counter() - t_check
    out = {"correct": all(c.ok for c in checks) and not failed,
           "attempted": len(ctx.units), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        out["breakdown"] = ctx.trace.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out, checks, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = cells.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"perfbench: no cell {args.workload!r}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        out, checks, ctx = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace))
    except ImportError as e:
        print(f"perfbench: the program is missing: {e}", file=sys.stderr)
        return 2
    foreign = prog.foreign_modules()
    if foreign:
        print("perfbench: JAX or the JAX package was loaded: "
              + ", ".join(foreign), file=sys.stderr)
        return 4
    print(f"perfbench: {out['device']['kind']} (power limit: "
          f"{power_limit() or 'not read'}); window {ctx.window_s:.3f} s, "
          f"checked in {ctx.check_s:.3f} s", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
