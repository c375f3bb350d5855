"""Readings for the limits of a cell's checks: the program's on many seeds
and the control's (the reference in the program's place at a lower
precision), in one process.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 [--units N]

Each seed sets up the cell and runs ``--units`` units (the cell's
``sampled_units`` / ``sampled_calls`` are then all of them or a sample),
then prints one JSON line: the seed, whether it is the control, the
checks' values and limits, and each sampled unit's readings.  The
benchmark's own runs do not run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run  # noqa: E402
from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness import program as prog  # noqa: E402


def readings(cell, seed: int, control: bool, units: int, device="cuda",
             overrides=None, program=None) -> dict:
    program = program or prog.load()
    overrides = {"max_units": units, **(overrides or {})}
    if control:
        program = cells.traffic_module(cell.traffic, cell.root).control_program(
            program, cell, overrides)
    t = time.perf_counter()
    out, checks, ctx = run.run_cell(cell, seed, 0.0, False, device=device,
                               program=program, t0=t, overrides=overrides)
    return {"seed": seed, "control": control, "correct": out["correct"],
            "attempted": out["attempted"], "checks": out["checks"],
            "metrics": out["metrics"],
            "units": [{k: v for k, v in u.data.items() if k == "seed"}
                      for u in ctx.units],
            "readings": ctx.state.get("readings", []),
            "wall_s": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--control-units", type=int, default=None)
    ap.add_argument("--override", default="{}",
                    help="JSON object of cell parameters to replace")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        n = args.control_units if control and args.control_units else \
            args.units
        for s in seeds:
            print(json.dumps(readings(cell, s, control, n,
                                      overrides=json.loads(args.override))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
