"""Run the REFERENCE repo's own pytest suite against the port.

The compat shim (``refcompat``) presents the port's classes under the
reference's module names (`gym_soccer.envs`, `gym_soccer.utils.*`), and
the gym stub (``refstub``) satisfies its `gym` imports, so the reference's
unmodified test files exercise the port — the twin of the JAX package's
tools/run_reference_tests.py.

One deselection: test_multiple_consecutive_collisions is broken in the
reference itself (its 1000-step loop never resets, so the 100-step
truncation gate trips needs_reset at iteration 101 — it fails against the
reference's own env too).

The reference checkout is named by the REFERENCE_PATH environment
variable; nothing else is searched.  While it is unset, or names no
directory holding the reference's tests, this exits 2.

Run: python -m gym_soccer_tpu_torch.tools.run_reference_tests [pytest args]
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
PACKAGE_ROOT = HERE.parents[1]   # the directory holding gym_soccer_tpu_torch


def reference_tests() -> Path | None:
    """The reference's test directory under REFERENCE_PATH, or None while
    REFERENCE_PATH is unset."""
    root = os.environ.get("REFERENCE_PATH")
    return Path(root) / "gym_soccer" / "tests" if root else None


def main(argv=None) -> int:
    tests = reference_tests()
    if tests is None or not tests.is_dir():
        print(f"reference tests not found at {tests}; set REFERENCE_PATH "
              "to a checkout of the upstream repo", file=sys.stderr)
        return 2
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE / "refcompat"), str(HERE / "refstub"), str(PACKAGE_ROOT),
         env.get("PYTHONPATH", "")])
    cmd = [sys.executable, "-m", "pytest", str(tests), "-q",
           "-p", "no:cacheprovider",
           "-k", "not test_multiple_consecutive_collisions",
           *(sys.argv[1:] if argv is None else argv)]
    with tempfile.TemporaryDirectory() as cwd:
        return subprocess.call(cmd, env=env, cwd=cwd)


if __name__ == "__main__":
    raise SystemExit(main())
