"""What the harness may import: no module under perfbench/ imports JAX or
the JAX package, and the plain reference imports nothing of the port.
Module names are compared by their whole top-level name, since the
port's name begins with the JAX package's."""
import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "gym_soccer_tpu"}
PORT = "gym_soccer_tpu_torch"


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_import(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _top_level_imports(path)
    assert not _top_level_imports(path) & FORBIDDEN


def test_whole_name_comparison():
    from perfbench.harness import program
    saved = dict(sys.modules)
    try:
        sys.modules["jax_helper"] = types.ModuleType("jax_helper")
        sys.modules[PORT + ".fake"] = types.ModuleType(PORT + ".fake")
        assert program.foreign_modules() == [
            m for m in program.foreign_modules()
            if m.split(".")[0] in FORBIDDEN]
        assert "jax_helper" not in program.foreign_modules()
        assert PORT + ".fake" not in program.foreign_modules()
        sys.modules["gym_soccer_tpu.core"] = types.ModuleType("x")
        assert "gym_soccer_tpu.core" in program.foreign_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """A whole shortened run in a fresh process, on the CPU, leaves no
    module of JAX or the JAX package in ``sys.modules``."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench import run
from perfbench.harness import cell, program
c = cell.load_cell("rollout5x4.journal")
out, checks, _ = run.run_cell(c, 3, 0.0, True, device="cpu", overrides=dict(
    lanes=1024, steps_per_call=8, max_units=3, trace_from=1, trace_units=1))
assert out["correct"], out
print(program.foreign_modules())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
