"""The harness is driven by data: a cell, a configuration and a per-layer
metric added as new files only (and entries in BENCHMARK.json) are found
by run.py; the cells as committed keep to the benchmark's rules; a run
where the program is missing, or with no card, prints no result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402
from perfbench.harness import cell as cells  # noqa: E402

BJ = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BJ["workloads"]]
TINY = {"rollout_journal": dict(lanes=1024, steps_per_call=8, max_units=3,
                                host_probe_units=1, trace_from=1,
                                trace_units=1)}


def _copy(tmp_path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_cell_config_and_metric_as_files(tmp_path):
    root = _copy(tmp_path)
    b = root / "perfbench"
    cfg = json.loads((b / "configs" / "littman5x4.json").read_text())
    cfg.update(name="wide6x5", board=dict(cfg["board"], width=6, height=5))
    (b / "configs" / "wide6x5.json").write_text(json.dumps(cfg))
    spec = json.loads((b / "workloads" / "rollout5x4.journal.json")
                      .read_text())
    spec["config"] = "wide6x5"
    (b / "workloads" / "rollout6x5.journal.json").write_text(
        json.dumps(spec))
    (b / "metrics" / "calls.rollout.py").write_text(
        "def read(ctx):\n    return float(len(ctx.units))\n")
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["workloads"].append({"name": "rollout6x5.journal",
                            "config": "wide6x5", "traffic": "rollout_journal",
                            "chips": 1, "why": "a test cell"})
    for m in bj["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("rollout6x5.journal")
    bj["per_layer"].append({"name": "calls.rollout", "unit": "calls",
                            "better": "higher", "source": "program_counter",
                            "layer": "rollout entry",
                            "moves": "env_steps_per_s",
                            "workloads": ["rollout6x5.journal"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bj))
    c = cells.load_cell("rollout6x5.journal", b)
    assert c.config["board"]["width"] == 6
    assert "calls.rollout" in [m["name"] for m in c.per_layer]
    # a part of a split quantity with no file of its own is read by the
    # quantity's reader; one with its own file, by that
    assert cells.metric_path("device_idle.rollout", b).name == \
        "device_idle.py"
    assert cells.metric_path("calls.rollout", b).name == "calls.rollout.py"
    out, _, _ = run.run_cell(c, 5, 0.0, True, device="cpu",
                          overrides=TINY["rollout_journal"])
    assert out["correct"]
    assert out["metrics"]["calls.rollout"]["value"] == 3.0
    out, _, _ = run.run_cell(c, 5, 0.0, False, device="cpu",
                          overrides=TINY["rollout_journal"])
    assert set(out["metrics"]) == {"setup_s", "env_steps_per_s"}


@pytest.mark.parametrize("name", CELLS)
def test_committed_cells_are_whole(name):
    """Each cell's files exist, its metrics have readers, and it reports
    set-up, one other end-to-end metric and a per-layer one."""
    c = cells.load_cell(name)
    assert (BENCH / "traffic" / f"{c.traffic}.py").is_file()
    assert c.chips == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert cells.metric_path(m["name"]).is_file()
        assert m["moves"] in e2e


def test_benchmark_json_keys():
    assert set(BJ) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    for c in BJ["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == []
    assert all(0.01 <= m["bound"] <= 0.25 for m in BJ["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, a run
    cannot import the program and prints no result."""
    root = _copy(tmp_path)
    code = f"""
import sys
sys.path.insert(0, {str(root)!r})
from perfbench import run
from perfbench.harness import cell
c = cell.load_cell("rollout5x4.journal")
try:
    run.run_cell(c, 1, 0.0, False, device="cpu")
except ImportError:
    sys.exit(7)
print("{{}}")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 7 and not res.stdout.strip()


def test_no_card_no_result():
    """main() refuses with a nonzero code and no output line when no CUDA
    device is there (the check reads torch at run time)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "rollout5x4.journal", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0 and not res.stdout.strip()
