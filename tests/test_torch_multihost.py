"""The port's multi-process surface on the CPU, in gloo processes:

* ``entry.dryrun_multichip(2, device="cpu")``: two spawned ranks run
  every check of ``__graft_entry__.dryrun_multichip`` (a data-parallel
  minimax-Q call, the four data-parallel fused chunks and their visit
  counts, the sharded solve against the replicated one, the sharded exact
  resume);
* ``tools/demo_multihost`` (the twin of tools/demo_multihost.py): one
  process over the whole batch, then two gloo processes, which must agree
  bit for bit with each other and within 1e-6 relative with the one
  process, printing ``MULTIHOST OK``;
* ``tools/bench_scaling.sweep([1, 2])`` gives the rows that
  tests/test_scaling_bench.py asserts of the JAX tool.
"""
import os
import subprocess
import sys

import pytest
import torch

from gym_soccer_tpu_torch import entry
from gym_soccer_tpu_torch.tools import bench_scaling

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_two_ranks(capsys):
    entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip ok: 2 devices, td:")
    assert "sharded exact resume" in out


def test_dryrun_multichip_refuses_more_ranks_than_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA devices"):
        entry.dryrun_multichip(2)


def test_demo_multihost_two_processes_agree():
    out = subprocess.run(
        [sys.executable, "-m", "gym_soccer_tpu_torch.tools.demo_multihost",
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, f"\n{out.stdout}\n{out.stderr}"
    assert "MULTIHOST OK" in out.stdout, out.stdout


def test_demo_multihost_defaults_to_the_card(capsys):
    """With no arguments the demo runs on the card: accepted where a CUDA
    device is present, and refused with a clear message, before any
    process starts, where none is."""
    from gym_soccer_tpu_torch.tools import demo_multihost
    if torch.cuda.is_available():
        assert demo_multihost.main([]) == 0
        assert "MULTIHOST OK" in capsys.readouterr().out
    else:
        assert demo_multihost.main([]) == 2
        assert "--device cpu" in capsys.readouterr().out


def test_scaling_sweep_smoke():
    """tests/test_scaling_bench.py's assertions on the port's sweep."""
    rows = bench_scaling.sweep([1, 2], envs_per_device=64, n_steps=10,
                               reps=1, device="cpu")
    assert {r["path"] for r in rows} == {"rollout", "minimax_train",
                                         "fused_learner_chunk",
                                         "sharded_solve"}
    assert {r["n_devices"] for r in rows} == {1, 2}
    for r in rows:
        assert r["steps_per_s"] > 0
        if r["path"] == "fused_learner_chunk":
            # a chunk's 128-lane minimum a rank
            assert r["n_envs"] == 128 * r["n_devices"]
        elif r["path"] == "sharded_solve":
            assert r["n_envs"] == 761  # strong scaling: fixed state count
        else:
            assert r["n_envs"] == 64 * r["n_devices"]
    effs = [r["efficiency_vs_linear"] for r in rows]
    assert len(effs) == len(rows)
    assert all(e > 0 for e in effs)
    assert all(r["efficiency_vs_linear"] == 1.0 for r in rows
               if r["n_devices"] == 1)
