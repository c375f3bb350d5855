"""The port's entry point ``gym_soccer_tpu_torch.examples.train_minimax``
(the twin of examples/train_minimax_tpu.py) and ``demo`` on the CPU at a
small size:

* ``eval_episode_stats`` equals the JAX example's on the same mixed
  policies, exactly (the same threefry draws);
* the default mode (the HBM-table learner) prints the JAX example's lines
  (``compiled``, a step line a chunk, ``finished``,
  ``eval_episode_stats``) with the same keys, its checkpoint resumes, and
  its tables equal ``minimax_train`` run directly;
* ``--fused`` stopped half way and resumed from ``--ckpt`` equals one
  uninterrupted ``fused_minimax_train`` with the same anneal anchor, bit
  for bit in q, n and the fields;
* ``--device`` defaults to ``cuda``; the demo's planners agree."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu_torch.agents import learners
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import threefry
from gym_soccer_tpu_torch.examples import (alternating_demo, demo,
                                           train_minimax)
from gym_soccer_tpu_torch.ops import learner_kernel as lk
from gym_soccer_tpu_torch.utils import checkpoint

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_eval_episode_stats_equals_jax():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_train_minimax", os.path.join(os.path.dirname(__file__), "..",
                                          "examples", "train_minimax_tpu.py"))
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    rng = np.random.default_rng(0)
    pi_a = rng.dirichlet(np.ones(5), 761).astype(np.float32)
    pi_b = rng.dirichlet(np.ones(5), 761).astype(np.float32)
    want = jex.eval_episode_stats(JaxConfig(5, 4, 0.2), jnp.asarray(pi_a),
                                  jnp.asarray(pi_b), n_envs=128, n_steps=60)
    got = train_minimax.eval_episode_stats(CFG, pi_a, pi_b, n_envs=128,
                                           n_steps=60, device="cpu")
    assert got == want and got["episodes"] > 0


def test_default_mode_lines_and_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "mm.npz")
    argv = ["--device", "cpu", "--envs", "64", "--chunk", "16",
            "--steps", "48", "--ckpt", ckpt]
    train_minimax.main(argv)
    lines = _lines(capsys)
    assert [ln.get("event") for ln in lines] == [
        "compiled", None, None, "finished", "eval_episode_stats"]
    assert [ln["step"] for ln in lines[1:3]] == [32, 48]
    assert set(lines[1]) == {"step", "mean_abs_td", "v_max", "env_steps",
                             "env_steps_per_s"}
    assert set(lines[3]) == {"event", "steps", "v_min", "v_max",
                             "exploitability", "env_steps",
                             "env_steps_per_s"}
    assert set(lines[4]) == {"event", "episodes", "goals", "truncations",
                             "win_rate_a", "mean_reward_a", "mean_length"}
    # the saved state is minimax_train's, run directly
    lcfg = learners.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=64,
                                   solver_iters=200, lr_halflife=48 // 5,
                                   eps_halflife=48 // 3)
    st = learners.minimax_init(CFG, threefry.key(0), 64, "cpu")
    st, _ = learners.minimax_train(CFG, lcfg, st, 48)
    saved = checkpoint.load_pytree(ckpt, st)
    for f in ("q", "v", "pi_a", "pi_b", "n"):
        assert torch.equal(getattr(saved, f), getattr(st, f)), f
    # resumed past its end: one more chunk from the checkpoint
    train_minimax.main(argv[:-4] + ["--steps", "64", "--ckpt", ckpt])
    lines = _lines(capsys)
    assert lines[0] == {"event": "resumed", "step": 48}
    assert lines[-2]["steps"] == 64


def test_fused_mode_resumes_bit_for_bit(tmp_path, capsys):
    ckpt = str(tmp_path / "fused.npz")
    base = ["--device", "cpu", "--fused", "--envs", "256", "--ckpt", ckpt]
    train_minimax.main(base + ["--steps", "128"])
    train_minimax.main(base + ["--steps", "256"])
    lines = _lines(capsys)
    events = [ln.get("event") for ln in lines]
    assert events == ["checkpointed", "finished_fused", "eval_episode_stats",
                      "resumed_fused", "checkpointed", "finished_fused",
                      "eval_episode_stats"]
    assert lines[3]["chunk"] == 2 and lines[3]["lr_anneal_start"] == 1
    train_minimax.main(base + ["--steps", "256"])
    assert [ln["event"] for ln in _lines(capsys)] == ["resumed_fused",
                                                      "already_complete"]
    *_, res = lk.fused_minimax_train(
        CFG, batch=256, n_chunks=4, chunk_len=64, lr=1.0, eps=0.2,
        lr_anneal_start=1, lr_anneal_tau=25.0, lr_anneal_pow=1.5,
        final_solver_iters=2000, return_state=True, device="cpu")
    tmpl = dict(res, lr_anneal_start=0)
    saved = checkpoint.load_pytree(ckpt, tmpl)
    assert saved["next_chunk"] == 4 and saved["lr_anneal_start"] == 1
    for name in ("q", "v", "pi_a", "pi_b", "n"):
        assert torch.equal(saved[name], res[name]), name
    for a, b in zip(saved["fields"], res["fields"]):
        assert torch.equal(a, b)


def test_device_defaults_to_cuda():
    assert train_minimax.parse_args([]).device == "cuda"
    assert train_minimax.parse_args([]).envs == 8192


def test_alternating_demo_equals_jax(capsys):
    """The twin of examples/alternating_demo.py with --quick on the CPU
    passes tests/test_examples.py::test_alternating_demo's assertions,
    and its value iteration and matches print the JAX demo's numbers (the
    same numpy VI; ``alt_policy_rollout`` a bit twin of JAX's)."""
    from gym_soccer_tpu.envs import soccer_alternating_env as jalt
    alternating_demo.main(["--quick", "--device", "cpu"])
    ev = {e["event"]: e for e in _lines(capsys) if "event" in e}
    assert ev["tables"]["nS"] == 1521
    assert ev["best_response_vs_random"]["losses"] == 0
    assert ev["best_response_vs_random"]["win_rate"] > 0.95
    assert ev["learned"]["env_steps"] == 3000 * 256
    jcfg = JaxConfig(5, 4, 0.2)
    tb = jalt.build_alt_tables(jcfg)
    pi, v, _, sweeps = jalt.alt_value_iteration(tb)
    assert ev["solved"] == {"event": "solved", "sweeps": sweeps,
                            "v_abs_max": round(float(np.abs(v).max()), 4)}
    w, l, tr = jalt.alt_policy_rollout(jcfg, tb.raw_to_dense, pi, pi,
                                       batch=256, steps=400, seed=1)
    assert ev["minimax_selfplay"] == {"event": "minimax_selfplay",
                                      "wins_a": w, "wins_b": l,
                                      "truncations": tr}
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    pi_br = jalt.alt_value_iteration(tb, frozen_b=randpol)[0]
    w, l, tr = jalt.alt_policy_rollout(jcfg, tb.raw_to_dense, pi_br, randpol,
                                       batch=256, steps=400, seed=2)
    assert ev["best_response_vs_random"] == {
        "event": "best_response_vs_random", "wins": w, "losses": l,
        "truncations": tr, "win_rate": round(w / max(w + l + tr, 1), 4)}
    assert alternating_demo.parse_args([]).device == "cuda"


def test_demo_planners_agree(capsys, monkeypatch):
    """demo.main at the reference's size, its 1000-episode eval cut to 20
    episodes."""
    real_range = range
    monkeypatch.setattr(demo, "range", lambda n: real_range(min(n, 20)),
                        raising=False)
    monkeypatch.setattr(demo.SoccerSimultaneousEnv, "render",
                        lambda self, *a, **k: None)
    demo.main()
    out = capsys.readouterr().out
    assert "All planners agree" in out
    phases = [json.loads(x)["phase"] for x in out.splitlines()
              if x.startswith("{")]
    assert phases[:2] == ["env_build", "value_iteration"]
