"""The port's tools on the CPU at small sizes: ``tools.bench_all`` (its
rows are the JAX tool's, in its order; each learner row's table is the
JAX row's M read through ``interop``; the engine rows' statistics equal
the JAX rows' work on the same keys, bit for bit, since threefry is; the
whole sweep, and a row that raises), ``tools.bench_parity_kernel`` (both
checks pass, and fail on a journal with one bit flipped),
``tools.gen_render_golden``'s builder against the committed fixture byte
for byte, and both generators' refusal to run without REFERENCE_PATH.
``tools.gen_golden``'s builder is held to its fixture in
tests/test_torch_gen_golden.py.  The card's run of both bench tools is
chip_smoke.py's phase 49."""
import ast
import functools
import json
import math
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import batch as jbatch
from gym_soccer_tpu.core import tables as jtables
from gym_soccer_tpu.envs.soccer_alternating_env import \
    build_alt_tables as jalt_tables
from gym_soccer_tpu.ops import altq_kernel as jak
from gym_soccer_tpu.ops import iql_kernel as jik
from gym_soccer_tpu.ops import learner_kernel as jlk
from gym_soccer_tpu.utils import policies as jpolicies
from gym_soccer_tpu.utils.metrics import chunk_stats as jchunk_stats
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.envs import SoccerSimultaneousEnv
from gym_soccer_tpu_torch.ops import parity_kernel as pkm
from gym_soccer_tpu_torch.tools import (bench_all, bench_parity_kernel,
                                        gen_golden, gen_render_golden)
from gym_soccer_tpu_torch.utils.policies import get_random_policy_array

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = bench_all.CFG
JCFG = JaxConfig(5, 4, 0.2)
JMIX = (JCFG, JaxConfig(6, 5, 0.1), JaxConfig(8, 6, 0.3))

# Every row at a size the CPU's plain versions run in well under a second
# a call; a slope's long call several times its short one, so that the
# order of their medians survives a loaded machine.
TINY = {
    "facade_single_env": dict(steps=200),
    "xla_batch_engine_traj": dict(batch=256, steps=10),
    "xla_stats_threefry": dict(batch=256, steps=10),
    "xla_stats_counter": dict(batch=256, steps=10),
    "xla_multigrid_mixed": dict(batch=256, steps=5),
    "xla_alternating_engine": dict(batch=256, steps=5),
    "xla_altq_learner": dict(batch=256, steps=5),
    "pallas_minimax_learner": dict(batch=128, chunks=2, steps=8),
    "pallas_minimax_learner_packed": dict(batch=128, chunks=2, steps=8),
    "pallas_learner_11x7_packed": dict(batch=128, chunks=1, steps=8),
    "pallas_br_learner": dict(batch=128, chunks=2, steps=8),
    "pallas_iql_learner": dict(batch=128, chunks=2, steps=8),
    "pallas_iql_learner_packed": dict(batch=128, chunks=2, steps=8),
    "pallas_multigrid_learner": dict(batch=128, chunks=1, steps=8),
    "pallas_multigrid_learner_packed": dict(batch=128, chunks=1, steps=8),
    "pallas_altq_learner": dict(batch=128, chunks=2, steps=8),
    "pallas_altq_learner_packed": dict(batch=128, chunks=2, steps=8),
    "parity_bit_exact": dict(batch=128, steps=10),
    "parity_kernel_fused": dict(batch=128, events=(8, 512)),
    "pallas_fused": dict(batch=1024, lengths=(2, 64)),
    "pallas_fused_journal": dict(batch=1024, lengths=(2, 64)),
    "pallas_multigrid_fused": dict(batch=1024, lengths=(2, 64)),
    "pallas_alt_fused": dict(batch=1024, lengths=(2, 64)),
    "table_build_native": dict(board=(5, 4)),
}


@pytest.fixture
def short_legs(monkeypatch):
    """Legs of a few ms: the timing rule's arithmetic, not a measurement."""
    monkeypatch.setattr(bench_all, "MIN_LEG_MS", 5.0)


def jax_rowspec():
    """The row names of the JAX tool's ``rowspec``, read with ``ast``."""
    tree = ast.parse((ROOT / "tools" / "bench_all.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "rowspec" for t in node.targets):
            return [e.elts[0].value for e in node.value.elts]
    raise AssertionError("no rowspec in tools/bench_all.py")


def test_rows_are_the_jax_tools_rows():
    assert [name for name, _ in bench_all.ROWS] == jax_rowspec()
    assert list(TINY) == jax_rowspec()


def _jax_uniform(cfg):
    nS = sum(jtables.build_statespace(c).nS for c in
             (cfg if isinstance(cfg, tuple) else (cfg,)))
    return nS, jnp.full((nS, 5), 0.2)


def _jax_m(cfg, packed, br=False):
    """The JAX rows' M (tools/bench_all.py:187, :210-214, :262, :318)."""
    nS, uni = _jax_uniform(cfg)
    if br:
        opp = jnp.asarray(jpolicies.get_random_policy_array(nS, 5, seed=42))
        opp_oh = jax.nn.one_hot(opp, 5, dtype=jnp.float32)
        return jlk.pack_m2(cfg, uni, opp_oh, jnp.zeros(nS), eps=0.3,
                           eps_b=0.0)
    if packed:
        return jlk.pack_m2(cfg, uni, uni, jnp.zeros(nS), eps=0.3)
    return jlk.pack_m(cfg, uni, uni, jnp.zeros((nS, 5, 5)), jnp.zeros(nS),
                      eps=0.3)


MINIMAX_TABLES = {
    "pallas_minimax_learner": ((5, 4), False, False),
    "pallas_minimax_learner_packed": ((5, 4), True, False),
    "pallas_learner_11x7_packed": ((11, 7), True, False),
    "pallas_br_learner": ((5, 4), True, True),
    "pallas_multigrid_learner": ("mix", False, False),
    "pallas_multigrid_learner_packed": ("mix", True, False),
}


@pytest.mark.parametrize("row", list(MINIMAX_TABLES))
def test_minimax_rows_table_is_the_jax_rows_m(row):
    board, packed, br = MINIMAX_TABLES[row]
    if board == "mix":
        cfg, jcfg = bench_all.MIXTURE, JMIX
    else:
        cfg, jcfg = EnvConfig(*board, 0.2), JaxConfig(*board, 0.2)
    opp = get_random_policy_array(761, 5, seed=42) if br else None
    table = bench_all.minimax_table(cfg, packed, "cpu", opp)
    m = np.asarray(_jax_m(jcfg, packed, br), np.float32)
    read = interop.table_from_packed_m if packed else interop.table_from_m
    assert torch.equal(read(cfg, m, "cpu"), table)


@pytest.mark.parametrize("packed", [True, False], ids=["m2", "m"])
def test_iql_and_altq_rows_tables_are_the_jax_rows_m(packed):
    """Both layouts of the JAX rows' zero M (tools/bench_all.py:293,
    :356) read as the table the port's rows pass."""
    z = jnp.zeros((761, 5))
    m = (jik.pack_iql_m2 if packed else jik.pack_iql_m)(JCFG, z, z)
    assert torch.equal(interop.iql_table_from_packed_m(
        CFG, np.asarray(m, np.float32), packed, "cpu"),
        bench_all.iql_table("cpu"))
    zq = jnp.zeros((jalt_tables(JCFG).nS, 5))
    m = (jak.pack_alt_m2 if packed else jak.pack_alt_m)(JCFG, zq)
    assert torch.equal(interop.alt_table_from_m(
        CFG, np.asarray(m, np.float32), packed, "cpu"),
        bench_all.alt_table("cpu"))


def test_engine_row_episode_stats_equal_the_jax_rows_work(short_legs):
    """256 lanes x 50 steps: the first call's episode statistics of
    ``xla_batch_engine_traj`` equal the JAX row's rollout from the same
    keys."""
    row = bench_all.bench_xla("cpu", batch=256, steps=50)
    pol = jbatch.random_policy_fn(JCFG, jax.random.key(1), 256)
    st = jbatch.init(JCFG, jax.random.key(0), 256)
    _, out = jbatch.rollout(JCFG, st, pol, 50)
    s = jchunk_stats(out)
    assert row["episode_stats"] == {"episodes": int(s.episodes),
                                    "goals": int(s.goals),
                                    "mean_length": s.mean_length}
    assert row["episode_stats"]["episodes"] > 0


@pytest.mark.parametrize("rng", ["threefry", "counter"])
def test_stats_rows_equal_the_jax_rows_work(short_legs, rng):
    fn = {"threefry": bench_all.bench_xla_stats_threefry,
          "counter": bench_all.bench_xla_stats_counter}[rng]
    row = fn("cpu", batch=256, steps=50)
    st = jbatch.init(JCFG, jax.random.key(0), 256)
    _, acc = jbatch.random_rollout_stats(JCFG, st, 50, rng=rng)
    assert row["first_stats"] == [float(x) for x in acc]
    assert row["first_stats"][1] > 0


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_whole_sweep_at_tiny_sizes(short_legs, monkeypatch, capsys):
    monkeypatch.setattr(bench_all, "ROWS", [
        (name, functools.partial(fn, **TINY[name]))
        for name, fn in bench_all.ROWS])
    assert bench_all.main(["--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    rows = [d for d in lines if "/" not in d["path"]]
    assert [d["path"] for d in rows] == jax_rowspec()
    for d in rows:
        assert "error" not in d, d
        v = d["env_steps_per_s"]
        assert math.isfinite(v) and v > 0, d
        assert d["vs_reference"] == v / 2.7e4
        assert d["device"] == "cpu" and d["card"] is None
        assert d["calls"] >= 2 + bench_all.LEGS
        if "lengths" in d:
            assert d["long_ms"] > d["short_ms"] > 0
    stats = [d for d in lines if d["path"] == "xla_batch_engine_traj/"
             "episode_stats"]
    assert len(stats) == 1 and stats[0]["episodes"] > 0


def test_a_row_that_raises_prints_its_error_and_exits_1(short_legs,
                                                        monkeypatch, capsys):
    def broken(device, quick):
        raise ValueError("broken row")
    rows = dict(bench_all.ROWS)
    monkeypatch.setattr(bench_all, "ROWS", [
        ("facade_single_env", functools.partial(
            rows["facade_single_env"], **TINY["facade_single_env"])),
        ("xla_stats_counter", broken),
        ("table_build_native", functools.partial(
            rows["table_build_native"], **TINY["table_build_native"]))])
    assert bench_all.main(["--device", "cpu"]) == 1
    lines = _lines(capsys.readouterr().out)
    assert [d["path"] for d in lines] == ["facade_single_env",
                                          "xla_stats_counter",
                                          "table_build_native"]
    assert lines[1] == {"path": "xla_stats_counter",
                        "error": "ValueError: broken row"}
    assert "error" not in lines[0] and "error" not in lines[2]


def test_slope_fails_where_the_long_leg_is_not_longer(short_legs):
    """A call of the short length that sleeps longer than one of the long
    length fails the row."""
    with pytest.raises(RuntimeError, match="not longer"):
        bench_all.slope(lambda n: time.sleep(0.02 if n == 2 else 0.002),
                        (2, 16), 128, "cpu")


def test_no_card_no_sweep(capsys):
    """--device cuda without a card runs no row (and none on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_all.main([]) == 2
    assert bench_parity_kernel.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err


PARITY_ARGS = ["--device", "cpu", "--batch", "128", "--e-short", "8",
               "--e-long", "512"]


def test_parity_tool_checks_pass(short_legs, capsys):
    assert bench_parity_kernel.main(PARITY_ARGS) == 0
    lines = _lines(capsys.readouterr().out)
    assert {d["check"]: d["ok"] for d in lines if "check" in d} == {
        "on_chip_bit_exact": True, "scripted_on_chip_bit_exact": True}
    metrics = [d for d in lines if "metric" in d]
    assert [d["metric"] for d in metrics] == ["parity_kernel",
                                             "parity_kernel_scripted"]
    for d in metrics:
        assert d["w_long_s"] > d["w_short_s"] > 0
        assert 0 < d["step_fraction"] <= 1


@pytest.mark.parametrize("wrapper", ["parity_events",
                                     "parity_scripted_events"])
def test_parity_tool_fails_on_a_flipped_bit(short_legs, monkeypatch, capsys,
                                            wrapper):
    """One bit of the reward field of lane 0's first transition (event 1,
    after the reset) flipped in the kernel's journal fails that check."""
    real = getattr(pkm, wrapper)

    def flipped(*args, **kw):
        out = real(*args, **kw)
        j = out.journal.clone()
        j[1, 0] ^= 1 << 18
        return out._replace(journal=j)
    monkeypatch.setattr(pkm, wrapper, flipped)
    assert bench_parity_kernel.main(PARITY_ARGS) == 1
    checks = {d["check"]: d["ok"] for d in _lines(capsys.readouterr().out)
              if "check" in d}
    name = {"parity_events": "on_chip_bit_exact",
            "parity_scripted_events": "scripted_on_chip_bit_exact"}[wrapper]
    assert checks[name] is False


def test_render_builder_reproduces_the_fixture_byte_for_byte(tmp_path):
    path = gen_golden.write(gen_render_golden.build(SoccerSimultaneousEnv),
                            tmp_path / "render_golden.json")
    assert path.read_bytes() == gen_render_golden.OUT.read_bytes()
    assert gen_render_golden.OUT == ROOT / "tests" / "golden" / \
        "render_golden.json"


@pytest.mark.parametrize("where", [None, "empty"])
def test_generators_refuse_without_the_reference(monkeypatch, capsys,
                                                 tmp_path, where):
    """Unset, or naming no checkout: exit 2 naming REFERENCE_PATH, and no
    fixture written."""
    if where is None:
        monkeypatch.delenv("REFERENCE_PATH", raising=False)
    else:
        monkeypatch.setenv("REFERENCE_PATH", str(tmp_path))
    written = []
    monkeypatch.setattr(gen_golden, "write",
                        lambda *a, **k: written.append(a))
    for tool in (gen_golden, gen_render_golden):
        assert tool.main() == 2
        assert "REFERENCE_PATH" in capsys.readouterr().err
    assert not written


# The functions whose calls on the card are the launch counters phase 49
# reads (chip_smoke.BENCH_LAUNCHES): each wrapper, T1's entries, A1's,
# and batch.step, which launches S1 on the card (its draws inside it) and
# runs step_plain here, whose draws call T1's wrapper: only the outermost
# counted call counts.
COUNTED = {
    "ops.step_kernel": ["fused_rollout", "fused_journal_rollout",
                        "multigrid_rollout", "alt_rollout"],
    "ops.learner_kernel": ["packed_learner_chunk",
                           "multigrid_packed_learner_chunk", "learner_chunk",
                           "multigrid_learner_chunk"],
    "ops.iql_kernel": ["iql_packed_chunk", "iql_chunk"],
    "ops.altq_kernel": ["altq_packed_chunk", "altq_chunk"],
    "ops.parity_kernel": ["parity_events", "parity_scripted_events"],
    "ops.threefry_kernel": ["threefry_uniforms", "keyed_uniform",
                            "keyed_randint"],
    "core.batch": ["step"],
    "agents.learners": ["solve_matrix_games"],
    "ops.scatter_kernel": ["scatter_add"],
}
COUNTER = {"keyed_uniform": "threefry_keyed", "keyed_randint": "threefry_keyed",
           "step": "engine_step"}


@pytest.mark.parametrize("name", list(TINY))
def test_each_row_calls_what_phase_49_counts(short_legs, monkeypatch, name):
    """Every row at its tiny size on the CPU calls the functions behind
    the launch counters exactly as often as chip_smoke.BENCH_LAUNCHES
    gives for its calls, chunks and steps, and nothing else counted."""
    import importlib

    import chip_smoke
    calls, depth = {}, [0]
    for mod_name, fns in COUNTED.items():
        mod = importlib.import_module(f"gym_soccer_tpu_torch.{mod_name}")
        for fn in fns:
            def counted(*a, _real=getattr(mod, fn), _k=COUNTER.get(fn, fn),
                        **k):
                if not depth[0]:
                    calls[_k] = calls.get(_k, 0) + 1
                depth[0] += 1
                try:
                    return _real(*a, **k)
                finally:
                    depth[0] -= 1
            monkeypatch.setattr(mod, fn, counted)
    row = dict(bench_all.ROWS)[name]("cpu", **TINY[name])
    want = {k: n for k, n in chip_smoke.bench_expected(name, row).items()
            if n}
    assert calls == want
