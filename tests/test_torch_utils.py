"""The port's utils/metrics, utils/profiling, utils/checkpoint and
core/invariants: twins of tests/test_metrics.py, test_invariants.py and
test_checkpoint.py on the port (same cases and thresholds; the port's
``checked_step`` raises where JAX's checkify error is thrown, and a
template mismatch raises ValueError where JAX's asserts), plus a
checkpoint the JAX package saved, loaded into the port and resumed to
the JAX resume's state.  All exact."""
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gym_soccer_tpu.agents import learners as jl
from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.utils import checkpoint as jcheckpoint
from gym_soccer_tpu_torch.agents import learners
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import batch, threefry
from gym_soccer_tpu_torch.core.invariants import (assert_invariants,
                                                  checked_step,
                                                  state_invariants)
from gym_soccer_tpu_torch.utils import checkpoint, profiling
from gym_soccer_tpu_torch.utils.metrics import EpisodeStats, chunk_stats

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def _init(n, seed=0):
    return batch.init(CFG, threefry.key(seed), n, "cpu")


# ---- metrics (tests/test_metrics.py) -----------------------------------

def _chunk(done, trunc, rew):
    return SimpleNamespace(done=np.asarray(done, bool),
                           truncated=np.asarray(trunc, bool),
                           reward_a=np.asarray(rew, np.float32))


def test_chunk_stats_handcrafted():
    out = _chunk([1, 1, 0, 1, 0, 0], [0, 0, 1, 1, 0, 0],
                 [1.0, -1.0, 0.0, 1.0, 0.0, 0.0])
    for chunk in (out, SimpleNamespace(**{k: torch.as_tensor(v) for k, v
                                          in vars(out).items()})):
        s = chunk_stats(chunk)
        assert int(s.episodes) == 4 and int(s.goals) == 3
        assert int(s.truncations) == 1
        assert int(s.wins_a) == 2 and int(s.wins_b) == 1
        assert float(s.reward_a_sum) == 1.0 and int(s.steps) == 6
        assert s.mean_reward_a == 0.25 and s.mean_length == 1.5
        assert s.win_rate_a == 0.5


def test_merge_is_exact_addition():
    a = chunk_stats(_chunk([1, 0], [0, 0], [1.0, 0.0]))
    b = chunk_stats(_chunk([0, 1, 1], [1, 0, 0], [0.0, -1.0, 1.0]))
    whole = chunk_stats(_chunk([1, 0, 0, 1, 1], [0, 0, 1, 0, 0],
                               [1.0, 0.0, 0.0, -1.0, 1.0]))
    for x, y in zip(a.merge(b), whole):
        assert float(x) == float(y)
    z = EpisodeStats.zero()
    for x, y in zip(z.merge(a).merge(b), a.merge(z.merge(b))):
        assert float(x) == float(y)


def test_chunk_stats_on_tensors_matches_host():
    st = _init(256)
    pol = batch.random_policy_fn(CFG, threefry.key(1), 256)
    _, out = batch.rollout(CFG, st, pol, 120)
    dev = chunk_stats(out)
    host = chunk_stats(SimpleNamespace(
        done=out.done.numpy(), truncated=out.truncated.numpy(),
        reward_a=out.reward_a.numpy()))
    for x, y in zip(dev, host):
        assert float(x) == float(y)
    assert int(host.episodes) > 0
    assert int(host.goals) + int(host.truncations) == int(host.episodes)


def test_rollout_prob_field_matches_info_contract():
    st = _init(128)
    pol = batch.random_policy_fn(CFG, threefry.key(1), 128)
    _, out = batch.rollout(CFG, st, pol, 60)
    p = out.prob.numpy().astype(np.float64).ravel()
    assert ((p > 0) & (p <= 1)).all()
    allowed = {round(cp * w, 6)
               for cp in (0.64, 0.08, 0.01) for w in (1.0, 0.5, 0.25)}
    got = {round(float(v), 6) for v in np.unique(p.astype(np.float32))}
    assert got <= allowed and round(0.64, 6) in got


# ---- profiling ---------------------------------------------------------

def test_profiling(tmp_path, capsys):
    profiling.phase_report()
    with profiling.phase("a"):
        pass
    with profiling.phase("b", sync=False):
        pass
    rep = profiling.phase_report()
    assert [r["phase"] for r in rep] == ["a", "b"]
    assert profiling.phase_report() == []
    tp = profiling.Throughput()
    tp.tick(1000)
    assert tp.summary()["env_steps"] == 1000
    profiling.log_json(event="x", n=1)
    assert json.loads(capsys.readouterr().out) == {"event": "x", "n": 1}
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof.key_averages() is not None
    assert (tmp_path / "trace.json").exists()


# ---- invariants (tests/test_invariants.py) -------------------------------

def test_rollout_preserves_invariants():
    st = _init(128)
    assert_invariants(CFG, st)
    pol = batch.random_policy_fn(CFG, threefry.key(1), 128)
    st, _ = batch.rollout(CFG, st, pol, 300)
    assert_invariants(CFG, st)


def test_checked_step_passes_on_valid_state():
    st = _init(64)
    acts = torch.zeros(64, dtype=torch.int32)
    new, out = checked_step(CFG)(st, acts, acts)
    assert new.t.shape == (64,)


def test_checked_step_catches_corruption():
    st = _init(64)
    rows_b, cols_b = st.rows_b.clone(), st.cols_b.clone()
    rows_b[3], cols_b[3] = st.rows_a[3], st.cols_a[3]
    bad = st._replace(rows_b=rows_b, cols_b=cols_b)
    acts = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="players_distinct"):
        checked_step(CFG)(bad, acts, acts)
    with pytest.raises(ValueError, match="actions out of range"):
        checked_step(CFG)(st, acts + 5, acts)
    with pytest.raises(AssertionError, match="players_distinct"):
        assert_invariants(CFG, bad)


def test_invariant_names_cover_corruptions():
    st = _init(8)
    inv = state_invariants(CFG, st)
    assert all(bool(v.all()) for v in inv.values())
    cols_a = st.cols_a.clone()
    cols_a[0] = 99
    assert not bool(state_invariants(CFG, st._replace(cols_a=cols_a))
                    ["in_bounds"].all())
    ra, ca, p = st.rows_a.clone(), st.cols_a.clone(), st.poss.clone()
    ra[0], ca[0], p[0] = 1, 0, 0
    absorbed = st._replace(rows_a=ra, cols_a=ca, poss=p)
    assert not bool(state_invariants(CFG, absorbed)["not_absorbed"].all())


# ---- checkpoint (tests/test_checkpoint.py) -------------------------------

def _equal_trees(a, b):
    la = [x for x, _ in checkpoint._flatten(a)]
    lb = [x for x, _ in checkpoint._flatten(b)]
    assert len(la) == len(lb)
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


def test_roundtrip_env_state(tmp_path):
    st = _init(32)
    path = str(tmp_path / "env.npz")
    checkpoint.save_pytree(path, st)
    st2 = checkpoint.load_pytree(path, st)
    assert type(st2) is type(st) and st2.key.dtype == torch.int64
    assert _equal_trees(st, st2)


def test_roundtrip_and_resume_learner(tmp_path):
    st = learners.iql_init(CFG, threefry.key(1), 64, "cpu")
    lc = learners.IQLConfig()
    st, _ = learners.iql_train(CFG, lc, st, 20)
    path = str(tmp_path / "learn.npz")
    checkpoint.save_pytree(path, st)
    st2 = checkpoint.load_pytree(path, st)
    assert _equal_trees(st, st2)
    a, _ = learners.iql_train(CFG, lc, st, 20)
    b, _ = learners.iql_train(CFG, lc, st2, 20)
    assert _equal_trees(a, b)


def test_template_mismatch_rejected(tmp_path):
    st = _init(8)
    path = str(tmp_path / "x.npz")
    checkpoint.save_pytree(path, st)
    with pytest.raises(ValueError, match="8 leaves.*template has 2"):
        checkpoint.load_pytree(path, (st.rows_a, st.cols_a))


def test_other_layout_rejected(tmp_path):
    path = str(tmp_path / "y.npz")
    meta = json.dumps({"leaves": [], "layout": "other/9"}).encode()
    np.savez(path, __meta__=np.frombuffer(meta, np.uint8))
    with pytest.raises(ValueError, match="other/9"):
        checkpoint.load_pytree(path, ())


def test_save_is_atomic(tmp_path):
    path = str(tmp_path / "a.npz")
    checkpoint.save_pytree(path, {"x": np.arange(4)})
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_altq_state_roundtrip(tmp_path):
    lcfg = learners.AltQConfig()
    st = learners.altq_init(CFG, threefry.key(2), 32, "cpu")
    st, _ = learners.altq_train(CFG, lcfg, st, 20)
    path = str(tmp_path / "altq.npz")
    checkpoint.save_pytree(path, st)
    st2 = checkpoint.load_pytree(path, st)
    a1, _ = learners.altq_train(CFG, lcfg, st, 10)
    a2, _ = learners.altq_train(CFG, lcfg, st2, 10)
    assert torch.equal(a1.q, a2.q) and torch.equal(a1.env.rows_a,
                                                   a2.env.rows_a)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A minimax-Q state the JAX package saved loads into the port's
    template (keys as key words) and resumes to the JAX resume's state:
    the env exactly, the tables within 1e-6 * (1 + |x|); the port's own
    file of that state loads back into the JAX package."""
    jcfg = JaxConfig(5, 4, 0.2)
    kw = dict(lr=0.3, resolve_every=8, solver_iters=50)
    jst = jax.jit(lambda k: jl.minimax_init(jcfg, k, 128))(jax.random.key(4))
    jst, _ = jax.jit(lambda s: jl.minimax_train(
        jcfg, jl.MinimaxQConfig(**kw), s, 12))(jst)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_pytree(path, jst)
    tmpl = learners.minimax_init(CFG, threefry.key(0), 128, "cpu")
    st = checkpoint.load_pytree(path, tmpl)
    assert int(st.step) == 12 and st.step.dtype == torch.int32
    jend, _ = jax.jit(lambda s: jl.minimax_train(
        jcfg, jl.MinimaxQConfig(**kw), s, 12))(jst)
    end, _ = learners.minimax_train(CFG, learners.MinimaxQConfig(**kw), st,
                                    12)
    for i, name in enumerate(jend.env._fields[:7]):
        assert np.array_equal(end.env[i].numpy(), np.asarray(jend.env[i]))
    for f in ("q", "v", "pi_a", "pi_b", "n"):
        a = getattr(end, f).numpy().astype(np.float64)
        b = np.asarray(getattr(jend, f)).astype(np.float64)
        assert (np.abs(a - b) <= 1e-6 * (1 + np.abs(b))).all(), f
    ours = str(tmp_path / "port.npz")
    checkpoint.save_pytree(ours, st)
    back = jcheckpoint.load_pytree(ours, jst)
    assert np.array_equal(np.asarray(jax.random.key_data(back.env.key)),
                          np.asarray(jax.random.key_data(jst.env.key)))
    assert np.array_equal(np.asarray(back.q), np.asarray(jst.q))
