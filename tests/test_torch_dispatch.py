"""The trainers' grouped dispatch modes (gym_soccer_tpu_torch.ops.dispatch)
on the CPU, where the bodies run one after another with no CUDA graph.

* the runner: the schedule's rows, stats and history, the group sizes,
  and ``run``'s loop, timing and launch counts;
* the schedule tables the grouped trainers upload against the JAX
  package's in-graph float32 schedules (``jnp.float32`` chunk index, the
  same expressions, under jit): eps within 1 ulp and eps_int within one
  count; lr within 4 ulp, since JAX rounds 1 + over / tau to float32 before
  a float32 power (0.5 ulp, scaled by the exponent 1.2-1.5) and XLA's
  float32 power adds its own rounding (the port takes the per-chunk mode's
  float64 value rounded once);
* under constant schedules, where the tables equal JAX's, the first
  chunk of a grouped run against JAX's ``chunks_per_dispatch=3`` run
  (``interpret=True``): minimax history, fields, n and q exact (v and pi
  within 1e-5, as tests/test_torch_learner_kernel.py holds the per-chunk
  mode); IQL and turn-based Q history, fields and q exact from q = 0.

Each trainer's grouped mode is held to its per-chunk mode bit for bit in
tests/test_torch_learner_kernel.py, test_torch_iql_kernel.py and
test_torch_altq_kernel.py, and on the card in tests/test_torch_cuda.py and
chip_smoke.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import altq_kernel as jak
from gym_soccer_tpu.ops import iql_kernel as jik
from gym_soccer_tpu.ops import learner_kernel as jlk
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import altq_kernel as ak
from gym_soccer_tpu_torch.ops import dispatch
from gym_soccer_tpu_torch.ops import iql_kernel as ik
from gym_soccer_tpu_torch.ops import learner_kernel as lk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG, JCFG = EnvConfig(5, 4, 0.2), JaxConfig(5, 4, 0.2)


# ----------------------------------------------------------------------
# The runner
# ----------------------------------------------------------------------

def test_group_sizes():
    assert dispatch.group_size(10, False, 1) is None
    assert dispatch.group_size(10, False, 3) == 3
    assert dispatch.group_size(10, True, 1) == 10
    assert dispatch.group_size(100, True, 4) == dispatch.SINGLE_DISPATCH_CHUNKS
    assert dispatch.group_size(0, True, 1) == 1
    for bad in (0, -2, 2.5):
        with pytest.raises(ValueError, match="chunks_per_dispatch"):
            dispatch.group_size(10, False, bad)


def test_schedule_rows_stats_and_history():
    sched = dispatch.Schedule([(0.5, 0.25), (0.75, 0.125), (1.0, 0.0)],
                              [(7, 1), (8, 2), (-9, 3)], "cpu")
    assert sched.floats.dtype == torch.float32
    assert sched.ints.dtype == torch.int32
    for k in range(3):
        f, i = sched.row()
        assert f.tolist() == sched.floats[k].tolist()
        assert i.tolist() == sched.ints[k].tolist()
        assert i.is_contiguous() and tuple(i.shape) == (2,)
        sched.record(tuple(torch.tensor(v, dtype=torch.int64)
                           for v in (k, 10 * k, 2, k % 2)))
    assert int(sched.k) == 3
    hist, out_of_range = sched.history()
    assert hist == [(0, 0, 2), (1, 10, 2), (2, 20, 2)] and out_of_range == 1
    with pytest.raises(OverflowError):
        dispatch.Schedule([(0.0,)], [(2 ** 31,)], "cpu")


def test_run_on_the_cpu_runs_every_body_in_turn():
    calls, counts = [], {"kernel": 0}
    x = torch.zeros(1)

    def body():
        calls.append(float(x))
        x.add_(1)
        counts["kernel"] += 1

    timing = {}
    dispatch.run(body, [x], 7, 3, (counts,), timing)
    assert calls == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert counts == {"kernel": 7}
    assert timing["replays"] == 0 and timing["chunks"] == 7
    assert timing["chunks_per_replay"] == 3
    assert timing["remainder_ms"] >= 0 and timing["capture_ms"] == 0


# ----------------------------------------------------------------------
# The schedule tables against JAX's in-graph float32 schedules
# ----------------------------------------------------------------------

class _Recorded(Exception):
    pass


def _recorded_schedule(monkeypatch, train):
    """The (floats, ints) a grouped trainer uploads, recorded before its
    first chunk runs (the run stops there)."""
    seen = {}

    def record(floats, ints, device):
        seen["floats"] = np.asarray(floats, np.float32)
        seen["ints"] = np.asarray(ints, np.int64)
        raise _Recorded

    monkeypatch.setattr(dispatch, "Schedule", record)
    with pytest.raises(_Recorded):
        train()
    return seen["floats"], seen["ints"]


def _jax_schedules(kw, ks):
    """lr_k, eps_k (float32) and eps_int as the JAX trainers' grouped
    modes compute them in the graph from k.astype(float32)."""
    chunk_len = kw["chunk_len"]
    lr_hl = kw.get("lr_halflife", 0)

    @jax.jit
    def sched(k):
        def decay(base, hl, k, floor=0.0):
            d = base * (0.5 ** (k * chunk_len / hl) if hl else 1.0)
            return jnp.maximum(d, floor)

        lr = decay(kw["lr"], lr_hl, k)
        if kw.get("lr_anneal_tau", 0.0) > 0:
            over = jnp.maximum(k - kw["lr_anneal_start"], 0.0)
            lr = lr * (1.0 + over / kw["lr_anneal_tau"]) ** (
                -kw.get("lr_anneal_pow", 1.0))
        eps = decay(kw["eps"], kw["eps_halflife"], k, kw["eps_min"])
        return lr, eps, jnp.round(eps * 65536).astype(jnp.int32)

    return [np.asarray(x) for x in sched(jnp.asarray(ks, jnp.float32))]


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# The JAX package's 11x7 contract (tests/test_learner_kernel.py:145-150)
# and alternating gate (tests/test_altq_kernel.py:199-220) schedules.
RECIPE_11X7 = dict(chunk_len=32, lr=1.0, eps=0.25, eps_halflife=40000,
                   eps_min=0.15, lr_anneal_start=2500, lr_anneal_tau=160.0,
                   lr_anneal_pow=1.2)
RECIPE_ALT = dict(chunk_len=32, lr=1.0, eps=0.25, eps_halflife=300000,
                  eps_min=0.1, lr_anneal_start=200, lr_anneal_tau=25.0,
                  lr_anneal_pow=1.5)


@pytest.mark.parametrize("trainer", ["minimax", "iql", "altq"])
@pytest.mark.parametrize("recipe,start,n", [
    (RECIPE_11X7, 0, 6000), (RECIPE_ALT, 150, 250),
    (dict(chunk_len=4, lr=0.6, lr_halflife=40, eps=0.35, eps_halflife=12,
          eps_min=0.1, lr_anneal_start=2, lr_anneal_tau=3.0,
          lr_anneal_pow=1.2), 0, 40)], ids=["11x7", "alt", "small"])
def test_schedule_tables_follow_jax_in_graph(monkeypatch, trainer, recipe,
                                             start, n):
    kw = dict(recipe, batch=256, n_chunks=n, start_chunk=start, seed=3,
              device="cpu", chunks_per_dispatch=8)
    ks = np.arange(start, start + n)
    if trainer != "minimax":
        kw.pop("lr_halflife", None)
    jlr, jeps, jeps_int = _jax_schedules(kw, ks)
    if trainer == "minimax":
        floats, ints = _recorded_schedule(
            monkeypatch, lambda: lk.fused_minimax_train(CFG, avg_after=4,
                                                        **kw))
        assert (_ulps(floats[:, 1], jeps) <= 1).all()
        assert np.array_equal(floats[:, 2], (ks >= 4).astype(np.float32))
    else:
        fn = ik.fused_iql_train if trainer == "iql" else ak.fused_altq_train
        floats, ints = _recorded_schedule(monkeypatch, lambda: fn(CFG, **kw))
        assert np.abs(ints[:, 1] - jeps_int).max() <= 1
        assert np.array_equal(ints[:, 2], ks * kw["chunk_len"])
    assert (_ulps(floats[:, 0], jlr) <= 4).all()
    assert np.array_equal(ints[:, 0], 3 * 1_000_003 + ks)


# ----------------------------------------------------------------------
# Chunk 0 of a grouped run against JAX's grouped mode
# ----------------------------------------------------------------------

CONST = dict(batch=256, n_chunks=1, chunk_len=4, lr=0.5, eps=0.3, seed=7,
             chunks_per_dispatch=3, return_state=True)


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


def test_minimax_grouped_first_chunk_equals_jax():
    jq, jv, jpa, jpb, jhist, jres = jlk.fused_minimax_train(
        JCFG, solver_iters=50, interpret=True, **CONST)
    q, v, pa, pb, hist, res = lk.fused_minimax_train(
        CFG, solver_iters=50, device="cpu", **CONST)
    assert hist == [tuple(r) for r in jhist]
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(res["n"].numpy(), np.asarray(jres["n"]))
    for a, b in ((v, jv), (pa, jpa), (pb, jpb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    _assert_planes_equal(res["fields"], jres["fields"])


def test_iql_and_altq_grouped_first_chunk_equal_jax():
    jqa, jqb, jhist, jres = jik.fused_iql_train(JCFG, interpret=True,
                                                **CONST)
    qa, qb, hist, res = ik.fused_iql_train(CFG, device="cpu", **CONST)
    assert hist == [tuple(r) for r in jhist]
    assert np.array_equal(qa.numpy(), np.asarray(jqa))
    assert np.array_equal(qb.numpy(), np.asarray(jqb))
    _assert_planes_equal(res["fields"], jres["fields"])
    jq, jhist, jres = jak.fused_altq_train(JCFG, interpret=True, **CONST)
    q, hist, res = ak.fused_altq_train(CFG, device="cpu", **CONST)
    assert hist == [tuple(r) for r in jhist]
    assert np.array_equal(q.numpy(), np.asarray(jq)) and q.abs().max() > 0
    _assert_planes_equal(res["fields"], jres["fields"])
