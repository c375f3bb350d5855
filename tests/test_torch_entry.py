"""The port's entry point (gym_soccer_tpu_torch.entry) against the JAX
package's ``__graft_entry__.entry()`` on the CPU (its off-TPU shape, 256
lanes x 4 steps, Pallas in interpret mode), and the best-response gate's
score (``agents/evaluation.win_share``) against the JAX test's formula.

Tolerances: the inputs, final fields, stats and visit counts exact; the
residual sums per cell within cnt * (2**-8 * max|delta| + 1e-6), as in
tests/test_torch_learner_kernel.py (the JAX kernel rounds each residual
to bfloat16; at the entry's v = 0 they are the integer rewards, so the
sums come out equal)."""
import inspect
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gym_soccer_tpu.ops import learner_kernel as jlk
from gym_soccer_tpu_torch import entry, interop
from gym_soccer_tpu_torch.agents import evaluation
from gym_soccer_tpu_torch.core import batch
from gym_soccer_tpu_torch.ops import learner_kernel as lk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's inputs and outputs as numpy arrays."""
    fn, (seed, m, fields) = graft.entry()
    out_fields, acc, stats = fn(seed, m, fields)
    res, cnt = jlk.unpack_acc2(entry.CFG, acc)
    return dict(seed=seed, m=np.asarray(m, np.float32),
                fields=[np.asarray(f) for f in fields],
                out_fields=[np.asarray(f) for f in out_fields],
                res=np.asarray(res), cnt=np.asarray(cnt),
                stats=[int(x) for x in stats])


def _check_outputs(out, j):
    fields, acc, stats = out
    for a, b in zip(interop.planes_to_tiles(fields), j["out_fields"]):
        assert np.array_equal(a, b)
    assert [int(x) for x in stats[:3]] == j["stats"]
    assert int(stats[3]) == 0
    res, cnt = (a.numpy() for a in lk.unpack_acc2(entry.CFG, acc))
    assert np.array_equal(cnt, j["cnt"])
    assert int(cnt.sum()) == entry.CPU_SHAPE[0] * entry.CPU_SHAPE[1]
    max_delta = 1.0   # v = 0: each residual is a reward in {-1, 0, 1}
    tol = cnt * (2.0 ** -8 * max_delta + 1e-6)
    assert (np.abs(res - j["res"]) <= tol).all()


def test_entry_inputs_equal_the_jax_entrys(jax_entry):
    fn, (seed, table, fields) = entry.entry("cpu")
    assert seed == jax_entry["seed"] == 0
    want = interop.table_from_packed_m(entry.CFG, jax_entry["m"], "cpu")
    assert table.dtype == torch.float32 and torch.equal(table, want)
    for a, b in zip(fields, interop.planes_from_tiles(jax_entry["fields"],
                                                      "cpu")):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert len(fields) == 6 and fields[0].shape == (entry.CPU_SHAPE[0],)


def test_entry_equals_the_jax_entry(jax_entry):
    """The port's fn on its own inputs and on the JAX entry's, brought
    across with interop, against the JAX entry's chunk."""
    fn, args = entry.entry("cpu")
    _check_outputs(fn(*args), jax_entry)
    table = interop.table_from_packed_m(entry.CFG, jax_entry["m"], "cpu")
    fields = interop.planes_from_tiles(jax_entry["fields"], "cpu")
    _check_outputs(fn(jax_entry["seed"], table, fields), jax_entry)


def test_entry_runs_on_the_card_by_default():
    assert inspect.signature(entry.entry).parameters["device"].default \
        == "cuda"
    assert entry.CARD_SHAPE == (8192, 64) and entry.CPU_SHAPE == (256, 4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        entry.entry()
    with pytest.raises((RuntimeError, AssertionError)):
        evaluation.greedy_win_share(entry.CFG, np.zeros(761, np.int32),
                                    np.zeros(761, np.int32))


def _jax_test_formula(out):
    """tests/test_learner_kernel.py:483-486 on numpy arrays."""
    done = np.asarray(out.done)
    wins = ((np.asarray(out.reward_a) > 0) & done).sum()
    eps_n = (done | np.asarray(out.truncated)).sum()
    return wins / eps_n


def test_win_share_is_the_jax_gates_formula():
    rng = np.random.default_rng(5)
    T, B = 7, 64
    done = rng.random((T, B)) < 0.3
    trunc = ~done & (rng.random((T, B)) < 0.2)
    reward = np.where(done, rng.choice([-1.0, 1.0], (T, B)), 0.0)
    zeros = torch.zeros((T, B), dtype=torch.int32)
    out = batch.StepOut(obs=zeros, reward_a=torch.tensor(reward,
                                                         dtype=torch.float32),
                        done=torch.tensor(done), truncated=torch.tensor(trunc),
                        final_obs=zeros, prob=zeros.float())
    want = _jax_test_formula(out)
    assert 0 < want < 1
    assert evaluation.win_share(out) == want


def test_greedy_win_share_scores_a_rollout():
    """The helper plays the policies on the batched engine from
    default_rng(seed)'s key words and scores the stacked StepOut."""
    cfg = entry.CFG
    pol_a = np.random.RandomState(1).randint(0, 5, 761).astype(np.int32)
    pol_b = np.random.RandomState(42).randint(0, 5, 761).astype(np.int32)
    got = evaluation.greedy_win_share(cfg, pol_a, pol_b, lanes=128,
                                      steps=120, seed=9, device="cpu")
    keys = np.random.default_rng(9).integers(0, 2 ** 32, (128, 2),
                                             dtype=np.uint64)
    pa, pb = torch.as_tensor(pol_a).long(), torch.as_tensor(pol_b).long()
    _, out = batch.rollout(cfg, batch.init_from_keys(cfg, keys, "cpu",
                                                     rng="counter"),
                           lambda obs, i: (pa[obs.long()], pb[obs.long()]),
                           120, rng="counter")
    assert got == _jax_test_formula(out)
    assert int(out.truncated.sum()) > 0 and int(out.done.sum()) > 0
