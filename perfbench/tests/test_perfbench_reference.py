"""The plain reference against the port's CPU paths at tiny sizes, on both
boards: the journaled rollout word for word, the game model against the
port's tables, RM+ and the best-response evaluation within rounding."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gym_soccer_tpu_torch.agents import evaluation  # noqa: E402
from gym_soccer_tpu_torch.agents.learners import solve_matrix_games  # noqa
from gym_soccer_tpu_torch.config import EnvConfig  # noqa: E402
from gym_soccer_tpu_torch.core import tables  # noqa: E402
from gym_soccer_tpu_torch.ops.learner_kernel import fused_minimax_train  # noqa
from gym_soccer_tpu_torch.ops.step_kernel import (  # noqa: E402
    fused_journal_rollout, unpack_journal)
from perfbench.reference import game, learner, markov  # noqa: E402
from perfbench.traffic import rollout_journal  # noqa: E402

BOARDS = [(5, 4), (11, 7)]


@pytest.mark.parametrize("w,h", BOARDS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 32 - 1])
def test_rollout_equals_the_port(w, h, seed):
    """Journal words, final fields and totals, from the initial spread and
    resumed across calls, at step offsets that cross a truncation."""
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    b = game.Board(w, h, 0.2)
    fields, rf, offset = None, game.start_fields(b, 1024, "cpu"), 0
    for n in (120, 37):
        out, stats, words = fused_journal_rollout(
            cfg, seed & 0xFFFFFFFF, 1024, n, device="cpu",
            init_fields=fields, step_offset=offset)
        rf, rs, rw = game.journal_rollout(b, seed & 0xFFFFFFFF, rf, n, offset)
        assert torch.equal(words, rw)
        assert all(torch.equal(x.long(), y) for x, y in zip(out, rf))
        assert tuple(int(x) for x in stats) == rs
        fields, offset = out, offset + n


@pytest.mark.parametrize("w,h", BOARDS)
def test_stream_equals_the_port_decode(w, h):
    """The reference's own record, mapped to dense states, equals the
    port's ``unpack_journal`` of its journal entry for entry."""
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    b = game.Board(w, h, 0.2)
    _, _, words = fused_journal_rollout(cfg, 77, 1024, 150, device="cpu")
    *_, rec = game.journal_rollout(b, 77, game.start_fields(b, 1024, "cpu"),
                                   150, 0, record=True)
    r2d = torch.as_tensor(markov.StateSpace(b).raw_to_dense)
    ref = rollout_journal.reference_stream(r2d, rec)
    got = unpack_journal(cfg, words)
    assert set(got) == set(ref)
    for key in ref:
        assert torch.equal(got[key].double(), ref[key].double()), key


TRAIN_RECIPE = dict(batch=1024, chunk_len=8, lr=1.0, gamma=0.99, eps=0.25,
                    eps_halflife=40, eps_min=0.15, lr_anneal_start=1,
                    lr_anneal_tau=2.0, lr_anneal_pow=1.2, solver_iters=50)


@pytest.mark.parametrize("w,h", BOARDS)
@pytest.mark.parametrize("g", [1, 2])
def test_learner_chunk_follows_the_port(w, h, g):
    """Each of the port's first three chunks, followed by the reference
    from the port's state before it: the fields and visit counts equal,
    Q within float32 rounding; the reference in bfloat16 is far."""
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    b = game.Board(w, h, 0.2)
    ss = markov.StateSpace(b)
    nS = ss.nS
    before = {"q": torch.zeros(nS, 5, 5), "v": torch.zeros(nS),
              "pi_a": torch.full((nS, 5), 0.2),
              "pi_b": torch.full((nS, 5), 0.2), "n": torch.zeros(nS, 5, 5),
              "fields": game.start_fields(b, 1024, "cpu")}
    for k in range(3):
        after = fused_minimax_train(cfg, **TRAIN_RECIPE, n_chunks=k + 1,
                                    seed=1234, device="cpu",
                                    chunks_per_dispatch=g,
                                    return_state=True)[5]
        q, cnt, f = learner.chunk(b, ss.raw_to_dense, before, 1234, k,
                                  TRAIN_RECIPE)
        assert float((after["q"].double() - q).abs().max()) < 2e-7
        assert all(torch.equal(x.long(), y) for x, y in zip(after["fields"],
                                                            f))
        assert torch.equal(after["n"].double(), before["n"].double() + cnt)
        qb, _, _ = learner.chunk(b, ss.raw_to_dense, before, 1234, k,
                                 TRAIN_RECIPE, torch.bfloat16)
        assert float((after["q"].double() - qb.double()).abs().max()) > 1e-4
        before = after


def test_schedules():
    """The recipe's schedules: lr annealed after its start, eps halved
    over its half-life down to its floor, chunk k acting with chunk k -
    1's eps."""
    r = dict(TRAIN_RECIPE, chunk_len=32)
    assert learner.lr_at(r, 1) == 1.0
    assert learner.lr_at(r, 3) == pytest.approx((1 + 2 / 2.0) ** -1.2,
                                                rel=1e-7)
    assert learner.eps_at(r, 0) == pytest.approx(0.25)
    assert learner.eps_at(r, 1000) == pytest.approx(0.15)
    assert learner.behaviour_eps(r, 0) == learner.eps_at(r, 0)
    assert learner.behaviour_eps(r, 5) == learner.eps_at(r, 4)
    assert learner.chunk_seed(2 ** 31 - 1, 3) == \
        ((2 ** 31 - 1) * 1_000_003 + 3) & 0xFFFFFFFF


def test_rollout_on_a_sample_of_lanes():
    """A sample of lanes, by their global ids, steps as in the whole."""
    b = game.Board(5, 4, 0.2)
    f = game.start_fields(b, 2048, "cpu")
    whole, _, words = game.journal_rollout(b, 9, f, 30, 5)
    lanes = torch.tensor([3, 700, 2047])
    part, _, pw = game.journal_rollout(b, 9, [x[lanes] for x in f], 30, 5,
                                       lanes=lanes)
    assert torch.equal(pw, words[:, lanes])


@pytest.mark.parametrize("w,h", [(5, 4), (6, 5)])
def test_model_equals_the_port_tables(w, h):
    """Each (state, joint action)'s distribution over next states, its
    expected reward and terminal mass equal the port's tables."""
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    (prob, nxt, rew, done), ss = markov.build_model(game.Board(w, h, 0.2))
    tb = tables.build_tables(cfg)
    assert ss.nS == tb.nS
    assert np.array_equal(ss.dense_raw, tb.dense_to_raw)
    assert np.array_equal(ss.isd_dense, tb.raw_to_dense[tb.isd_raw])
    nS = ss.nS
    rows = np.arange(nS * 25)

    def dist(p, n):
        out = np.zeros((nS * 25, nS))
        p = p.reshape(nS * 25, -1)
        np.add.at(out, (np.repeat(rows, p.shape[1]), n.reshape(-1)),
                  p.reshape(-1))
        return out

    assert np.abs(dist(prob, nxt) - dist(tb.t_prob, tb.t_next_dense)
                  ).max() < 1e-15
    assert np.array_equal((prob * rew).sum(-1).reshape(-1),
                          (tb.t_prob * tb.t_reward).sum(-1).reshape(-1))


def test_rmplus_near_the_port():
    M = torch.randn(64, 5, 5, generator=torch.Generator().manual_seed(1))
    v, x, y = markov.rmplus(M, 300)
    pv, px, py = solve_matrix_games(M, 300)
    assert float((v - pv.double()).abs().max()) < 1e-4
    assert float((markov.game_value(M.double(), px, py) - v).abs().max()) \
        < 1e-4


def test_rmplus_bfloat16_is_far():
    """The control's bfloat16 RM+ is far from the float64 solve."""
    M = torch.randn(64, 5, 5, generator=torch.Generator().manual_seed(2))
    v, _, _ = markov.rmplus(M, 400)
    vb, _, _ = markov.rmplus(M, 400, torch.bfloat16)
    assert float((vb.double() - v).abs().max()) > 1e-3


def test_exploitability_near_the_port():
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    m = markov.Model(game.Board(5, 4, 0.2), "cpu")
    rng = np.random.default_rng(0)
    pa, pb = (torch.tensor(rng.dirichlet(np.ones(5), m.ss.nS),
                           dtype=torch.float32) for _ in range(2))
    ref = markov.exploitability(m, pa, pb)
    port = evaluation.exploitability(cfg, pa, pb, device="cpu")
    assert abs(ref - port) < 1e-5
