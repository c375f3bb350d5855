"""The port's minimax-Q learner (gym_soccer_tpu_torch.ops.learner_kernel)
on the CPU, where the chunk wrapper runs its plain version, against the
JAX package's ``packed_learner_chunk(interpret=True)`` and
``fused_minimax_train(interpret=True)`` fed the same tables and states.

Tolerances:

* final fields, stats and visit counts: exact.  Both packages sample from
  the same bfloat16 pi values with the same counter PRNG.
* residual sums: per cell within cnt * (2**-8 * max|delta| + 1e-6), where
  max|delta| <= 1 + 2 * max|v|.  The JAX kernel rounds each residual to
  bfloat16 before its float32 scatter-add (learner_kernel.py:576-577) and
  bootstraps from a double-bfloat16 v; the port sums exact fixed point.
  With v = 0 the residuals are the integer rewards and the sums are equal.
* the trainer after its first chunk: q and n exact (chunk 0 starts from
  v = q = 0, so its sums are exact), v and pi within 1e-5.

The K5 kernel is held against the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import learner_kernel as jlk
from gym_soccer_tpu.utils.policies import get_random_policy_array
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.agents.evaluation import (best_response_value,
                                                    exploitability)
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import learner_kernel as lk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG, JCFG = EnvConfig(5, 4, 0.2), JaxConfig(5, 4, 0.2)
NS = 761
jax_pack = jax.jit(jlk.pack_m2, static_argnums=(0,))


def _tables(board, seed, uniform):
    """(pi_a, pi_b, v) as numpy: the trainer's chunk-0 contents (uniform,
    v = 0), or random non-uniform policies and v in [-1, 1]."""
    nS = len(lk._cell_rows(EnvConfig(*board, 0.2)))
    if uniform:
        pi = np.full((nS, 5), 0.2, np.float32)
        return pi, pi, np.zeros(nS, np.float32)
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(5), nS).astype(np.float32),
            rng.dirichlet(np.ones(5), nS).astype(np.float32),
            rng.uniform(-1, 1, nS).astype(np.float32))


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("board,B,T,seed,uniform", [
    ((5, 4), 256, 4, 0, True),      # the entry's off-TPU shape, chunk 0
    ((5, 4), 1024, 16, 3, False),
    ((11, 7), 256, 4, 5, False),
], ids=["entry", "random", "11x7"])
def test_chunk_plain_equals_jax(board, B, T, seed, uniform):
    jcfg, cfg = JaxConfig(*board, 0.2), EnvConfig(*board, 0.2)
    pa, pb, v = _tables(board, seed, uniform)
    m = jax_pack(jcfg, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(v), 0.2)
    jfields0 = jlk.init_state_fields(jcfg, B)
    jfields, jacc, jstats = jlk.packed_learner_chunk(
        jcfg, seed, m, jfields0, B, T, interpret=True)
    jres, jcnt = (np.asarray(a) for a in jlk.unpack_acc2(jcfg, jacc))

    table = interop.table_from_packed_m(cfg, np.asarray(m, np.float32), "cpu")
    fields0 = interop.planes_from_tiles(jfields0, "cpu")
    fields, acc, stats = lk.packed_learner_chunk(cfg, seed, table, fields0,
                                                 B, T, 0.99)
    res, cnt = (a.numpy() for a in lk.unpack_acc2(cfg, acc))

    _assert_planes_equal(fields, jfields)
    assert [int(x) for x in stats[:3]] == [int(x) for x in jstats]
    assert int(stats[3]) == 0   # no table value out of the sums' range
    assert np.array_equal(cnt, jcnt) and int(cnt.sum()) == B * T
    assert acc[0].dtype == torch.int64 and acc[1].dtype == torch.int32
    if uniform:
        assert np.array_equal(res, jres)
    else:
        max_delta = 1 + 2 * float(table[:, lk.COL_V].abs().max())
        tol = cnt * (2.0 ** -8 * max_delta + 1e-6)
        assert (np.abs(res - jres) <= tol).all(), np.abs(res - jres).max()
        assert np.abs(res - jres).max() > 0   # the bf16 rounding is there


def _eps_pins():
    """pi values whose mixed, bf16-rounded value depends on how
    pi * (1 - eps) + eps / 5 is rounded: eps in float32 or float64,
    eps / 5 as a division or as eps * 0.2, an FMA or two roundings."""
    rng = np.random.default_rng(0)
    pis = rng.uniform(0, 0.06, 2_000_000).astype(np.float32)
    found = []
    for eps in (0.3, 0.1879010796546936):
        e = np.float32(eps)
        variants = [(np.float32(1 - eps), np.float32(eps / 5), False),
                    (np.float32(1 - e), np.float32(e / np.float32(5)), True),
                    (np.float32(1 - e), np.float32(e * np.float32(0.2)), True),
                    (np.float32(1 - e), np.float32(e * np.float32(0.2)), False)]
        outs = []
        for e1, e2, fused in variants:
            x = (pis.astype(np.float64) * e1 + e2).astype(np.float32) if fused \
                else pis * e1 + e2
            outs.append(torch.tensor(x).to(torch.bfloat16).float().numpy())
        differ = np.zeros(len(pis), bool)
        for o in outs[1:]:
            differ |= o != outs[0]
        found.append((eps, pis[differ]))
    return found


def test_pack_equals_jax_pack_m2_on_both_eps_paths():
    """The first chunk's table is packed with eps as a Python float, the
    later ones with a float32 eps; under jit both round as float32 with an
    FMA and eps / 5 -> eps * 0.2.  The port's pi is bit-equal to JAX's on
    values that tell those roundings apart."""
    rows = jlk._cell_rows(JCFG)
    idx = ((rows // jlk.GP) * 128 + (rows % jlk.GP) * jlk.GCOLS)[:, None]
    for eps, pins in _eps_pins():
        assert len(pins) >= 10
        _, pb, v = _tables((5, 4), 9, False)
        pa = np.full((NS, 5), 0.2, np.float32)
        k = min(len(pins), NS * 5)
        pa.flat[:k] = pins[:k]
        table = lk.pack_m2(CFG, torch.tensor(pa), torch.tensor(pb),
                           torch.tensor(v), eps).numpy()
        codes = lk._cell_rows(CFG)
        for e in (eps, jnp.float32(eps)):
            m = np.asarray(jax_pack(JCFG, jnp.asarray(pa), jnp.asarray(pb),
                                    jnp.asarray(v), e), np.float32).ravel()
            assert np.array_equal(table[codes, 0:5], m[idx + np.arange(5)])
            assert np.array_equal(table[codes, 5:10], m[idx + 5 + np.arange(5)])
            # v: exact in the port, double-bfloat16 in JAX (~2**-18 apart)
            jv = m[idx[:, 0] + jlk.PCOL_V] + m[idx[:, 0] + jlk.PCOL_V_LO]
            np.testing.assert_allclose(table[codes, 10], v, rtol=0, atol=0)
            np.testing.assert_allclose(jv, v, rtol=0, atol=2.0 ** -17)
        # the table made from JAX's M carries the same pi
        back = interop.table_from_packed_m(CFG, m.reshape(-1, 128), "cpu")
        assert np.array_equal(back[:, :10].numpy(), table[:, :10])
    # rows of codes that are no dense state stay empty
    empty = np.setdiff1d(np.arange(lk.n_codes(CFG)), lk._cell_rows(CFG))
    assert len(empty) and not table[empty].any()


def test_layout_helpers_equal_jax():
    for board in ((5, 4), (11, 7)):
        jcfg, cfg = JaxConfig(*board, 0.2), EnvConfig(*board, 0.2)
        assert np.array_equal(lk._cell_rows(cfg), jlk._cell_rows(jcfg))
        assert lk.n_codes(cfg) == jlk._n_codes(jcfg)
        _assert_planes_equal(lk.init_state_fields(cfg, 512, "cpu"),
                             jlk.init_state_fields(jcfg, 512))


TRAIN = dict(batch=256, chunk_len=4, lr=0.5, eps=0.3, solver_iters=50,
             seed=7)


def _jax_resume(res):
    return {k: [np.asarray(f) for f in x] if k == "fields" else np.asarray(x)
            for k, x in res.items()}


def test_first_between_step_equals_jax():
    jq, jv, jpa, jpb, jhist, jres = jlk.fused_minimax_train(
        JCFG, n_chunks=1, return_state=True, interpret=True, **TRAIN)
    q, v, pa, pb, hist, res = lk.fused_minimax_train(
        CFG, n_chunks=1, return_state=True, device="cpu", **TRAIN)
    assert hist == jhist
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(res["n"].numpy(), np.asarray(jres["n"]))
    for a, b in ((v, jv), (pa, jpa), (pb, jpb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    _assert_planes_equal(res["fields"], jres["fields"])
    assert res["next_chunk"] == 1 and res["packed"] is True


def test_resume_from_jax_state_follows_jax():
    """A JAX run's resume dict continues in the port: the same trajectories
    and visit counts as the JAX run's next chunk, q within the residual
    tolerance (lr * (2**-8 * 3 + 1e-6))."""
    _, _, _, _, jhist, jres2 = jlk.fused_minimax_train(
        JCFG, n_chunks=2, return_state=True, interpret=True, **TRAIN)
    jres1 = jlk.fused_minimax_train(JCFG, n_chunks=1, return_state=True,
                                    interpret=True, **TRAIN)[5]
    r = interop.resume_from_numpy(_jax_resume(jres1), "cpu")
    assert r["next_chunk"] == 1 and r["packed"] is True
    assert all(r[k].dtype == torch.float32 for k in ("q", "v", "n"))
    # init takes the JAX run's arrays as numpy, as they are
    init = tuple(_jax_resume(jres1)[k] for k in ("q", "v", "pi_a", "pi_b",
                                                  "n"))
    _, _, _, _, hist, res = lk.fused_minimax_train(
        CFG, n_chunks=1, return_state=True, init=init,
        fields_init=r["fields"], start_chunk=r["next_chunk"], device="cpu",
        **TRAIN)
    assert hist == jhist[-1:]
    _assert_planes_equal(res["fields"], jres2["fields"])
    assert np.array_equal(res["n"].numpy(), np.asarray(jres2["n"]))
    np.testing.assert_allclose(res["q"].numpy(), np.asarray(jres2["q"]),
                               rtol=0, atol=TRAIN["lr"] * (3 * 2.0 ** -8 + 1e-6))


def test_trainer_exact_resume():
    """2 chunks in one call equal 1 + 1 through the resume dict, bit for
    bit, with annealed lr and eps."""
    kw = dict(batch=256, chunk_len=4, lr=0.5, eps=0.4, eps_halflife=32,
              lr_anneal_start=1, lr_anneal_tau=4.0, solver_iters=30, seed=7,
              device="cpu")
    q, v, pa, pb, hist, res = lk.fused_minimax_train(
        CFG, n_chunks=2, return_state=True, **kw)
    r1 = lk.fused_minimax_train(CFG, n_chunks=1, return_state=True, **kw)[5]
    q2, v2, pa2, pb2, hist2, res2 = lk.fused_minimax_train(
        CFG, n_chunks=1, return_state=True,
        init=tuple(r1[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
        fields_init=r1["fields"], start_chunk=r1["next_chunk"], **kw)
    for a, b in ((q, q2), (v, v2), (pa, pa2), (pb, pb2), (res["n"], res2["n"]),
                 *zip(res["fields"], res2["fields"])):
        assert torch.equal(a, b)
    assert res2["next_chunk"] == 2 and hist2 == hist[-1:]


def test_warm_start_and_post_processing():
    """init with lr 0 keeps Q; avg_after / avg_q / final_solver_iters
    change only the returned strategies (and v), never q."""
    rng = np.random.RandomState(0)
    q0 = torch.tensor(rng.uniform(-0.5, 0.5, (NS, 5, 5)), dtype=torch.float32)
    pi0 = torch.full((NS, 5), 0.2)
    q, _, pa, _, _ = lk.fused_minimax_train(
        CFG, batch=256, n_chunks=1, chunk_len=4, lr=0.0, eps=0.5,
        solver_iters=50, init=(q0, q0.mean((1, 2)), pi0, pi0), device="cpu")
    assert torch.equal(q, q0)
    assert not torch.allclose(pa, pi0, atol=1e-3)
    kw = dict(batch=256, n_chunks=4, chunk_len=4, lr=0.7, eps=0.4,
              solver_iters=40, seed=11, device="cpu")
    base = lk.fused_minimax_train(CFG, **kw)
    for extra in (dict(avg_after=1), dict(avg_after=1, avg_q=True),
                  dict(final_solver_iters=80)):
        out = lk.fused_minimax_train(CFG, **kw, **extra)
        assert torch.equal(out[0], base[0]), extra
        assert not torch.equal(out[2], base[2]), extra
        np.testing.assert_allclose(out[2].sum(-1).numpy(), 1.0, atol=1e-5)


def test_fused_training_learns():
    """A short run (the plain chunk on the CPU) drives exploitability at
    gamma 0.9 far below the uniform pair's, as the JAX package's
    test_convergence_recipe_trains_toward_equilibrium does."""
    gamma = 0.9
    q, v, pa, pb, hist = lk.fused_minimax_train(
        CFG, batch=4096, n_chunks=120, chunk_len=8, lr=1.0, eps=0.25,
        gamma=gamma, lr_anneal_start=60, lr_anneal_tau=10.0,
        lr_anneal_pow=1.5, solver_iters=200, final_solver_iters=1500, seed=5,
        device="cpu")
    uniform = torch.full((NS, 5), 0.2)
    ex_uniform = exploitability(CFG, uniform, uniform, gamma=gamma)
    ex_trained = exploitability(CFG, pa, pb, gamma=gamma)
    assert ex_trained < ex_uniform / 4, (ex_trained, ex_uniform)
    assert ex_trained < 0.1, ex_trained
    assert float(v.abs().max()) <= 1.05
    assert sum(h[1] for h in hist) > 0


@pytest.mark.parametrize("side,opp_seed,seed", [("player_a", 42, 3),
                                                ("player_b", 7, 4)])
def test_fused_best_response_matches_exact_br(side, opp_seed, seed):
    """The frozen-opponent trainer approaches the exact best-response
    value, and the frozen side plays its policy exactly."""
    gamma = 0.85
    opp = np.asarray(get_random_policy_array(NS, 5, seed=opp_seed))
    q, v, pa, pb, hist = lk.fused_best_response_train(
        CFG, opp, side, batch=1024, n_chunks=40, chunk_len=8, lr=1.0,
        gamma=gamma, eps=0.3, eps_halflife=160, eps_min=0.1, seed=seed,
        device="cpu")
    opp_oh = torch.nn.functional.one_hot(torch.tensor(opp).long(), 5).float()
    assert torch.equal(pb if side == "player_a" else pa, opp_oh)
    v_br, _ = best_response_value(CFG, opp_oh, side, gamma=gamma)
    want = v_br if side == "player_a" else -v_br
    err = (v - want).abs().mean().item()
    assert err < 0.08, f"mean |v - V_br| = {err:.3f}"
    assert sum(h[1] for h in hist) > 0


def test_best_response_exact_resume():
    opp = np.asarray(get_random_policy_array(NS, 5, seed=3))
    kw = dict(batch=256, chunk_len=4, lr=0.8, eps=0.4, eps_halflife=64,
              eps_min=0.1, lr_anneal_start=1, lr_anneal_tau=4.0, gamma=0.9,
              seed=13, device="cpu")
    whole = lk.fused_best_response_train(CFG, opp, "player_a", n_chunks=3,
                                         return_state=True, **kw)
    r = lk.fused_best_response_train(CFG, opp, "player_a", n_chunks=1,
                                     return_state=True, **kw)[5]
    part = lk.fused_best_response_train(
        CFG, opp, "player_a", n_chunks=2, return_state=True,
        init=(r["q"], r["n"]), fields_init=r["fields"],
        start_chunk=r["next_chunk"], **kw)
    for a, b in zip(whole[:4], part[:4]):
        assert torch.equal(a, b)
    for a, b in zip(whole[5]["fields"], part[5]["fields"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("g", [1, 2])
def test_best_response_timing(g):
    """``timing`` splits a best-response run as it splits the minimax
    trainer's (chunk calls and between them, or ``dispatch.run``'s spans)
    and changes nothing in the result."""
    opp = np.asarray(get_random_policy_array(NS, 5, seed=3))
    kw = dict(batch=256, n_chunks=3, chunk_len=4, eps=0.4, seed=5,
              device="cpu", chunks_per_dispatch=g)
    timing = {}
    timed = lk.fused_best_response_train(CFG, opp, "player_a",
                                         timing=timing, **kw)
    plain = lk.fused_best_response_train(CFG, opp, "player_a", **kw)
    for a, b in zip(timed[:4], plain[:4]):
        assert torch.equal(a, b)
    assert timed[4] == plain[4] and timing["chunks"] == 3
    spans = (("kernel_ms", "between_ms") if g == 1
             else ("capture_ms", "segments_ms", "remainder_ms"))
    assert all(timing[k] >= 0 for k in spans)


def test_chunk_checks_its_arguments():
    table = torch.zeros((lk.n_codes(CFG), lk.TABLE_COLS))
    fields = lk.init_state_fields(CFG, 256, "cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        lk.packed_learner_chunk(CFG, 0, table, fields, 200, 4)
    with pytest.raises(ValueError, match="2\\*\\*29"):
        lk.packed_learner_chunk(CFG, 0, table, fields, 2 ** 22, 2 ** 8)
    with pytest.raises(ValueError, match="table"):
        lk.packed_learner_chunk(CFG, 0, table[:, :10].contiguous(), fields,
                                256, 4)
    with pytest.raises(ValueError, match="int32"):
        lk.packed_learner_chunk(CFG, 0, table, [f.long() for f in fields],
                                256, 4)
    with pytest.raises(ValueError, match="on meta"):   # one device for all
        lk.packed_learner_chunk(CFG, 0, table.to("meta"), fields, 256, 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lk.packed_learner_chunk(CFG, 0, table.to("meta"),
                                [f.to("meta") for f in fields], 256, 4)


def _refuse_meshes(monkeypatch):
    """Make ``dispatch.run``'s capture check refuse every mesh it is
    handed, as it refuses a gloo mesh on the card (which the CPU cannot
    build): a trainer that raises under it hands its mesh to the check
    before any body runs."""
    from gym_soccer_tpu_torch.ops import dispatch

    def refuse(mesh):
        if mesh is not None:
            raise ValueError("a gloo mesh's collectives cannot be captured")
    monkeypatch.setattr(dispatch, "check_capture", refuse)


def test_unported_modes_raise(monkeypatch):
    """No mode is left unported: a mesh of one rank (parallel/mesh) runs
    every mode and equals no mesh bit for bit, for one board and for a
    mixture, packed or not; the grouped modes hand their mesh to
    ``dispatch.run``'s capture check, which refuses a gloo mesh on the
    card (its collectives cannot be captured), and a device other than
    the mesh's is refused; the grouped dispatch modes run (below), tuples
    and packed=False too (tests/test_torch_multigrid.py,
    tests/test_torch_learner_unpacked.py), and a group size that is no
    positive integer is refused."""
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    one = pmesh.env_mesh(device="cpu")
    kw = dict(batch=256, n_chunks=1, chunk_len=4, device="cpu",
              solver_iters=2)
    for cfg in (CFG, (CFG, EnvConfig(6, 5, 0.1))):
        for extra in (dict(), dict(packed=False),
                      dict(chunks_per_dispatch=4)):
            want = lk.fused_minimax_train(cfg, **kw, **extra)
            got = lk.fused_minimax_train(cfg, mesh=one, **kw, **extra)
            assert all(torch.equal(a, b) for a, b in zip(want[:4], got[:4]))
            assert want[4] == got[4]
        for extra in (dict(single_dispatch=True), dict(chunks_per_dispatch=4),
                      dict(chunks_per_dispatch=2, packed=False)):
            assert len(lk.fused_minimax_train(cfg, **kw, **extra)[4]) == 1
    with pytest.raises(ValueError, match="mesh"):
        lk.fused_minimax_train(CFG, **dict(kw, device="meta"), mesh=one)
    with pytest.raises(ValueError, match="chunks_per_dispatch"):
        lk.fused_minimax_train(CFG, chunks_per_dispatch=0, **kw)
    kw.pop("solver_iters")
    opp = np.zeros(NS, int)
    want = lk.fused_best_response_train(CFG, opp, "player_a", **kw)
    got = lk.fused_best_response_train(CFG, opp, "player_a", mesh=one, **kw)
    assert all(torch.equal(a, b) for a, b in zip(want[:4], got[:4]))
    assert len(lk.fused_best_response_train(
        CFG, np.zeros(NS, int), "player_a", chunks_per_dispatch=2,
        **kw)[4]) == 1
    # per chunk, or fewer chunks than a replay, nothing is captured
    _refuse_meshes(monkeypatch)
    lk.fused_minimax_train(CFG, mesh=one, solver_iters=2, **kw)
    lk.fused_minimax_train(CFG, mesh=one, chunks_per_dispatch=4,
                           solver_iters=2, **kw)
    lk.fused_best_response_train(CFG, opp, "player_a", mesh=one, **kw)
    with pytest.raises(ValueError, match="gloo"):
        lk.fused_minimax_train(CFG, mesh=one, chunks_per_dispatch=4,
                               solver_iters=2, **dict(kw, n_chunks=4))
    with pytest.raises(ValueError, match="gloo"):
        lk.fused_best_response_train(CFG, opp, "player_a", mesh=one,
                                     chunks_per_dispatch=2,
                                     **dict(kw, n_chunks=2))


# The grouped runs' shape (7 chunks in segments of 3: two full segments
# and a remainder) and annealed schedules like the JAX tests' (lr halving
# and annealing, eps halving to a floor).
GROUPED = dict(batch=256, n_chunks=7, chunk_len=4, lr=0.6, eps=0.35,
               lr_halflife=40, eps_halflife=12, eps_min=0.1,
               lr_anneal_start=2, lr_anneal_tau=3.0, lr_anneal_pow=1.2,
               solver_iters=40, seed=5, device="cpu", return_state=True)
MIX = (CFG, EnvConfig(6, 5, 0.2))


def _assert_same_run(a, b, n_tensors):
    """Two trainer results equal bit for bit: the first ``n_tensors``
    outputs and every tensor of the resume dict."""
    for x, y in zip(a[:n_tensors], b[:n_tensors]):
        assert torch.equal(x, y)
    for key, x in a[-1].items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, b[-1][key]), key
        elif key == "fields":
            assert all(torch.equal(f, g) for f, g in zip(x, b[-1][key]))
        else:
            assert x == b[-1][key], key


def _per_chunk_rows(grouped_history, start, n):
    """The rows the per-chunk mode keeps (every 16th chunk and the last)
    of a grouped run's history of every chunk."""
    return [row for k, row in enumerate(grouped_history, start)
            if k % 16 == 0 or k == start + n - 1]


@pytest.mark.parametrize("cfg,packed,extra", [
    (CFG, True, dict(avg_after=3, avg_q=True, final_solver_iters=60)),
    (CFG, False, dict(avg_after=2, count_lr_tau=50.0)),
    (MIX, True, dict(avg_after=3, avg_q=True)),
    (MIX, False, dict(final_solver_iters=60)),
], ids=["5x4-packed-avg-q", "5x4-unpacked-avg-count-lr", "mixture-packed",
        "mixture-unpacked"])
def test_grouped_modes_equal_the_per_chunk_mode(cfg, packed, extra):
    """chunks_per_dispatch=3 and single_dispatch give the per-chunk run's
    q, v, pi, n, fields and post-processing bit for bit, across a
    remainder, and record every chunk's stats where the per-chunk mode
    keeps every 16th and the last."""
    per = lk.fused_minimax_train(cfg, packed=packed, **GROUPED, **extra)
    grouped = lk.fused_minimax_train(cfg, packed=packed, chunks_per_dispatch=3,
                                     **GROUPED, **extra)
    single = lk.fused_minimax_train(cfg, packed=packed, single_dispatch=True,
                                    **GROUPED, **extra)
    _assert_same_run(per, grouped, 4)
    _assert_same_run(grouped, single, 4)
    assert len(grouped[4]) == 7 and grouped[4] == single[4]
    assert per[4] == _per_chunk_rows(grouped[4], 0, 7)


@pytest.mark.parametrize("packed", [True, False])
def test_grouped_resume_inside_a_segment(packed):
    """A grouped run resumed at chunk 4, inside the uninterrupted run's
    second segment of 3, equals the uninterrupted grouped run."""
    kw = dict(GROUPED, n_chunks=None, packed=packed, chunks_per_dispatch=3)
    whole = lk.fused_minimax_train(CFG, **dict(kw, n_chunks=7))
    r = lk.fused_minimax_train(CFG, **dict(kw, n_chunks=4))[5]
    part = lk.fused_minimax_train(
        CFG, init=tuple(r[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
        fields_init=r["fields"], start_chunk=r["next_chunk"],
        **dict(kw, n_chunks=3))
    _assert_same_run(whole, part, 4)
    assert part[4] == whole[4][4:]


@pytest.mark.parametrize("side", ["player_a", "player_b"])
def test_best_response_grouped_equals_per_chunk(side):
    opp = np.random.default_rng(4).integers(0, 5, NS)
    kw = {k: v for k, v in GROUPED.items()
          if k not in ("solver_iters", "lr_halflife")}
    per = lk.fused_best_response_train(CFG, opp, side, **kw)
    grouped = lk.fused_best_response_train(CFG, opp, side,
                                           chunks_per_dispatch=3, **kw)
    _assert_same_run(per, grouped, 4)
    assert per[4] == _per_chunk_rows(grouped[4], 0, 7)
    r = lk.fused_best_response_train(CFG, opp, side, chunks_per_dispatch=3,
                                     **dict(kw, n_chunks=4))[5]
    part = lk.fused_best_response_train(
        CFG, opp, side, init=(r["q"], r["n"]), fields_init=r["fields"],
        start_chunk=r["next_chunk"], chunks_per_dispatch=3,
        **dict(kw, n_chunks=3))
    _assert_same_run(grouped, part, 4)


def test_grouped_run_leaves_its_init_tensors_alone():
    """The grouped mode writes its carry in place: a copy, never the
    caller's init or resume tensors."""
    r = lk.fused_minimax_train(CFG, **dict(GROUPED, n_chunks=2))[5]
    init = tuple(r[k] for k in ("q", "v", "pi_a", "pi_b", "n"))
    before = [t.clone() for t in (*init, *r["fields"])]
    lk.fused_minimax_train(CFG, init=init, fields_init=r["fields"],
                           start_chunk=2, chunks_per_dispatch=3,
                           **dict(GROUPED, n_chunks=2))
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 (*init, *r["fields"])))


@pytest.mark.parametrize("packed,multi", [(True, False), (False, False),
                                          (True, True), (False, True)],
                         ids=["K5", "K7", "K6", "K7-multigrid"])
def test_chunk_takes_its_seed_from_a_tensor(packed, multi):
    """An int32 [1] seed tensor gives the by-value call's chunk (a kernel
    reads it when it runs); any other tensor is refused."""
    cfg = MIX if multi else CFG
    pa, pb, v = (torch.tensor(np.concatenate(x)) for x in zip(
        *[_tables(c, 3, False) for c in ([(5, 4), (6, 5)] if multi
                                         else [(5, 4)])]))
    q = torch.zeros((len(v), 5, 5))
    table = (lk.pack_m2(cfg, pa, pb, v, 0.2) if packed
             else lk.pack_m(cfg, pa, pb, q, v, 0.2))
    state = lk.init_state_fields(cfg, 256, "cpu")
    fn = {(True, False): lk.packed_learner_chunk,
          (False, False): lk.learner_chunk,
          (True, True): lk.multigrid_packed_learner_chunk,
          (False, True): lk.multigrid_learner_chunk}[packed, multi]
    args = state if multi else (state,)
    seed = lk._chunk_seed(-3, 11)   # a negative int32 seed's uint32 view
    want = fn(cfg, seed, table, *args, 256, 4)
    held = torch.tensor([-3 * 1_000_003 + 11], dtype=torch.int32)
    got = fn(cfg, held, table, *args, 256, 4)
    for a, b in zip([*want[0], *want[1], *want[2]],
                    [*got[0], *got[1], *got[2]]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int32"):
        fn(cfg, held.long(), table, *args, 256, 4)


def test_mix_eps_takes_a_device_scalar():
    """A grouped run's eps is a float32 scalar tensor: its 1 - eps and
    eps * 0.2 are the host's float32 values, so the packed pi is the same
    bit for bit."""
    pi = torch.tensor(np.concatenate([p for _, p in _eps_pins()])[:5000])
    for eps in (0.3, 0.1879010796546936, 0.15, 1.0, 0.0, 2.0 ** -20):
        e = torch.tensor(np.float32(eps))
        assert torch.equal(lk._mix_eps(pi, e), lk._mix_eps(pi, float(e)))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        lk.fused_minimax_train(CFG, batch=256, n_chunks=1, chunk_len=4,
                               device="cuda")
