"""The port's unpacked minimax-Q layout (kernel K7, both call sites:
``learner_chunk`` and ``multigrid_learner_chunk``), the trainers'
``packed=False`` mode, and the learner chunks' out-of-range count (K5, K6
and K7), on the CPU where the wrappers run their plain versions, against
the JAX package's kernels in interpret mode fed the same seeded numpy
tables and states.

Tolerances:

* fields, stats and visit counts: exact (the same counter PRNG and the
  same bfloat16 pi values in both layouts and both packages);
* TD sums: per cell within cnt * (2**-8 * max|delta| + 1e-6), max|delta|
  <= 1 + 2 * max(|v|, |q|).  The JAX kernel reads v and q as
  double-bfloat16 hi + lo (about 2**-18 relative) and rounds each TD to
  bfloat16 (2**-9 relative) before its float32 scatter-add; the port reads
  v and q exactly and sums exact fixed point;
* at v = q = 0 every summed value is an integer reward: the unpacked TD
  sums equal the packed residual sums exactly;
* the trainers after their first chunk: q and n exact (chunk 0 starts
  from v = q = 0), v and pi within 1e-5.

The K7 kernel is held against these plain versions on the card by
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
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import tables
from gym_soccer_tpu_torch.ops import learner_kernel as lk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG, JCFG = EnvConfig(5, 4, 0.2), JaxConfig(5, 4, 0.2)
NS = 761
MIX = ((5, 4, 0.2), (6, 5, 0.1))
jax_pack = jax.jit(jlk.pack_m, static_argnums=(0,))
jax_pack2 = jax.jit(jlk.pack_m2, static_argnums=(0,))


def _cfg(boards):
    """(JAX config, port config): one board, or a mixture's tuples."""
    if len(boards) == 1:
        return JaxConfig(*boards[0]), EnvConfig(*boards[0])
    return (tuple(JaxConfig(*b) for b in boards),
            tuple(EnvConfig(*b) for b in boards))


def _tables(nS, seed, zero=False):
    """(pi_a, pi_b, v, q) as numpy: random policies, v and q in [-1, 1]
    (or 0)."""
    rng = np.random.default_rng(seed)
    pa, pb = (rng.dirichlet(np.ones(5), nS).astype(np.float32)
              for _ in range(2))
    v = rng.uniform(-1, 1, nS).astype(np.float32)
    q = rng.uniform(-1, 1, (nS, 5, 5)).astype(np.float32)
    if zero:
        v, q = np.zeros_like(v), np.zeros_like(q)
    return pa, pb, v, q


def _ints(stats):
    return [int(x) for x in stats]


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


def _port_chunk(cfg, packed, seed, table, B, T):
    """The port's chunk on its own initial state, one board or a mixture."""
    if isinstance(cfg, tuple):
        planes, fields = lk.init_state_fields(cfg, B, "cpu")
        fn = (lk.multigrid_packed_learner_chunk if packed
              else lk.multigrid_learner_chunk)
        return fn(cfg, seed, table, planes, fields, B, T)
    fn = lk.packed_learner_chunk if packed else lk.learner_chunk
    return fn(cfg, seed, table, lk.init_state_fields(cfg, B, "cpu"), B, T)


# ----------------------------------------------------------------------
# The unpacked table
# ----------------------------------------------------------------------

def _eps_pins(eps):
    """pi values whose mixed, bfloat16-rounded value depends on how
    pi * (1 - eps) + eps / 5 is rounded: eps in float32 or float64, eps / 5
    as a division or as eps * 0.2, an FMA or two roundings."""
    pis = np.random.default_rng(0).uniform(0, 0.06, 2_000_000)
    pis = pis.astype(np.float32)
    e = np.float32(eps)
    variants = [(np.float32(1 - eps), np.float32(eps / 5), False),
                (np.float32(1 - e), np.float32(e / np.float32(5)), True),
                (np.float32(1 - e), np.float32(e * np.float32(0.2)), True),
                (np.float32(1 - e), np.float32(e * np.float32(0.2)), False)]
    outs = []
    for e1, e2, fused in variants:
        x = ((pis.astype(np.float64) * e1 + e2).astype(np.float32) if fused
             else pis * e1 + e2)
        outs.append(torch.tensor(x).to(torch.bfloat16).float().numpy())
    differ = np.zeros(len(pis), bool)
    for o in outs[1:]:
        differ |= o != outs[0]
    return pis[differ]


@pytest.mark.parametrize("eps", [0.3, 0.1879010796546936])
def test_pack_m_equals_jax(eps):
    """The unpacked table's pi columns equal JAX's pack_m bit for bit for a
    Python-float and a float32 eps (the trainer's two call sites); v and q
    are exact in the port, hi + lo within 2**-17 in JAX, and the table
    read back from JAX's M through interop has the same pi."""
    pins = _eps_pins(eps)
    assert len(pins) >= 10
    _, pb, v, q = _tables(NS, 9)
    pa = np.full((NS, 5), 0.2, np.float32)
    k = min(len(pins), NS * 5)
    pa.flat[:k] = pins[:k]
    table = lk.pack_m(CFG, *(torch.tensor(x) for x in (pa, pb, q, v)), eps)
    assert table.shape == (lk.n_codes(CFG), lk.TABLE_COLS_UNPACKED)
    codes = lk._cell_rows(CFG)
    assert np.array_equal(table[codes, lk.COL_V].numpy(), v)
    assert np.array_equal(table[codes, lk.COL_Q:].numpy(), q.reshape(-1, 25))
    for e in (eps, jnp.float32(eps)):
        m = np.asarray(jax_pack(JCFG, *(jnp.asarray(x) for x in
                                        (pa, pb, q, v)), e), np.float32)
        back = interop.table_from_m(CFG, m, "cpu")
        assert torch.equal(back[:, :10], table[:, :10])
        assert (back[:, 10:] - table[:, 10:]).abs().max() <= 2.0 ** -17
        # the packed table carries the same pi
        packed = lk.pack_m2(CFG, torch.tensor(pa), torch.tensor(pb),
                            torch.tensor(v), eps)
        assert torch.equal(packed[:, :10], table[:, :10])
    empty = np.setdiff1d(np.arange(lk.n_codes(CFG)), codes)
    assert len(empty) and not table[empty].any()


# ----------------------------------------------------------------------
# K7: learner_chunk and multigrid_learner_chunk
# ----------------------------------------------------------------------

@pytest.mark.parametrize("boards,B,T,seed", [
    (((5, 4, 0.2),), 1024, 12, 3),
    (((11, 7, 0.2),), 256, 4, 5),
    (MIX, 256, 4, 6),
], ids=["5x4", "11x7", "5x4+6x5"])
def test_unpacked_chunk_plain_equals_jax(boards, B, T, seed):
    jc, pc = _cfg(boards)
    pa, pb, v, q = _tables(lk.n_states(pc), seed)
    m = jax_pack(jc, *(jnp.asarray(x) for x in (pa, pb, q, v)), 0.2)
    if isinstance(pc, tuple):
        jplanes, jfields0 = jlk.init_state_fields(jc, B)
        jfields, jacc, jstats = jlk.multigrid_learner_chunk(
            jc, seed, m, jplanes, jfields0, B, T, interpret=True)
    else:
        jfields, jacc, jstats = jlk.learner_chunk(
            jc, seed, m, jlk.init_state_fields(jc, B), B, T, interpret=True)
    jtd, jcnt = (np.asarray(a) for a in jlk.unpack_acc(jc, jacc))

    table = interop.table_from_m(pc, np.asarray(m, np.float32), "cpu")
    fields, acc, stats = _port_chunk(pc, False, seed, table, B, T)
    td, cnt = (a.numpy() for a in lk.unpack_acc(pc, acc))
    _assert_planes_equal(fields, jfields)
    assert _ints(stats[:3]) == _ints(jstats) and int(stats[3]) == 0
    assert np.array_equal(cnt, jcnt) and int(cnt.sum()) == B * T
    max_delta = 1 + 2 * float(table[:, lk.COL_V:].abs().max())
    tol = cnt * (2.0 ** -8 * max_delta + 1e-6)
    assert (np.abs(td - jtd) <= tol).all(), np.abs(td - jtd).max()
    assert np.abs(td - jtd).max() > 0   # the bf16 rounding is there


@pytest.mark.parametrize("boards", [((5, 4, 0.2),), MIX],
                         ids=["5x4", "5x4+6x5"])
def test_unpacked_and_packed_chunks_agree(boards):
    """For the same pi, K7 steps the fields, stats and counts of K5 (or
    K6); at v = q = 0 its TD sums equal their residual sums exactly."""
    _, pc = _cfg(boards)
    B, T = 512, 8
    for zero in (False, True):
        pa, pb, v, q = (torch.tensor(x) for x in
                        _tables(lk.n_states(pc), 4, zero=zero))
        f2, (s2, c2), st2 = _port_chunk(pc, True, 8,
                                        lk.pack_m2(pc, pa, pb, v, 0.2), B, T)
        f1, (s1, c1), st1 = _port_chunk(pc, False, 8,
                                        lk.pack_m(pc, pa, pb, q, v, 0.2), B, T)
        assert all(torch.equal(a, b) for a, b in zip(f1, f2))
        assert torch.equal(c1, c2) and _ints(st1) == _ints(st2)
        assert torch.equal(s1, s2) == zero


# ----------------------------------------------------------------------
# The trainers with packed=False
# ----------------------------------------------------------------------

TRAIN = dict(batch=256, chunk_len=4, lr=0.5, eps=0.3, solver_iters=50,
             seed=7)


@pytest.mark.parametrize("boards", [((5, 4, 0.2),), MIX],
                         ids=["5x4", "5x4+6x5"])
def test_unpacked_trainer_first_chunk_equals_jax(boards):
    jc, pc = _cfg(boards)
    jq, jv, jpa, jpb, jhist, jres = jlk.fused_minimax_train(
        jc, n_chunks=1, return_state=True, interpret=True, packed=False,
        **TRAIN)
    q, v, pa, pb, hist, res = lk.fused_minimax_train(
        pc, n_chunks=1, return_state=True, device="cpu", packed=False,
        **TRAIN)
    assert hist == jhist
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(res["n"].numpy(), np.asarray(jres["n"]))
    for a, b in ((v, jv), (pa, jpa), (pb, jpb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    _assert_planes_equal(res["fields"], jres["fields"])
    assert res["packed"] is False and bool(jres["packed"]) is False


@pytest.mark.parametrize("boards", [((5, 4, 0.2),), MIX],
                         ids=["5x4", "5x4+6x5"])
def test_unpacked_trainer_exact_resume(boards):
    """2 + 2 chunks through the resume dict equal 4, bit for bit, with
    annealed lr and eps."""
    _, pc = _cfg(boards)
    kw = dict(batch=256, chunk_len=4, lr=0.5, eps=0.4, eps_halflife=32,
              lr_anneal_start=1, lr_anneal_tau=4.0, solver_iters=30, seed=7,
              packed=False, device="cpu")
    whole = lk.fused_minimax_train(pc, n_chunks=4, return_state=True, **kw)
    r = lk.fused_minimax_train(pc, n_chunks=2, return_state=True, **kw)[5]
    part = lk.fused_minimax_train(
        pc, n_chunks=2, return_state=True,
        init=tuple(r[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
        fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
    for a, b in zip(whole[:4], part[:4]):
        assert torch.equal(a, b)
    for a, b in zip(whole[5]["fields"], part[5]["fields"]):
        assert torch.equal(a, b)
    assert torch.equal(whole[5]["n"], part[5]["n"])
    assert part[5]["packed"] is False


def test_unpacked_best_response_equals_jax_and_resumes():
    """fused_best_response_train with packed=False: its first chunk equals
    JAX's (q exact), and 1 + 2 chunks equal 3 bit for bit."""
    opp = np.asarray(get_random_policy_array(NS, 5, seed=3))
    kw = dict(batch=256, chunk_len=4, lr=0.8, eps=0.4, eps_halflife=64,
              eps_min=0.1, lr_anneal_start=1, lr_anneal_tau=4.0, gamma=0.9,
              seed=13, packed=False)
    jq, jv, *_ = jlk.fused_best_response_train(JCFG, opp, "player_b",
                                               n_chunks=1, interpret=True,
                                               **kw)
    q, v, *_ = lk.fused_best_response_train(CFG, opp, "player_b", n_chunks=1,
                                            device="cpu", **kw)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    whole = lk.fused_best_response_train(CFG, opp, "player_b", n_chunks=3,
                                         return_state=True, device="cpu",
                                         **kw)
    r = lk.fused_best_response_train(CFG, opp, "player_b", n_chunks=1,
                                     return_state=True, device="cpu", **kw)[5]
    assert r["packed"] is False
    part = lk.fused_best_response_train(
        CFG, opp, "player_b", n_chunks=2, return_state=True,
        init=(r["q"], r["n"]), fields_init=r["fields"],
        start_chunk=r["next_chunk"], device="cpu", **kw)
    for a, b in zip(whole[:4], part[:4]):
        assert torch.equal(a, b)
    for a, b in zip(whole[5]["fields"], part[5]["fields"]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# The out-of-range count of K5, K6 and K7
# ----------------------------------------------------------------------

def test_range_count_catches_the_k5_wrap():
    """v = +1e9 on the ISD states and -1e9 elsewhere: the first step's
    residuals are near -2e9, i.e. -8.6e18 units of 2**-32, so two visits
    to one cell pass -2**63 and the int64 sum wraps by 2**64 units (2**32
    in value), where JAX's float32 sums stay right.  The chunk reports the
    values it read out of range, and the trainer refuses the run."""
    B, T = 256, 4
    ss = tables.build_statespace(CFG)
    v = np.full(NS, -1e9, np.float32)
    v[ss.raw_to_dense[ss.isd_raw]] = 1e9
    pi = np.full((NS, 5), 0.2, np.float32)
    m = jax_pack2(JCFG, jnp.asarray(pi), jnp.asarray(pi), jnp.asarray(v), 0.2)
    jfields0 = jlk.init_state_fields(JCFG, B)
    _, jacc, _ = jlk.packed_learner_chunk(JCFG, 1, m, jfields0, B, T,
                                          interpret=True)
    jres, jcnt = (np.asarray(a) for a in jlk.unpack_acc2(JCFG, jacc))
    table = lk.pack_m2(CFG, torch.tensor(pi), torch.tensor(pi),
                       torch.tensor(v), 0.2)
    _, acc, stats = lk.packed_learner_chunk(
        CFG, 1, table, interop.planes_from_tiles(jfields0, "cpu"), B, T)
    res, cnt = (a.numpy() for a in lk.unpack_acc2(CFG, acc))
    assert np.array_equal(cnt, jcnt)
    err = np.abs(res.astype(np.float64) - jres)
    wrapped = err > 2.0 ** 31
    assert wrapped.any() and (cnt[wrapped] >= 2).all()
    # each wrap is a whole 2**64 units, 2**32 in value, off JAX's sum
    wraps = err[wrapped] / 2.0 ** 32
    assert (np.abs(wraps - np.round(wraps)) < 0.01).all()
    assert (err[cnt == 1] <= 2.0 ** -8 * 2.1e9).all()   # one visit is right
    assert int(stats[3]) == B * (T + 1)   # every v read is out of range
    with pytest.raises(ValueError, match="fixed-point sums could overflow"):
        lk.fused_minimax_train(
            CFG, batch=B, n_chunks=2, chunk_len=T, device="cpu",
            init=(np.zeros((NS, 5, 5), np.float32), v, pi, pi))


@pytest.mark.parametrize("boards", [((5, 4, 0.2),), MIX],
                         ids=["5x4", "5x4+6x5"])
def test_range_count_counts_the_values_read(boards):
    """K5/K6 count each v read (one per step and the final state's); K7
    also each q(s, a); nan counts, and |v| <= value_limit does not."""
    _, pc = _cfg(boards)
    B, T = 256, 4
    nS = lk.n_states(pc)
    pa, pb, v, q = (torch.tensor(x) for x in _tables(nS, 2))
    limit = lk.value_limit(B, T)
    assert limit == 2.0 ** 29 / (B * T)
    for v_bad, q_bad, want2, want in (
            (v * limit, q, 0, 0),
            (v * float("nan"), q, B * (T + 1), B * (T + 1)),
            (v, q + 1e7, 0, B * T),
            (v + 2 * limit, q - 2 * limit, B * (T + 1), B * (2 * T + 1))):
        m2 = lk.pack_m2(pc, pa, pb, v_bad, 0.2)
        m = lk.pack_m(pc, pa, pb, q_bad, v_bad, 0.2)
        assert int(_port_chunk(pc, True, 3, m2, B, T)[2][3]) == want2
        assert int(_port_chunk(pc, False, 3, m, B, T)[2][3]) == want


def test_trainers_refuse_runs_out_of_range():
    _, pc = _cfg(MIX)
    nS = lk.n_states(pc)
    pi = np.full((nS, 5), 0.2, np.float32)
    big = np.full(nS, 3e6, np.float32)
    kw = dict(batch=256, n_chunks=1, chunk_len=4, device="cpu")
    for cfg, n in ((pc, nS), (CFG, NS)):
        for packed in (True, False):
            init = (np.zeros((n, 5, 5), np.float32), big[:n], pi[:n], pi[:n])
            with pytest.raises(ValueError, match="could overflow"):
                lk.fused_minimax_train(cfg, init=init, packed=packed, **kw)
    q = np.full((NS, 5, 5), 3e6, np.float32)
    with pytest.raises(ValueError, match="could overflow"):
        lk.fused_best_response_train(CFG, np.zeros(NS, int), "player_a",
                                     init=(q,), packed=False, **kw)


def test_chunks_check_their_arguments():
    B = 256
    fields = lk.init_state_fields(CFG, B, "cpu")
    table = torch.zeros((lk.n_codes(CFG), lk.TABLE_COLS_UNPACKED))
    with pytest.raises(ValueError, match="table"):   # an 11-column table
        lk.learner_chunk(CFG, 0, table[:, :11].contiguous(), fields, B, 4)
    with pytest.raises(ValueError, match="gamma"):
        lk.learner_chunk(CFG, 0, table, fields, B, 4, gamma=1.5)
    _, pc = _cfg(MIX)
    planes, mfields = lk.init_state_fields(pc, B, "cpu")
    mtable = torch.zeros((lk.n_codes(pc), lk.TABLE_COLS_UNPACKED))
    with pytest.raises(ValueError, match="multigrid_learner_chunk"):
        lk.learner_chunk(pc, 0, mtable, mfields, B, 4)
    with pytest.raises(ValueError, match="planes"):
        lk.multigrid_learner_chunk(pc, 0, mtable, planes[:5], mfields, B, 4)
    with pytest.raises(ValueError, match="max_steps"):
        lk.multigrid_learner_chunk(
            (pc[0], EnvConfig(6, 5, 0.1, max_steps=9)), 0, mtable, planes,
            mfields, B, 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lk.multigrid_learner_chunk(pc, 0, mtable.to("meta"),
                                   [p.to("meta") for p in planes],
                                   [f.to("meta") for f in mfields], B, 4)
    with pytest.raises(ValueError, match="one EnvConfig"):
        lk.fused_best_response_train(pc, np.zeros(10, int), "player_a",
                                     batch=B, n_chunks=1, device="cpu")
