"""The port's independent-Q learner (gym_soccer_tpu_torch.ops.iql_kernel)
on the CPU, where the chunk wrappers run their plain versions, against the
JAX package's ``iql_packed_chunk``/``iql_chunk(interpret=True)`` and
``fused_iql_train(interpret=True)`` fed the same Q tables and states.

Tolerances:

* final fields, stats and visit counts: exact.  Both packages act on the
  same double-bfloat16 Q values with the same counter PRNG.
* residual (K8) and TD (K9) sums: per cell within
  cnt * (2**-8 * max|delta| + 1e-6), where max|delta| <= 1 + (1 + gamma) *
  max|q|.  The JAX kernels round each value to bfloat16 before their
  float32 scatter-add (iql_kernel.py:120-126, :272-281); the port sums
  exact fixed point.  With Q = 0 the values are the integer rewards and
  the sums are equal.
* the trainer after its first chunk from Q = 0: q exact (the sums are
  integers in both packages, and the update is the same float32
  arithmetic).  From a warm start, or after a later chunk: q within
  lr * (2**-8 * max|delta| + 1e-6), the sums' tolerance over cnt.

The K8/K9 kernels are held against the plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import iql_kernel as jik
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import iql_kernel as ik

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG, JCFG = EnvConfig(5, 4, 0.2), JaxConfig(5, 4, 0.2)
NS = 761
EPS = int(round(0.3 * 65536))


def _q(board, seed, kind):
    """(q_a, q_b) float32 numpy [nS, 5]: zeros, or uniform in [-1, 1]."""
    nS = len(ik.lk._cell_rows(EnvConfig(*board, 0.2)))
    if kind == "zero":
        z = np.zeros((nS, 5), np.float32)
        return z, z
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (nS, 5)).astype(np.float32),
            rng.uniform(-1, 1, (nS, 5)).astype(np.float32))


def _jax_chunk(jcfg, packed, seed, eps_int, qa, qb, jfields, B, T, off):
    pack, chunk, unpack = ((jik.pack_iql_m2, jik.iql_packed_chunk,
                            jik.unpack_iql_acc2) if packed else
                           (jik.pack_iql_m, jik.iql_chunk, jik.unpack_iql_acc))
    m = pack(jcfg, jnp.asarray(qa), jnp.asarray(qb))
    f, acc, st = chunk(jcfg, seed, eps_int, m, jfields, B, T,
                       step_offset=off, interpret=True)
    return (f, [np.asarray(a) for a in unpack(jcfg, acc)],
            [int(x) for x in st], np.asarray(m, np.float32))


def _port_chunk(cfg, packed, seed, eps_int, table, fields, B, T, off):
    chunk, unpack = ((ik.iql_packed_chunk, ik.unpack_iql_acc2) if packed
                     else (ik.iql_chunk, ik.unpack_iql_acc))
    f, acc, st = chunk(cfg, seed, eps_int, table, fields, B, T, 0.99, off)
    assert len(st) == 4 and int(st[3]) == 0   # every value in range
    return (f, [a.numpy() for a in unpack(cfg, acc)],
            [int(x) for x in st[:3]], acc)


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("packed", [True, False], ids=["K8", "K9"])
@pytest.mark.parametrize("board,B,T,seed,kind,off", [
    ((5, 4), 256, 4, 0, "zero", 0),     # the trainer's first chunk
    ((5, 4), 1024, 16, 3, "random", 0),
    ((5, 4), 256, 4, 4, "random", 37),  # a later chunk's step numbering
    ((11, 7), 256, 4, 5, "random", 8),
], ids=["zero", "random", "offset", "11x7"])
def test_chunk_plain_equals_jax(packed, board, B, T, seed, kind, off):
    jcfg, cfg = JaxConfig(*board, 0.2), EnvConfig(*board, 0.2)
    qa, qb = _q(board, seed, kind)
    jfields0 = jik.init_iql_state_fields(jcfg, B)
    jf, jacc, jst, m = _jax_chunk(jcfg, packed, seed, EPS, qa, qb, jfields0,
                                  B, T, off)
    table = interop.iql_table_from_packed_m(cfg, m, packed, "cpu")
    f, acc, st, raw = _port_chunk(cfg, packed, seed, EPS, table,
                                  interop.planes_from_tiles(jfields0, "cpu"),
                                  B, T, off)
    _assert_planes_equal(f, jf)
    assert st == jst
    assert raw[0].dtype == torch.int64 and raw[1].dtype == torch.int32
    for c, jc in ((acc[1], jacc[1]), (acc[3], jacc[3])):
        assert np.array_equal(c, jc) and int(c.sum()) == B * T
    for s, js, c in ((acc[0], jacc[0], acc[1]), (acc[2], jacc[2], acc[3])):
        if kind == "zero":
            assert np.array_equal(s, js)
        else:
            max_delta = 1 + 1.99 * float(table.abs().max())
            tol = c * (2.0 ** -8 * max_delta + 1e-6)
            assert (np.abs(s - js) <= tol).all(), np.abs(s - js).max()
            assert np.abs(s - js).max() > 0   # the bf16 rounding is there


def test_pack_equals_jax_m_and_is_double_bf16():
    """The port's table equals the tables read back from both JAX M
    layouts bit for bit, and differs from the exact q on most entries."""
    qa, qb = _q((5, 4), 9, "random")
    table = ik.pack_iql_table(CFG, torch.tensor(qa), torch.tensor(qb))
    for packed, pack in ((True, jik.pack_iql_m2), (False, jik.pack_iql_m)):
        m = np.asarray(pack(JCFG, jnp.asarray(qa), jnp.asarray(qb)),
                       np.float32)
        back = interop.iql_table_from_packed_m(CFG, m, packed, "cpu")
        assert torch.equal(back, table)
    codes = ik.lk._cell_rows(CFG)
    got = table[codes].numpy()
    exact = np.concatenate([qa, qb], 1)
    assert (got != exact).mean() > 0.9
    assert np.abs(got - exact).max() <= 2.0 ** -17
    empty = np.setdiff1d(np.arange(ik.n_codes(CFG)), codes)
    assert len(empty) and not table[empty].any()


def _near_ties():
    """Per state, A's Q = [y, x, -1, -1, -1] with x > y in float32 but
    double_bf16(x) == double_bf16(y): the exact greedy action is 1, the
    double-bf16 one is 0 (the lowest index wins the tie)."""
    rng = np.random.default_rng(11)
    y = ik.double_bf16(torch.tensor(rng.uniform(0.1, 0.9, 4 * NS),
                                    dtype=torch.float32))
    x = torch.nextafter(y, torch.tensor(2.0))
    tie = ik.double_bf16(x) == y
    y, x = y[tie][:NS], x[tie][:NS]
    assert len(y) == NS and bool((x > y).all())
    qa = torch.full((NS, 5), -1.0)
    qa[:, 0], qa[:, 1] = y, x
    return qa.numpy(), np.zeros((NS, 5), np.float32)


def test_double_bf16_pin_changes_greedy_actions():
    """On near-ties the port plays what JAX plays, and a table of the
    exact q would not."""
    qa, qb = _near_ties()
    B, T = 256, 4
    jfields0 = jik.init_iql_state_fields(JCFG, B)
    jf, jacc, jst, _ = _jax_chunk(JCFG, True, 2, 0, qa, qb, jfields0, B, T, 0)
    fields0 = interop.planes_from_tiles(jfields0, "cpu")
    table = ik.pack_iql_table(CFG, torch.tensor(qa), torch.tensor(qb))
    f, acc, st, _ = _port_chunk(CFG, True, 2, 0, table, fields0, B, T, 0)
    _assert_planes_equal(f, jf)
    assert st == jst and np.array_equal(acc[1], jacc[1])
    assert acc[1][:, 0].sum() == B * T   # eps 0: A always plays action 0
    exact = ik.pack_iql_table(CFG, torch.tensor(qa), torch.tensor(qb))
    exact[ik.lk._codes(CFG, torch.device("cpu")), :5] = torch.tensor(qa)
    _, acc_x, _, _ = _port_chunk(CFG, True, 2, 0, exact, fields0, B, T, 0)
    assert acc_x[1][:, 1].sum() == B * T   # the exact q plays action 1


@pytest.mark.parametrize("eps_int", [0, ik.EPS_ONE], ids=["greedy", "explore"])
def test_eps_edges_equal_jax(eps_int):
    """eps 0 with Q = 0: both players play action 0 forever, no goal.  eps
    1 (65536): both players explore every step, independently."""
    qa, qb = _q((5, 4), 0, "zero")
    B, T = 256, 4
    jfields0 = jik.init_iql_state_fields(JCFG, B)
    jf, jacc, jst, m = _jax_chunk(JCFG, False, 3, eps_int, qa, qb, jfields0,
                                  B, T, 0)
    f, acc, st, _ = _port_chunk(
        CFG, False, 3, eps_int,
        interop.iql_table_from_packed_m(CFG, m, False, "cpu"),
        interop.planes_from_tiles(jfields0, "cpu"), B, T, 0)
    _assert_planes_equal(f, jf)
    assert st == jst
    for k in range(4):
        assert np.array_equal(acc[k], jacc[k])
    cnt_a, cnt_b = acc[1], acc[3]
    if eps_int == 0:
        assert st[1] == 0
        assert cnt_a[:, 0].sum() == B * T and not cnt_a[:, 1:].any()
        assert cnt_b[:, 0].sum() == B * T and not cnt_b[:, 1:].any()
    else:
        for cnt in (cnt_a, cnt_b):
            assert cnt.sum(0).min() > 0.15 * B * T / 5


def test_packed_and_unpacked_step_the_same():
    """K8 and K9 paths step identical fields, stats and counts for the same
    table; with Q = 0 the residual is the TD, bit for bit."""
    B, T = 1024, 16
    fields0 = ik.init_iql_state_fields(CFG, B, "cpu")
    for kind in ("random", "zero"):
        table = ik.pack_iql_table(CFG, *map(torch.tensor, _q((5, 4), 2, kind)))
        f1, a1, s1, r1 = _port_chunk(CFG, True, 9, EPS, table, fields0, B, T, 0)
        f2, a2, s2, r2 = _port_chunk(CFG, False, 9, EPS, table, fields0, B, T,
                                     0)
        assert all(torch.equal(a, b) for a, b in zip(f1, f2)) and s1 == s2
        assert torch.equal(r1[1], r2[1])
        assert torch.equal(r1[0], r2[0]) == (kind == "zero")


def test_layout_helpers_equal_jax():
    for board in ((5, 4), (11, 7)):
        jcfg, cfg = JaxConfig(*board, 0.2), EnvConfig(*board, 0.2)
        _assert_planes_equal(ik.init_iql_state_fields(cfg, 512, "cpu"),
                             jik.init_iql_state_fields(jcfg, 512))


def test_dual_accounting_with_zero_q():
    """With Q = 0 every TD is r for A and -r for B: A's sums total
    +reward_sum and B's -reward_sum, exactly."""
    B, T = 1024, 16
    table = ik.pack_iql_table(CFG, *map(torch.tensor, _q((5, 4), 0, "zero")))
    _, acc, st, _ = _port_chunk(CFG, False, 4, EPS, table,
                                ik.init_iql_state_fields(CFG, B, "cpu"),
                                B, T, 0)
    assert st[1] > 0
    assert acc[0].sum() == st[0] and acc[2].sum() == -st[0]


TRAIN = dict(batch=256, chunk_len=4, lr=0.5, eps=0.3, seed=7)


def _jax_resume(res):
    return {k: [np.asarray(f) for f in x] if k == "fields" else np.asarray(x)
            for k, x in res.items()}


@pytest.mark.parametrize("packed", [True, False], ids=["K8", "K9"])
def test_first_chunk_equals_jax(packed):
    """From Q = 0 the first chunk's q is bit-equal to the JAX trainer's;
    from a random warm start it is within the sums' tolerance."""
    jqa, jqb, jhist, jres = jik.fused_iql_train(
        JCFG, n_chunks=1, return_state=True, interpret=True, packed=packed,
        **TRAIN)
    qa, qb, hist, res = ik.fused_iql_train(
        CFG, n_chunks=1, return_state=True, packed=packed, device="cpu",
        **TRAIN)
    assert hist == jhist
    assert np.array_equal(qa.numpy(), np.asarray(jqa))
    assert np.array_equal(qb.numpy(), np.asarray(jqb))
    _assert_planes_equal(res["fields"], jres["fields"])
    assert res["next_chunk"] == 1 and res["packed"] is packed

    init = tuple(0.5 * q for q in _q((5, 4), 6, "random"))
    jqa, jqb, jhist = jik.fused_iql_train(
        JCFG, n_chunks=1, interpret=True, packed=packed, init=init, **TRAIN)
    qa, qb, hist = ik.fused_iql_train(CFG, n_chunks=1, packed=packed,
                                      init=init, device="cpu", **TRAIN)
    assert hist == jhist
    tol = TRAIN["lr"] * (2.0 ** -8 * (1 + 1.99 * 0.5) + 1e-6)
    for q, jq in ((qa, jqa), (qb, jqb)):
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=tol)
        assert not np.array_equal(q.numpy(), np.asarray(jq))


def test_resume_from_jax_state_follows_jax():
    """A 2-chunk JAX run's resume dict, through interop, continues in the
    port with annealed eps and lr: the same trajectories and stats as the
    3-chunk JAX run's last chunk, q within lr * (2**-8 * max|delta| +
    1e-6)."""
    kw = dict(TRAIN, eps_halflife=8, lr_anneal_start=1, lr_anneal_tau=2.0)
    jqa3, jqb3, jhist, jres3 = jik.fused_iql_train(
        JCFG, n_chunks=3, return_state=True, interpret=True, **kw)
    jres2 = jik.fused_iql_train(JCFG, n_chunks=2, return_state=True,
                                interpret=True, **kw)[3]
    r = interop.resume_from_numpy(_jax_resume(jres2), "cpu")
    assert set(r) == {"q_a", "q_b", "fields", "next_chunk", "packed"}
    assert r["next_chunk"] == 2 and r["packed"] is True
    assert all(r[k].dtype == torch.float32 for k in ("q_a", "q_b"))
    qa, qb, hist, res = ik.fused_iql_train(
        CFG, n_chunks=1, return_state=True, init=(r["q_a"], r["q_b"]),
        fields_init=r["fields"], start_chunk=r["next_chunk"], device="cpu",
        **kw)
    assert hist == jhist[-1:] and res["next_chunk"] == 3
    _assert_planes_equal(res["fields"], jres3["fields"])
    q_max = float(max(r["q_a"].abs().max(), r["q_b"].abs().max()))
    tol = TRAIN["lr"] * (2.0 ** -8 * (1 + 1.99 * q_max) + 1e-6)
    for q, jq in ((qa, jqa3), (qb, jqb3)):
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=tol)


@pytest.mark.parametrize("packed", [True, False], ids=["K8", "K9"])
def test_trainer_exact_resume(packed):
    """3 + 3 chunks through the resume dict equal 6, bit for bit, with
    annealed lr and eps."""
    kw = dict(batch=256, chunk_len=4, lr=0.4, eps=0.4, eps_halflife=24,
              lr_anneal_start=2, lr_anneal_tau=4.0, seed=13, packed=packed,
              device="cpu")
    qa, qb, hist, res = ik.fused_iql_train(CFG, n_chunks=6, return_state=True,
                                           **kw)
    r = ik.fused_iql_train(CFG, n_chunks=3, return_state=True, **kw)[3]
    qa2, qb2, hist2, res2 = ik.fused_iql_train(
        CFG, n_chunks=3, return_state=True, init=(r["q_a"], r["q_b"]),
        fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
    for a, b in ((qa, qa2), (qb, qb2), *zip(res["fields"], res2["fields"])):
        assert torch.equal(a, b)
    assert res2["next_chunk"] == 6 and hist2 == hist[-1:]


@pytest.mark.parametrize("packed", [True, False], ids=["K8", "K9"])
def test_warm_start_lr_zero_keeps_q(packed):
    q0a, q0b = (torch.tensor(0.5 * q) for q in _q((5, 4), 1, "random"))
    qa, qb, _ = ik.fused_iql_train(CFG, batch=256, n_chunks=2, chunk_len=4,
                                   lr=0.0, eps=0.5, init=(q0a, q0b),
                                   packed=packed, device="cpu")
    assert torch.equal(qa, q0a) and torch.equal(qb, q0b)


def test_fused_iql_training_learns():
    """The JAX package's test_fused_iql_training_learns, at its recipe."""
    q_a, q_b, hist = ik.fused_iql_train(
        CFG, batch=1024, n_chunks=30, chunk_len=16, lr=0.4, eps=0.3,
        device="cpu")
    q_a, q_b = q_a.numpy(), q_b.numpy()
    assert np.abs(q_a).max() > 0.05 and np.abs(q_b).max() > 0.05
    assert np.abs(q_a).max() <= 1.05 and np.abs(q_b).max() <= 1.05
    assert sum(h[1] for h in hist) > 0
    va, vb = q_a.max(-1), q_b.max(-1)
    mask = (np.abs(va) > 0.2) & (np.abs(vb) > 0.2)
    if mask.sum() > 20:
        assert np.corrcoef(va[mask], vb[mask])[0, 1] < 0.5


def test_chunk_checks_its_arguments():
    table = torch.zeros((ik.n_codes(CFG), ik.IQL_COLS))
    fields = ik.init_iql_state_fields(CFG, 256, "cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        ik.iql_packed_chunk(CFG, 0, EPS, table, fields, 200, 4)
    with pytest.raises(ValueError, match="2\\*\\*29"):
        ik.iql_chunk(CFG, 0, EPS, table, fields, 2 ** 22, 2 ** 8)
    with pytest.raises(ValueError, match="table"):
        ik.iql_packed_chunk(CFG, 0, EPS, table[:, :9].contiguous(), fields,
                            256, 4)
    with pytest.raises(ValueError, match="int32"):
        ik.iql_chunk(CFG, 0, EPS, table, [f.long() for f in fields], 256, 4)
    with pytest.raises(ValueError, match="eps_int"):
        ik.iql_packed_chunk(CFG, 0, 65537, table, fields, 256, 4)
    with pytest.raises(ValueError, match="steps"):
        ik.iql_chunk(CFG, 0, EPS, table, fields, 256, 4, 0.99, 2 ** 31 - 2)
    with pytest.raises(ValueError, match="on meta"):   # one device for all
        ik.iql_chunk(CFG, 0, EPS, table.to("meta"), fields, 256, 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ik.iql_packed_chunk(CFG, 0, EPS, table.to("meta"),
                            [f.to("meta") for f in fields], 256, 4)


@pytest.mark.parametrize("fn", [ik.iql_packed_chunk, ik.iql_chunk,
                                ik.iql_packed_chunk_plain, ik.iql_chunk_plain],
                         ids=["K8", "K9", "K8-plain", "K9-plain"])
def test_chunk_counts_values_out_of_range(fn):
    """The fourth stat counts the values outside +-2**30 / (batch *
    n_steps) or not finite, which could overflow the int64 sums; the
    limit is 2 at the 2**29 cap."""
    B, T = 256, 16
    assert ik.value_limit(2 ** 22, 2 ** 7) == 2.0
    assert ik.value_limit(B, T) == 2.0 ** 18
    fields = ik.init_iql_state_fields(CFG, B, "cpu")
    z = torch.zeros((NS, 5))
    for q, want in ((z, 0), (z + 2.0 ** 17, 0), (z + 1e7, None),
                    (z + float("nan"), 2 * B * T)):
        table = ik.pack_iql_table(CFG, q, q)
        _, goals, truncs, out = (int(x) for x in
                                 fn(CFG, 0, EPS, table, fields, B, T)[2])
        if want is None:   # only a terminal step's values, +-r - 1e7
            assert goals > 0 and out == 2 * (goals + truncs)
        else:
            assert out == want


def test_trainer_refuses_a_run_out_of_range():
    """The trainer reads the chunks' out-of-range counts once, at the end,
    and refuses a run whose sums could have overflowed."""
    big = np.full((NS, 5), 1e9, np.float32)
    for packed in (True, False):
        with pytest.raises(ValueError, match="overflow"):
            ik.fused_iql_train(CFG, batch=256, n_chunks=2, chunk_len=4,
                               init=(big, big), packed=packed, device="cpu")


def _refuse_meshes(monkeypatch):
    """Make ``dispatch.run``'s capture check refuse every mesh it is
    handed, as it refuses a gloo mesh on the card (which the CPU cannot
    build)."""
    from gym_soccer_tpu_torch.ops import dispatch

    def refuse(mesh):
        if mesh is not None:
            raise ValueError("a gloo mesh's collectives cannot be captured")
    monkeypatch.setattr(dispatch, "check_capture", refuse)


def test_unported_modes_raise(monkeypatch):
    """No mode is left unported: a mesh of one rank (parallel/mesh) equals
    no mesh bit for bit, per chunk and grouped; the grouped mode hands its
    mesh to ``dispatch.run``'s capture check, which refuses a gloo mesh on
    the card; the grouped mode runs (below), and a
    group size that is no positive integer is refused."""
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    one = pmesh.env_mesh(device="cpu")
    kw = dict(batch=256, n_chunks=1, chunk_len=4, device="cpu")
    for extra in (dict(), dict(chunks_per_dispatch=4)):
        want = ik.fused_iql_train(CFG, **kw, **extra)
        got = ik.fused_iql_train(CFG, mesh=one, **kw, **extra)
        assert all(torch.equal(a, b) for a, b in zip(want[:2], got[:2]))
    with monkeypatch.context() as mp:
        _refuse_meshes(mp)
        ik.fused_iql_train(CFG, mesh=one, chunks_per_dispatch=4, **kw)
        with pytest.raises(ValueError, match="gloo"):
            ik.fused_iql_train(CFG, mesh=one, chunks_per_dispatch=4,
                               **dict(kw, n_chunks=4))
    assert len(ik.fused_iql_train(CFG, chunks_per_dispatch=4, **kw)[2]) == 1
    with pytest.raises(ValueError, match="chunks_per_dispatch"):
        ik.fused_iql_train(CFG, chunks_per_dispatch=0, **kw)


GROUPED = dict(batch=256, n_chunks=7, chunk_len=4, lr=0.4, eps=0.4,
               eps_halflife=12, eps_min=0.1, lr_anneal_start=2,
               lr_anneal_tau=3.0, lr_anneal_pow=1.2, seed=13, device="cpu",
               return_state=True)


def _assert_same_run(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    assert all(torch.equal(f, g) for f, g in zip(a[3]["fields"],
                                                  b[3]["fields"]))
    assert a[3]["next_chunk"] == b[3]["next_chunk"]


@pytest.mark.parametrize("packed", [True, False], ids=["K8", "K9"])
def test_grouped_mode_equals_the_per_chunk_mode(packed):
    """chunks_per_dispatch=3 gives the per-chunk run's q and fields bit for
    bit under annealed lr and eps, across a remainder, with every chunk's
    stats; a grouped run resumed inside a segment equals it too."""
    per = ik.fused_iql_train(CFG, packed=packed, **GROUPED)
    grouped = ik.fused_iql_train(CFG, packed=packed, chunks_per_dispatch=3,
                                 **GROUPED)
    _assert_same_run(per, grouped)
    assert len(grouped[2]) == 7
    assert per[2] == [grouped[2][0], grouped[2][6]]
    r = ik.fused_iql_train(CFG, packed=packed, chunks_per_dispatch=3,
                           **dict(GROUPED, n_chunks=4))[3]
    part = ik.fused_iql_train(
        CFG, packed=packed, chunks_per_dispatch=3, init=(r["q_a"], r["q_b"]),
        fields_init=r["fields"], start_chunk=r["next_chunk"],
        **dict(GROUPED, n_chunks=3))
    _assert_same_run(grouped, part)
    assert part[2] == grouped[2][4:]


def test_chunk_takes_its_scalars_from_a_tensor():
    """(seed, eps_int, step_offset) in an int32 [3] tensor give the
    by-value call's chunk; the tensor form takes no eps_int or offset
    beside it."""
    table = ik.pack_iql_table(CFG, *(torch.tensor(q) for q in
                                     _q((5, 4), 2, "random")))
    fields = ik.init_iql_state_fields(CFG, 256, "cpu")
    want = ik.iql_packed_chunk(CFG, 77, EPS, table, fields, 256, 4, 0.99, 40)
    scalars = torch.tensor([77, EPS, 40], dtype=torch.int32)
    got = ik.iql_packed_chunk(CFG, scalars, None, table, fields, 256, 4, 0.99)
    for a, b in zip([*want[0], *want[1], *want[2]],
                    [*got[0], *got[1], *got[2]]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="eps_int is None"):
        ik.iql_packed_chunk(CFG, scalars, EPS, table, fields, 256, 4)
    with pytest.raises(ValueError, match="int32"):
        ik.iql_packed_chunk(CFG, scalars.long(), None, table, fields, 256, 4)
