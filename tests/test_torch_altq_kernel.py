"""The port's alternating-turn Q learner (gym_soccer_tpu_torch.ops.
altq_kernel) on the CPU, where the chunk wrappers run their plain versions,
against the JAX package's ``altq_packed_chunk``/``altq_chunk(interpret=
True)`` and ``fused_altq_train(interpret=True)`` fed the same Q tables and
states; and the trainers' seed range, against the JAX trainers'.

Tolerances:

* final fields, the first three stats and the visit counts: exact.  Both
  packages act on the same double-bfloat16 Q values with the same counter
  PRNG.
* residual (K10) and TD (K11) sums: per cell within
  cnt * (2**-8 * max|delta| + 1e-6), where max|delta| <= 1 + (1 + gamma) *
  max|q|.  The JAX kernels round each value to bfloat16 before their
  float32 scatter (altq_kernel.py:129-133, :286-291); the port sums exact
  fixed point.  With q = 0 the values are the integer rewards, and the
  sums are equal.
* the trainer after its first chunk from q = 0: q exact (the sums are
  integers in both packages, and the update is the same float32
  arithmetic).  After a chunk from the same q: within lr * (2**-8 *
  max|delta| + 1e-6), the sums' tolerance over cnt; after 3 chunks from
  q = 0, within 3 times that (the first chunk is exact, and the second's
  error reaches the third's bootstrap values by at most (1 + gamma) lr
  times itself).

K10/K11 are held against the plain versions on the card by chip_smoke.py
and tests/test_torch_cuda.py."""
import os

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
from gym_soccer_tpu_torch.envs.soccer_alternating_env import build_alt_tables
from gym_soccer_tpu_torch.ops import altq_kernel as ak
from gym_soccer_tpu_torch.ops import iql_kernel as ik
from gym_soccer_tpu_torch.ops import learner_kernel as lk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG, JCFG = EnvConfig(5, 4, 0.2), JaxConfig(5, 4, 0.2)
NS = 1521
EPS = int(round(0.3 * 65536))
B, T = 256, 16


def _q(seed, scale=1.0):
    return (scale * np.random.default_rng(seed).uniform(-1, 1, (NS, 5))
            ).astype(np.float32)


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


def _jax_chunk(packed, seed, eps_int, q, jfields, off):
    pack, chunk, unpack = ((jak.pack_alt_m2, jak.altq_packed_chunk,
                            jak.unpack_alt_acc2) if packed else
                           (jak.pack_alt_m, jak.altq_chunk, jak.unpack_alt_acc))
    m = pack(JCFG, jnp.asarray(q))
    f, acc, st = chunk(JCFG, seed, eps_int, m, jfields, B, T,
                       step_offset=off, interpret=True)
    return (f, [np.asarray(a) for a in unpack(JCFG, acc)],
            [int(x) for x in st], np.asarray(m, np.float32))


def _port_chunk(packed, seed, eps_int, table, fields, off, cfg=CFG, b=B, t=T):
    chunk = ak.altq_packed_chunk if packed else ak.altq_chunk
    f, acc, st = chunk(cfg, seed, eps_int, table, fields, b, t, 0.99, off)
    assert len(st) == 4 and int(st[3]) == 0   # every value in range
    return (f, [a.numpy() for a in ak.unpack_alt_acc(cfg, acc)],
            [int(x) for x in st[:3]], acc)


@pytest.mark.parametrize("packed", [True, False], ids=["K10", "K11"])
def test_chunk_plain_equals_jax(packed):
    """256 lanes x 16 steps at step offset 37 on a random q: fields, stats
    and counts bit-equal, sums within tolerance; the port's table from
    ``pack_alt_table`` equals the one read from JAX's M in either
    layout."""
    q = _q(1)
    jfields0 = jak.init_alt_state_fields(JCFG, B)
    jf, jacc, jst, m = _jax_chunk(packed, 5, EPS, q, jfields0, 37)
    table = ak.pack_alt_table(CFG, torch.tensor(q))
    assert torch.equal(interop.alt_table_from_m(CFG, m, packed, "cpu"), table)
    other = (jak.pack_alt_m if packed else jak.pack_alt_m2)(JCFG,
                                                            jnp.asarray(q))
    assert torch.equal(interop.alt_table_from_m(
        CFG, np.asarray(other, np.float32), not packed, "cpu"), table)
    f, acc, st, raw = _port_chunk(packed, 5, EPS, table,
                                  interop.planes_from_tiles(jfields0, "cpu"),
                                  37)
    _assert_planes_equal(f, jf)
    assert st == jst and st[1] > 0
    assert raw[0].dtype == torch.int64 and raw[1].dtype == torch.int32
    assert np.array_equal(acc[1], jacc[1]) and int(acc[1].sum()) == B * T
    tol = acc[1] * (2.0 ** -8 * (1 + 1.99 * float(table.abs().max())) + 1e-6)
    diff = np.abs(acc[0] - jacc[0])
    assert (diff <= tol).all() and diff.max() > 0   # the bf16 rounding


def test_pack_is_double_bf16_with_unique_slots():
    """Each dense state owns one (row, turn) slot of five cells; the table
    holds double_bf16(q) there and zero elsewhere; unpack inverts the
    accumulator layout."""
    rows, turn = ak._alt_rows(CFG)
    jrows, jturn = jak._alt_rows(JCFG)
    assert np.array_equal(rows, jrows) and np.array_equal(turn, jturn)
    assert len({(int(r), int(t)) for r, t in zip(rows, turn)}) == NS
    q = torch.tensor(_q(9))
    table = ak.pack_alt_table(CFG, q)
    assert table.shape == (ak.n_codes(CFG), 10)
    cells = ak._cells(CFG, torch.device("cpu"))
    assert torch.equal(table.reshape(-1)[cells], ak.double_bf16(q))
    assert (table.reshape(-1)[cells] != q).float().mean() > 0.9
    assert int((table != 0).sum()) == int((ak.double_bf16(q) != 0).sum())
    sums = torch.zeros((ak.n_codes(CFG), 10), dtype=torch.int64)
    cnt = torch.zeros((ak.n_codes(CFG), 10), dtype=torch.int32)
    sums.reshape(-1)[cells] = 3 * 2 ** 31
    cnt.reshape(-1)[cells] = 2
    s, c = ak.unpack_alt_acc2(CFG, (sums, cnt))
    assert bool((s == 1.5).all() and (c == 2).all())


def _near_ties():
    """Per state, at A-to-move states q = [y, x, -1, -1, -1] with x > y in
    float32, at B-to-move states q = [y, z, 1, 1, 1] with z < y, where
    double_bf16 ties x and z with y: the exact greedy action is 1 for
    both players, the double-bf16 one is 0 (the lowest index wins)."""
    rng = np.random.default_rng(11)
    y = ik.double_bf16(torch.tensor(rng.uniform(0.1, 0.9, 8 * NS),
                                    dtype=torch.float32))
    x = torch.nextafter(y, torch.tensor(2.0))
    z = torch.nextafter(y, torch.tensor(-2.0))
    keep = (ik.double_bf16(x) == y) & (ik.double_bf16(z) == y)
    y, x, z = y[keep][:NS], x[keep][:NS], z[keep][:NS]
    assert len(y) == NS and bool((x > y).all() & (z < y).all())
    is_a = torch.tensor(build_alt_tables(CFG).turn == 0)
    q = torch.where(is_a[:, None], -1.0, 1.0).repeat(1, 5)
    q[:, 0] = y
    q[:, 1] = torch.where(is_a, x, z)
    return q.numpy()


def test_double_bf16_pin_changes_greedy_actions():
    """On near-ties the port plays what JAX plays (eps 0: action 0 for both
    players), and a table of the exact q would play action 1."""
    q = _near_ties()
    jfields0 = jak.init_alt_state_fields(JCFG, B)
    jf, jacc, jst, _ = _jax_chunk(True, 2, 0, q, jfields0, 0)
    fields0 = interop.planes_from_tiles(jfields0, "cpu")
    table = ak.pack_alt_table(CFG, torch.tensor(q))
    f, acc, st, _ = _port_chunk(True, 2, 0, table, fields0, 0)
    _assert_planes_equal(f, jf)
    assert st == jst and np.array_equal(acc[1], jacc[1])
    assert acc[1][:, 0].sum() == B * T
    exact = torch.zeros_like(table)
    exact.reshape(-1)[ak._cells(CFG, torch.device("cpu"))] = torch.tensor(q)
    _, acc_x, _, _ = _port_chunk(True, 2, 0, exact, fields0, 0)
    assert acc_x[1][:, 1].sum() == B * T


def test_packed_and_unpacked_step_the_same():
    """K10 and K11 step identical fields, stats and counts for the same
    table; with q = 0 the residual is the TD, bit for bit (the JAX
    package's test_altq_packed_chunk_matches_unpacked)."""
    fields0 = ak.init_alt_state_fields(CFG, 1024, "cpu")
    for q in (_q(4), np.zeros((NS, 5), np.float32)):
        table = ak.pack_alt_table(CFG, torch.tensor(q))
        f1, _, s1, r1 = _port_chunk(True, 11, EPS, table, fields0, 0, b=1024)
        f2, _, s2, r2 = _port_chunk(False, 11, EPS, table, fields0, 0,
                                    b=1024)
        assert all(torch.equal(a, b) for a, b in zip(f1, f2)) and s1 == s2
        assert torch.equal(r1[1], r2[1]) and int(r1[1].sum()) == 1024 * T
        assert torch.equal(r1[0], r2[0]) == (not q.any())
    # with q = 0 every TD is the reward: the sums total the reward sum
    assert int(r1[0].sum()) == s1[0] * 2 ** 32


def test_greedy_and_explore_edges():
    """eps 0 on q = 0: everyone plays NOOP, nobody scores; eps 1 (65536):
    every action is explored; a step offset changes the stream."""
    table = ak.pack_alt_table(CFG, torch.zeros((NS, 5)))
    fields0 = ak.init_alt_state_fields(CFG, 512, "cpu")
    _, acc, st, _ = _port_chunk(False, 3, 0, table, fields0, 0, b=512)
    assert st[1] == 0
    assert acc[1][:, 0].sum() == 512 * T and not acc[1][:, 1:].any()
    _, acc1, _, _ = _port_chunk(False, 3, ak.EPS_ONE, table, fields0, 0,
                                b=512)
    assert acc1[1].sum(0).min() > 0.15 * 512 * T / 5
    _, acc2, _, _ = _port_chunk(False, 3, ak.EPS_ONE, table, fields0, T,
                                b=512)
    assert not np.array_equal(acc1[1], acc2[1])


def test_any_grid_runs():
    """15x10 runs, where the JAX package's VMEM guard refuses it."""
    big, jbig = EnvConfig(15, 10, 0.2), JaxConfig(15, 10, 0.2)
    with pytest.raises(ValueError, match="altq_train"):
        jak.altq_chunk(jbig, 0, 0, None, None, batch=1024, n_steps=1,
                       interpret=True)
    nS = build_alt_tables(big).nS
    table = ak.pack_alt_table(big, torch.zeros((nS, 5)))
    f, acc, st, _ = _port_chunk(True, 1, EPS, table,
                                ak.init_alt_state_fields(big, 128, "cpu"), 0,
                                cfg=big, b=128, t=4)
    assert int(acc[1].sum()) == 128 * 4


TRAIN = dict(batch=B, chunk_len=T, lr=0.5, eps=0.3, seed=7, eps_halflife=64,
             lr_anneal_start=1, lr_anneal_tau=2.0)


def _jax_resume(res):
    return {k: [np.asarray(f) for f in x] if k == "fields" else np.asarray(x)
            for k, x in res.items()}


def _sums_tol(q):
    """lr * (2**-8 * max|delta| + 1e-6): one chunk's sums' tolerance over
    cnt, for a chunk that read ``q``."""
    return TRAIN["lr"] * (2.0 ** -8 * (1 + 1.99 * float(np.abs(q).max()))
                          + 1e-6)


@pytest.mark.parametrize("packed", [True, False], ids=["K10", "K11"])
def test_first_chunk_equals_jax(packed):
    """From q = 0 the first chunk's q and fields are bit-equal to the JAX
    trainer's: every residual of a zero table is an integer, which JAX's
    bfloat16 scatter holds exactly."""
    jq, jhist, jres = jak.fused_altq_train(
        JCFG, n_chunks=1, return_state=True, interpret=True, packed=packed,
        **TRAIN)
    q, hist, res = ak.fused_altq_train(CFG, n_chunks=1, return_state=True,
                                       packed=packed, device="cpu", **TRAIN)
    assert hist == jhist and q.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq)) and q.abs().max() > 0
    _assert_planes_equal(res["fields"], jres["fields"])
    assert res["next_chunk"] == 1 and res["packed"] is packed


def test_three_chunks_and_a_jax_resume_follow_jax():
    """After 3 chunks q agrees with JAX's within 3 chunks' tolerance, on the
    same trajectories.  A 2-chunk JAX run's resume dict, through interop,
    continues in the port like JAX's third chunk: the same fields and
    stats, q within one chunk's tolerance."""
    jq3, jhist3, jres3 = jak.fused_altq_train(
        JCFG, n_chunks=3, return_state=True, interpret=True, **TRAIN)
    q3, hist3, res3 = ak.fused_altq_train(CFG, n_chunks=3, return_state=True,
                                          device="cpu", **TRAIN)
    assert hist3 == jhist3
    _assert_planes_equal(res3["fields"], jres3["fields"])
    diff = np.abs(q3.numpy() - np.asarray(jq3))
    assert diff.max() <= 3 * _sums_tol(jq3) and diff.max() > 0
    jres2 = jak.fused_altq_train(JCFG, n_chunks=2, return_state=True,
                                 interpret=True, **TRAIN)[2]
    r = interop.resume_from_numpy(_jax_resume(jres2), "cpu")
    assert set(r) == {"q", "fields", "next_chunk", "packed"}
    assert len(r["fields"]) == 7 and r["next_chunk"] == 2 and r["packed"]
    q, hist, res = ak.fused_altq_train(
        CFG, n_chunks=1, return_state=True, init=r["q"],
        fields_init=r["fields"], start_chunk=r["next_chunk"], device="cpu",
        **TRAIN)
    assert hist == jhist3[-1:] and res["next_chunk"] == 3
    _assert_planes_equal(res["fields"], jres3["fields"])
    np.testing.assert_allclose(q.numpy(), np.asarray(jq3), rtol=0,
                               atol=_sums_tol(r["q"].numpy()))


@pytest.mark.parametrize("packed", [True, False], ids=["K10", "K11"])
def test_trainer_exact_resume(packed):
    """3 + 3 chunks through the resume dict equal 6, bit for bit, with
    annealed lr and eps."""
    kw = dict(batch=256, chunk_len=4, lr=0.5, eps=0.4, eps_halflife=24,
              lr_anneal_start=2, lr_anneal_tau=4.0, seed=11, packed=packed,
              device="cpu")
    q, hist, res = ak.fused_altq_train(CFG, n_chunks=6, return_state=True,
                                       **kw)
    r = ak.fused_altq_train(CFG, n_chunks=3, return_state=True, **kw)[2]
    q2, hist2, res2 = ak.fused_altq_train(
        CFG, n_chunks=3, return_state=True, init=r["q"],
        fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
    assert torch.equal(q, q2)
    assert all(torch.equal(a, b) for a, b in zip(res["fields"],
                                                  res2["fields"]))
    assert res2["next_chunk"] == 6 and hist2 == hist[-1:]


@pytest.mark.parametrize("packed", [True, False], ids=["K10", "K11"])
def test_warm_start_lr_zero_keeps_q(packed):
    q0 = torch.tensor(_q(1, 0.5))
    q, _ = ak.fused_altq_train(CFG, batch=256, n_chunks=2, chunk_len=4,
                               lr=0.0, eps=0.5, init=q0, packed=packed,
                               device="cpu")
    assert torch.equal(q, q0)


def test_fused_altq_training_learns():
    """The JAX package's test_fused_altq_training_learns_packed, at its
    recipe."""
    q, hist = ak.fused_altq_train(CFG, batch=1024, n_chunks=20, chunk_len=16,
                                  lr=0.5, eps=0.3, device="cpu")
    assert float(q.abs().max()) > 0.01 and float(q.abs().max()) <= 1.05
    assert sum(h[1] for h in hist) > 0


def test_chunk_checks_its_arguments():
    table = torch.zeros((ak.n_codes(CFG), ak.ALT_COLS))
    fields = ak.init_alt_state_fields(CFG, 256, "cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        ak.altq_packed_chunk(CFG, 0, EPS, table, fields, 200, 4)
    with pytest.raises(ValueError, match="2\\*\\*29"):
        ak.altq_chunk(CFG, 0, EPS, table, fields, 2 ** 22, 2 ** 8)
    with pytest.raises(ValueError, match="table"):
        ak.altq_packed_chunk(CFG, 0, EPS, table[:, :9].contiguous(), fields,
                             256, 4)
    with pytest.raises(ValueError, match="7 tensors"):
        ak.altq_chunk(CFG, 0, EPS, table, fields[:6], 256, 4)
    with pytest.raises(ValueError, match="int32"):
        ak.altq_chunk(CFG, 0, EPS, table, [f.long() for f in fields], 256, 4)
    with pytest.raises(ValueError, match="eps_int"):
        ak.altq_packed_chunk(CFG, 0, 65537, table, fields, 256, 4)
    with pytest.raises(ValueError, match="steps"):
        ak.altq_chunk(CFG, 0, EPS, table, fields, 256, 4, 0.99, 2 ** 31 - 2)
    with pytest.raises(ValueError, match="one EnvConfig"):
        ak.altq_chunk((CFG,), 0, EPS, table, fields, 256, 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ak.altq_packed_chunk(CFG, 0, EPS, table.to("meta"),
                             [f.to("meta") for f in fields], 256, 4)


@pytest.mark.parametrize("fn", [ak.altq_packed_chunk, ak.altq_chunk,
                                ak.altq_packed_chunk_plain,
                                ak.altq_chunk_plain],
                         ids=["K10", "K11", "K10-plain", "K11-plain"])
def test_chunk_counts_values_out_of_range(fn):
    """The fourth stat counts the TD values outside +-2**30 / (batch *
    n_steps) or not finite."""
    fields = ak.init_alt_state_fields(CFG, B, "cpu")
    z = torch.zeros((NS, 5))
    for q, want in ((z, 0), (z + 2.0 ** 17, 0), (z + 1e7, None),
                    (z + float("nan"), B * T)):
        table = ak.pack_alt_table(CFG, q)
        _, goals, truncs, out = (int(x) for x in
                                 fn(CFG, 0, EPS, table, fields, B, T)[2])
        if want is None:   # only a terminal step's value, r - 1e7
            assert goals > 0 and out == goals + truncs
        else:
            assert out == want


def _refuse_meshes(monkeypatch):
    """Make ``dispatch.run``'s capture check refuse every mesh it is
    handed, as it refuses a gloo mesh on the card (which the CPU cannot
    build)."""
    from gym_soccer_tpu_torch.ops import dispatch

    def refuse(mesh):
        if mesh is not None:
            raise ValueError("a gloo mesh's collectives cannot be captured")
    monkeypatch.setattr(dispatch, "check_capture", refuse)


def test_trainer_refuses_a_run_out_of_range_and_unported_modes(
        monkeypatch):
    big = np.full((NS, 5), 1e9, np.float32)
    kw = dict(batch=256, n_chunks=1, chunk_len=4, device="cpu")
    for packed in (True, False):
        with pytest.raises(ValueError, match="overflow"):
            ak.fused_altq_train(CFG, init=big, packed=packed, **kw)
    with pytest.raises(ValueError, match="init q"):
        ak.fused_altq_train(CFG, init=big[:-1], **kw)
    # the mesh is ported: one rank equals no mesh; the grouped mode hands
    # its mesh to dispatch.run's capture check, which refuses a gloo mesh
    # on the card
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    one = pmesh.env_mesh(device="cpu")
    for extra in (dict(), dict(chunks_per_dispatch=4)):
        assert torch.equal(ak.fused_altq_train(CFG, **kw, **extra)[0],
                           ak.fused_altq_train(CFG, mesh=one, **kw,
                                               **extra)[0])
    with monkeypatch.context() as mp:
        _refuse_meshes(mp)
        ak.fused_altq_train(CFG, mesh=one, chunks_per_dispatch=4, **kw)
        with pytest.raises(ValueError, match="gloo"):
            ak.fused_altq_train(CFG, mesh=one, chunks_per_dispatch=4,
                                **dict(kw, n_chunks=4))
    assert len(ak.fused_altq_train(CFG, chunks_per_dispatch=4, **kw)[1]) == 1
    with pytest.raises(ValueError, match="chunks_per_dispatch"):
        ak.fused_altq_train(CFG, chunks_per_dispatch=0, **kw)


GROUPED = dict(batch=256, n_chunks=7, chunk_len=4, lr=0.5, eps=0.4,
               eps_halflife=12, eps_min=0.1, lr_anneal_start=2,
               lr_anneal_tau=3.0, lr_anneal_pow=1.2, seed=11, device="cpu",
               return_state=True)


def _assert_same_run(a, b):
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(f, g) for f, g in zip(a[2]["fields"],
                                                  b[2]["fields"]))
    assert a[2]["next_chunk"] == b[2]["next_chunk"]


@pytest.mark.parametrize("packed", [True, False], ids=["K10", "K11"])
def test_grouped_mode_equals_the_per_chunk_mode(packed):
    """chunks_per_dispatch=3 gives the per-chunk run's q and fields bit for
    bit under annealed lr and eps, across a remainder, with every chunk's
    stats; a grouped run resumed inside a segment equals it too."""
    per = ak.fused_altq_train(CFG, packed=packed, **GROUPED)
    grouped = ak.fused_altq_train(CFG, packed=packed, chunks_per_dispatch=3,
                                  **GROUPED)
    _assert_same_run(per, grouped)
    assert len(grouped[1]) == 7
    assert per[1] == [grouped[1][0], grouped[1][6]]
    r = ak.fused_altq_train(CFG, packed=packed, chunks_per_dispatch=3,
                            **dict(GROUPED, n_chunks=4))[2]
    part = ak.fused_altq_train(
        CFG, packed=packed, chunks_per_dispatch=3, init=r["q"],
        fields_init=r["fields"], start_chunk=r["next_chunk"],
        **dict(GROUPED, n_chunks=3))
    _assert_same_run(grouped, part)
    assert part[1] == grouped[1][4:]


_SEED_RUNS = {
    "minimax": (lambda s, **kw: jlk.fused_minimax_train(
        JCFG, seed=s, solver_iters=2, **kw),
        lambda s, **kw: lk.fused_minimax_train(CFG, seed=s, solver_iters=2,
                                               **kw)),
    "best_response": (lambda s, **kw: jlk.fused_best_response_train(
        JCFG, np.zeros(761, np.int32), "player_a", seed=s, **kw),
        lambda s, **kw: lk.fused_best_response_train(
            CFG, np.zeros(761, np.int32), "player_a", seed=s, **kw)),
    "iql": (lambda s, **kw: jik.fused_iql_train(JCFG, seed=s, **kw),
            lambda s, **kw: ik.fused_iql_train(CFG, seed=s, **kw)),
    "altq": (lambda s, **kw: jak.fused_altq_train(JCFG, seed=s, **kw),
             lambda s, **kw: ak.fused_altq_train(CFG, seed=s, **kw)),
}


@pytest.mark.parametrize("seed", [2147, 2148, -2148])
@pytest.mark.parametrize("trainer", list(_SEED_RUNS))
def test_trainers_take_the_seeds_jax_takes(trainer, seed):
    """A chunk seed is seed * 1_000_003 + k in int32: both packages run
    seed 2147 and raise OverflowError for 2148 and -2148, the port before
    its first chunk."""
    jax_run, port_run = _SEED_RUNS[trainer]
    kw = dict(batch=256, n_chunks=1, chunk_len=2)
    if seed == 2147:
        jax_run(seed, interpret=True, **kw)
        port_run(seed, device="cpu", **kw)
        return
    with pytest.raises(OverflowError):
        jax_run(seed, interpret=True, **kw)
    with pytest.raises(OverflowError, match="int32"):
        port_run(seed, device="meta", **kw)   # raises before any tensor
    assert lk._chunk_seed(2147, 1) == 2147 * 1_000_003 + 1
    assert lk._chunk_seed(-2147, 0) == (-2147 * 1_000_003) & 0xFFFFFFFF
