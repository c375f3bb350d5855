"""The port's mixed-geometry path on the CPU, where the wrappers run their
plain PyTorch versions, against the JAX package fed the same seeded
numpy inputs: core/multigrid's codec and lane geometry,
ops/step_kernel's per-lane geometry, ``multigrid_rollout`` (kernel K3)
against ``pallas_multigrid_rollout(interpret=True)``,
``multigrid_packed_learner_chunk`` (kernel K6) against its JAX namesake in
interpret mode, and ``fused_minimax_train`` with a tuple of configs.

Tolerances:

* fields, stats, visit counts, codec arrays and observations: exact (all
  integer, the same counter PRNG, the same bfloat16 pi values);
* residual sums: per cell within cnt * (2**-8 * max|delta| + 1e-6),
  max|delta| <= 1 + 2 * max|v|: the JAX kernel rounds each residual to
  bfloat16 before its float32 scatter-add and bootstraps from a
  double-bfloat16 v, the port sums exact fixed point;
* the trainer after its first chunk: q and n exact (chunk 0 starts from
  v = q = 0, so its sums are the integer rewards), v and pi within 1e-5;
  after a resumed chunk q within lr * (2**-8 * 3 + 1e-6).

The K3 and K6 kernels are held against these plain versions on the card
by chip_smoke.py and tests/test_torch_cuda.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import multigrid as jmg
from gym_soccer_tpu.ops import learner_kernel as jlk
from gym_soccer_tpu.ops import step_kernel as jsk
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import multigrid as mg
from gym_soccer_tpu_torch.ops import learner_kernel as lk
from gym_soccer_tpu_torch.ops import step_kernel as sk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

MIX3 = ((5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3))   # tools/bench_all.py:421
MIX_BIG = ((5, 4, 0.2), (11, 7, 0.2))
TRAIN_MIX = ((5, 4, 0.2), (6, 5, 0.1))
# examples/train_minimax_tpu.py:141-151, the --multigrid recipe's mixture
MG_BOARDS = ((5, 4, 0.2), (6, 5, 0.2))


def _cfgs(boards):
    return (tuple(JaxConfig(*b) for b in boards),
            tuple(EnvConfig(*b) for b in boards))


def _ints(stats):
    return [int(x) for x in stats]


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


# ----------------------------------------------------------------------
# core/multigrid: codec, lane geometry, observations
# ----------------------------------------------------------------------

@pytest.mark.parametrize("boards", [MIX3, MIX_BIG], ids=["3-variant", "big"])
def test_codec_and_lane_geometry_equal_jax(boards):
    jc, pc = _cfgs(boards)
    jcodec, codec = jmg.build_codec(jc), mg.build_codec(pc)
    assert codec.nS == jcodec.nS and codec.nS_total == jcodec.nS_total
    assert np.array_equal(codec.offsets, jcodec.offsets)
    assert np.array_equal(codec.raw_to_dense, jcodec.raw_to_dense)
    jgeo = jmg.lane_geometry(jc, 1000, max_steps=77)
    geo = mg.lane_geometry(pc, 1000, max_steps=77, device="cpu")
    for f in ("H", "W", "glo", "ghi", "slip", "vid"):
        a, b = getattr(geo, f).numpy(), np.asarray(getattr(jgeo, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert geo.max_steps == 77


@pytest.mark.parametrize("layout", ["roundrobin", "blocked"])
@pytest.mark.parametrize("boards", [MIX3, MIX_BIG], ids=["3-variant", "big"])
def test_mg_planes_equal_jax(layout, boards):
    """Both lane layouts, and the initial ISD spread (lane // nV) % nI that
    they share."""
    jc, pc = _cfgs(boards)
    B = 2048
    jplanes, jinit = jsk._mg_planes(jc, B, (B // 128, 128), layout=layout)
    planes, init = sk.mg_planes(pc, B, "cpu", layout=layout)
    _assert_planes_equal(planes, jplanes)
    _assert_planes_equal(init, jinit)
    if layout == "blocked":   # lanes in contiguous blocks, not i % nV
        assert int(planes[5][1]) == 0 and int(planes[5][-1]) == len(pc) - 1


def test_isd_fields_equal_jax():
    jc, pc = _cfgs(MIX3)
    u = np.random.default_rng(0).uniform(0, 1, 3000).astype(np.float32)
    u[:4] = (0.0, 0.25, 0.5, np.nextafter(np.float32(1), np.float32(0)))
    jgeo = jmg.lane_geometry(jc, 3000)
    want = jmg._isd_fields(jgeo, jnp.asarray(u))
    got = mg._isd_fields(mg.lane_geometry(pc, 3000, device="cpu"),
                         torch.tensor(u))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_dense_and_global_obs_equal_jax():
    """Observations of the lanes' states after 24 steps of K3's plain
    version, each under its own variant."""
    jc, pc = _cfgs(MIX3)
    B = 1024
    fields, _ = sk.multigrid_rollout(pc, 3, B, 24, "cpu")
    jgeo = jmg.lane_geometry(jc, B)
    jf = [jnp.asarray(f.numpy()) for f in fields]
    st = jmg.MultiGridState(*jf[:6], n=jf[5], key=None, geo=jgeo)
    geo = mg.lane_geometry(pc, B, device="cpu")
    codec = mg.build_codec(pc)
    dense = mg.dense_obs(codec, fields, geo)
    want = np.asarray(jmg.dense_obs(jmg.build_codec(jc), st))
    assert np.array_equal(dense.numpy(), want)
    assert (dense > 0).all()   # every lane ends reachable and not terminal
    assert np.array_equal(mg.global_obs(codec, fields, geo).numpy(),
                          np.asarray(jmg.global_obs(jmg.build_codec(jc), st)))


# ----------------------------------------------------------------------
# Per-lane geometry in the plain game code
# ----------------------------------------------------------------------

def test_geo_planes_transition_and_autoreset_equal_jax():
    """transition_core and autoreset_core on a GeoPlanes: the per-lane row
    clamp (torch.clamp with a tensor bound), the per-lane slip threshold
    and the arithmetic ISD reset, on random actions and counter words over
    the states of a mixed rollout."""
    jc, pc = _cfgs(MIX3)
    B = 4096
    fields, _ = sk.multigrid_rollout(pc, 5, B, 8, "cpu")
    (H, W, glo, ghi, q, _), _ = sk.mg_planes(pc, B, "cpu")
    rng = np.random.default_rng(1)
    aa, ab = (rng.integers(0, 5, B).astype(np.int32) for _ in range(2))
    bits1, bits2 = (rng.integers(0, 2 ** 32, B, dtype=np.uint64)
                    .astype(np.uint32) for _ in range(2))
    geo = sk.GeoPlanes(H, W, glo, ghi, q, 100)
    got = sk.transition_core(*fields[:5], torch.tensor(aa), torch.tensor(ab),
                             torch.tensor(bits1.astype(np.int64)),
                             torch.tensor(bits2.astype(np.int64)), geo, q)
    J = lambda t: jnp.asarray(t.numpy())
    jgeo = jsk.GeoPlanes(H=J(H), W=J(W), glo=J(glo), ghi=J(ghi), q_int=J(q),
                         max_steps=100)
    want = jsk.transition_core(*(J(f) for f in fields[:5]), jnp.asarray(aa),
                               jnp.asarray(ab), jnp.asarray(bits1),
                               jnp.asarray(bits2), jgeo, jgeo.q_int)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # clamped rows: some lanes moved off their board and stayed on it
    assert bool(((got[0] == H - 1) & (fields[0] == H - 1)).any())
    goal = torch.tensor(rng.random(B) < 0.3)
    t = torch.tensor(rng.integers(95, 100, B).astype(np.int32))
    reset = sk.autoreset_core(*got[:5], t, goal,
                              torch.tensor(bits2.astype(np.int64)), geo)
    jreset = jsk.autoreset_core(*(J(x) for x in got[:5]), J(t), J(goal),
                                jnp.asarray(bits2), jgeo)
    for a, b in zip(reset, jreset):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------------------
# K3: multigrid_rollout
# ----------------------------------------------------------------------

def test_multigrid_rollout_equals_pallas_interpret():
    jc, pc = _cfgs(MIX3)
    B, T = 1024, 16
    jfields, jstats = jsk.pallas_multigrid_rollout(jc, jnp.int32(7), B, T,
                                                   interpret=True)
    fields, stats = sk.multigrid_rollout(pc, 7, B, T, "cpu")
    _assert_planes_equal(fields, jfields)
    assert stats.dtype == torch.int64 and tuple(stats.shape) == (3, 3)
    assert np.array_equal(stats.numpy(), np.asarray(jstats))
    assert int(stats[:, 1].sum()) > 0


def test_multigrid_rollout_split_equals_one_run():
    """A run resumed through init_fields/step_offset equals one run, and
    equals the JAX kernel resumed from the port's planes."""
    jc, pc = _cfgs(MIX3)
    B = 1024
    f1, s1 = sk.multigrid_rollout_plain(pc, 9, B, 20, "cpu")
    fa, sa = sk.multigrid_rollout(pc, 9, B, 12, "cpu")
    fb, sb = sk.multigrid_rollout(pc, 9, B, 8, "cpu", init_fields=fa,
                                  step_offset=12)
    assert all(torch.equal(a, b) for a, b in zip(f1, fb))
    assert torch.equal(s1, sa + sb)
    jfb, jsb = jsk.pallas_multigrid_rollout(
        jc, jnp.int32(9), B, 8, interpret=True, step_offset=12,
        init_fields=[jnp.asarray(p) for p in interop.planes_to_tiles(fa)])
    _assert_planes_equal(fb, jfb)
    assert np.array_equal(sb.numpy(), np.asarray(jsb))


@pytest.mark.parametrize("board", [(5, 4, 0.2), (11, 7, 0.3)])
def test_one_variant_mixture_equals_fused_rollout(board):
    cfg = EnvConfig(*board)
    f1, s1 = sk.fused_rollout_plain(cfg, 4, 1024, 40, "cpu")
    fm, sm = sk.multigrid_rollout((cfg,), 4, 1024, 40, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(f1, fm))
    assert _ints(s1) == _ints(sm[0])


def test_multigrid_rollout_checks_its_arguments():
    _, pc = _cfgs(MIX3)
    with pytest.raises(ValueError, match="max_steps"):
        sk.multigrid_rollout((pc[0], EnvConfig(6, 5, 0.1, max_steps=50)), 0,
                             1024, 4, "cpu")
    with pytest.raises(ValueError, match="1 to 16"):
        sk.multigrid_rollout(pc * 6, 0, 1024, 4, "cpu")
    with pytest.raises(ValueError, match="multiple of 1024"):
        sk.multigrid_rollout(pc, 0, 1000, 4, "cpu")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sk.multigrid_rollout(pc, 0, 1024, 4, "meta")
    with pytest.raises(ValueError, match="layout"):
        sk.mg_planes(pc, 1024, "cpu", layout="striped")


# ----------------------------------------------------------------------
# K6: multigrid_packed_learner_chunk
# ----------------------------------------------------------------------

def _tables(nS, seed):
    """Random non-uniform policies and v in [-1, 1] as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(5), nS).astype(np.float32),
            rng.dirichlet(np.ones(5), nS).astype(np.float32),
            rng.uniform(-1, 1, nS).astype(np.float32))


jax_pack = jax.jit(jlk.pack_m2, static_argnums=(0,))


@pytest.mark.parametrize("boards", [TRAIN_MIX, MIX_BIG, MG_BOARDS],
                         ids=["5x4+6x5", "5x4+11x7", "5x4+6x5-slip0.2"])
def test_mg_packed_chunk_plain_equals_jax(boards):
    """K6's plain version on a mixture equals JAX's
    ``multigrid_packed_learner_chunk`` in interpret mode fed the same
    table and state (the tolerances of the module docstring); the
    --multigrid recipe's own mixture among them."""
    jc, pc = _cfgs(boards)
    B, T = 256, 4
    pa, pb, v = _tables(lk.n_states(pc), len(boards[-1]) + boards[-1][0])
    m = jax_pack(jc, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(v), 0.2)
    jplanes, jfields0 = jlk.init_state_fields(jc, B)
    jfields, jacc, jstats = jlk.multigrid_packed_learner_chunk(
        jc, 11, m, jplanes, jfields0, B, T, interpret=True)
    jres, jcnt = (np.asarray(a) for a in jlk.unpack_acc2(jc, jacc))

    table = interop.table_from_packed_m(pc, np.asarray(m, np.float32), "cpu")
    # the port packs the same pi; v is exact in the port, hi + lo in JAX
    own = lk.pack_m2(pc, torch.tensor(pa), torch.tensor(pb), torch.tensor(v),
                     0.2)
    assert torch.equal(own[:, :10], table[:, :10])
    assert (own[:, 10] - table[:, 10]).abs().max() <= 2.0 ** -17
    planes, fields0 = lk.init_state_fields(pc, B, "cpu")
    _assert_planes_equal(planes, jplanes)
    _assert_planes_equal(fields0, jfields0)
    fields, acc, stats = lk.multigrid_packed_learner_chunk(
        pc, 11, table, planes, fields0, B, T)
    res, cnt = (a.numpy() for a in lk.unpack_acc2(pc, acc))
    _assert_planes_equal(fields, jfields)
    assert _ints(stats[:3]) == _ints(jstats) and int(stats[3]) == 0
    assert np.array_equal(cnt, jcnt) and int(cnt.sum()) == B * T
    # blocked layout: each variant holds half the lanes and half the visits
    nS0 = lk.n_states(pc[0])
    assert int(cnt[:nS0].sum()) == int(cnt[nS0:].sum()) == B * T // 2
    max_delta = 1 + 2 * float(table[:, lk.COL_V].abs().max())
    tol = cnt * (2.0 ** -8 * max_delta + 1e-6)
    assert (np.abs(res - jres) <= tol).all(), np.abs(res - jres).max()


@pytest.mark.parametrize("board", [(5, 4, 0.2), (11, 7, 0.2)])
def test_one_variant_mixture_equals_static_chunk(board):
    """(cfg,) as a mixture steps, counts and sums like the static K5 plain
    version; its table has the 8-aligned block's extra rows, left empty."""
    cfg = EnvConfig(*board)
    B, T = 256, 6
    pa, pb, v = (torch.tensor(x) for x in _tables(lk.n_states(cfg), 2))
    table = lk.pack_m2(cfg, pa, pb, v, 0.3)
    mtable = lk.pack_m2((cfg,), pa, pb, v, 0.3)
    n = lk.n_codes(cfg)
    assert lk.n_codes((cfg,)) == -(-n // 8) * 8
    assert torch.equal(mtable[:n], table) and not mtable[n:].any()
    f1, (s1, c1), st1 = lk.packed_learner_chunk(
        cfg, 7, table, lk.init_state_fields(cfg, B, "cpu"), B, T)
    planes, fields0 = lk.init_state_fields((cfg,), B, "cpu")
    fm, (sm, cm), stm = lk.multigrid_packed_learner_chunk(
        (cfg,), 7, mtable, planes, fields0, B, T)
    assert all(torch.equal(a, b) for a, b in zip(f1, fm))
    assert torch.equal(sm[:n], s1) and torch.equal(cm[:n], c1)
    assert not sm[n:].any() and not cm[n:].any()
    assert _ints(st1) == _ints(stm)


def test_mixture_jax_refuses_runs_in_the_port():
    """The mixture the JAX kernels refuse for VMEM (tests/
    test_multigrid_learner_kernel.py ``test_mg_vmem_guard``) runs a small
    chunk in the port, whose tables live in device memory."""
    jc, pc = _cfgs(((15, 10, 0.2), (14, 10, 0.2)))
    with pytest.raises(ValueError, match="multigrid_minimax_train"):
        jlk.multigrid_learner_chunk(jc, 0, None, None, None, batch=1024,
                                    n_steps=1, interpret=True)
    nS = lk.n_states(pc)
    uni = torch.full((nS, 5), 0.2)
    table = lk.pack_m2(pc, uni, uni, torch.zeros(nS), 0.3)
    assert lk.n_codes(pc) == 47128 + 41184
    planes, fields = lk.init_state_fields(pc, 256, "cpu")
    fields, (sums, cnt), stats = lk.multigrid_packed_learner_chunk(
        pc, 0, table, planes, fields, 256, 2)
    assert int(cnt.sum()) == 512 and int(stats[3]) == 0
    H, W = planes[0], planes[1]
    for f, hi in zip(fields[:4], (H, W, H, W)):
        assert bool(((f >= 0) & (f < hi)).all())


# ----------------------------------------------------------------------
# fused_minimax_train on a mixture
# ----------------------------------------------------------------------

TRAIN = dict(batch=256, chunk_len=4, lr=0.5, eps=0.3, solver_iters=50,
             seed=7)


def _jax_resume(res):
    return {k: [np.asarray(f) for f in x] if k == "fields" else np.asarray(x)
            for k, x in res.items()}


def test_mixture_trainer_first_chunk_equals_jax():
    jc, pc = _cfgs(TRAIN_MIX)
    jq, jv, jpa, jpb, jhist, jres = jlk.fused_minimax_train(
        jc, n_chunks=1, return_state=True, interpret=True, **TRAIN)
    q, v, pa, pb, hist, res = lk.fused_minimax_train(
        pc, n_chunks=1, return_state=True, device="cpu", **TRAIN)
    assert hist == jhist
    assert q.shape == (lk.n_states(pc), 5, 5)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(res["n"].numpy(), np.asarray(jres["n"]))
    for a, b in ((v, jv), (pa, jpa), (pb, jpb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    _assert_planes_equal(res["fields"], jres["fields"])
    assert res["next_chunk"] == 1 and res["packed"] is True


def test_mixture_resume_from_jax_state_follows_jax():
    """A JAX mixture run's 2-chunk resume dict (fields only: the planes are
    rebuilt), carried through interop, continues in the port like the
    JAX run's third chunk: the same trajectories and visit counts, q
    within lr * (2**-8 * 3 + 1e-6)."""
    jc, pc = _cfgs(TRAIN_MIX)
    kw = dict(TRAIN, eps_halflife=16, lr_anneal_start=1, lr_anneal_tau=4.0)
    *_, jhist, jres3 = jlk.fused_minimax_train(
        jc, n_chunks=3, return_state=True, interpret=True, **kw)
    jres2 = _jax_resume(jlk.fused_minimax_train(
        jc, n_chunks=2, return_state=True, interpret=True, **kw)[5])
    r = interop.resume_from_numpy(jres2, "cpu")
    assert r["next_chunk"] == 2 and r["packed"] is True
    _, _, _, _, hist, res = lk.fused_minimax_train(
        pc, n_chunks=1, return_state=True,
        init=tuple(jres2[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
        fields_init=r["fields"], start_chunk=r["next_chunk"], device="cpu",
        **kw)
    assert hist == jhist[-1:]
    _assert_planes_equal(res["fields"], jres3["fields"])
    assert np.array_equal(res["n"].numpy(), np.asarray(jres3["n"]))
    np.testing.assert_allclose(res["q"].numpy(), np.asarray(jres3["q"]),
                               rtol=0, atol=kw["lr"] * (3 * 2.0 ** -8 + 1e-6))


def test_mixture_trainer_exact_resume():
    """2 + 2 chunks through the resume dict equal 4, bit for bit."""
    _, pc = _cfgs(TRAIN_MIX)
    kw = dict(batch=256, chunk_len=4, lr=0.5, eps=0.4, eps_halflife=32,
              lr_anneal_start=1, lr_anneal_tau=4.0, solver_iters=30, seed=7,
              device="cpu")
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
    assert part[5]["next_chunk"] == 4 and part[4] == whole[4][-1:]
