"""The two stages of the K5 learner kernel (gym_soccer_tpu_torch.ops.
learner_codes) on the CPU: the producers' words and side bytes, then the
consumers' steps on the prepared rows, held to
``packed_learner_chunk_plain`` bit for bit (fields, stats, visit counts and
the int64 sums) and to the JAX package's ``packed_learner_chunk`` in
interpret mode (fields, stats and counts exactly; the sums within the bf16
tolerance of ``tests/test_torch_learner_kernel.py``, since JAX rounds each
visit to bfloat16); the prepared rows, their shared memory, the layout of
the one allocation and the lanes per block."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import learner_kernel as jlk
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import learner_codes as lc
from gym_soccer_tpu_torch.ops import learner_kernel as lk
from gym_soccer_tpu_torch.ops import learner_variants
from gym_soccer_tpu_torch.ops import rollout_codes as rc

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

jax_pack = jax.jit(jlk.pack_m2, static_argnums=(0,))


def _tables(cfg, seed):
    """Random non-uniform policies and v in [-1, 1] as numpy."""
    nS = len(lk._cell_rows(cfg))
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(5), nS).astype(np.float32),
            rng.dirichlet(np.ones(5), nS).astype(np.float32),
            rng.uniform(-1, 1, nS).astype(np.float32))


def _same(a, b):
    (fa, (sa, ca), ta), (fb, (sb, cb), tb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert torch.equal(sa, sb) and torch.equal(ca, cb)
    assert [int(x) for x in ta] == [int(x) for x in tb]


@pytest.mark.parametrize("board,B,T,seed", [
    ((5, 4), 1024, 16, 3),
    ((11, 7), 256, 4, 5),
], ids=["5x4", "11x7"])
def test_two_stages_equal_the_plain_version_and_jax(board, B, T, seed):
    """The producers' codes then the consumers' steps equal the plain
    version bit for bit, and the JAX kernel in interpret mode fed the same
    table and state."""
    jcfg, cfg = JaxConfig(*board, 0.2), EnvConfig(*board, 0.2)
    pa, pb, v = _tables(cfg, seed)
    m = jax_pack(jcfg, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(v), 0.2)
    jfields0 = jlk.init_state_fields(jcfg, B)
    jfields, jacc, jstats = jlk.packed_learner_chunk(
        jcfg, seed, m, jfields0, B, T, interpret=True)
    jres, jcnt = (np.asarray(a) for a in jlk.unpack_acc2(jcfg, jacc))
    table = interop.table_from_packed_m(cfg, np.asarray(m, np.float32), "cpu")
    fields0 = interop.planes_from_tiles(jfields0, "cpu")
    got = lc.chunk_twin(cfg, seed, table, fields0, T, 0.99)
    _same(got, lk.packed_learner_chunk_plain(cfg, seed, table, fields0, B, T))
    for a, b in zip(interop.planes_to_tiles(got[0]), jfields):
        assert np.array_equal(a, np.asarray(b))
    assert [int(x) for x in got[2][:3]] == [int(x) for x in jstats]
    res, cnt = (a.numpy() for a in lk.unpack_acc2(cfg, got[1]))
    assert np.array_equal(cnt, jcnt) and int(cnt.sum()) == B * T
    max_delta = 1 + 2 * float(table[:, lk.COL_V].abs().max())
    assert (np.abs(res - jres) <= cnt * (2.0 ** -8 * max_delta + 1e-6)).all()


def test_goal_states_and_late_truncations_equal_the_plain_version():
    """Lanes that start in goal states (where the learners' tables still
    have rows) or a few steps before truncation: the chunk equals the
    plain version."""
    cfg = EnvConfig(5, 4, 0.2)
    B = 1024
    table = lk.pack_m2(cfg, *(torch.as_tensor(x) for x in _tables(cfg, 1)),
                       0.2)
    ra, ca, rb, cb, p, t = (f.clone() for f in
                            lk.init_state_fields(cfg, B, "cpu"))
    ca[5::97], ra[5::97], p[5::97] = cfg.W - 1, 1, 0
    rb[40::131], cb[40::131], p[40::131] = 1, cfg.W - 1, 1
    t[::3] = cfg.max_steps - 3
    fields = (ra, ca, rb, cb, p, t)
    assert not rc.walkable(cfg, ra, ca, rb, cb, p).all()
    _same(lc.chunk_twin(cfg, 4, table, fields, 12, 0.9),
          lk.packed_learner_chunk_plain(cfg, 4, table, fields, B, 12, 0.9))


def test_prepared_rows_sample_as_sample5():
    """The prepared rows' running sums pick the actions ``_sample5`` picks
    for random 16-bit uniforms, on rows with zeros and ties; a row's v is
    the table's and its cell the code times 25."""
    cfg = EnvConfig(5, 4, 0.2)
    table = lk.pack_m2(cfg, *(torch.as_tensor(x) for x in _tables(cfg, 2)),
                       0.2)
    table[:40, :5] = torch.tensor([0.0, 0.25, 0.25, 0.0, 0.5])
    n = lk.n_codes(cfg)
    rows = lc.prepare_rows(table)
    assert rows.shape == (n, lc.ROW_FLOATS) and rows.dtype == torch.float32
    code = torch.arange(n).repeat_interleave(64)
    u = torch.randint(0, 65536, (len(code),), generator=torch.Generator()
                      .manual_seed(0))
    word = (u | (u.flip(0) << 16)).long()
    aa, ab = lc._sample(rows[code], word)
    inv = 1.0 / 65536.0
    assert torch.equal(aa.int(), lk._sample5(table[code, :5],
                                             (word & 0xFFFF).float() * inv))
    assert torch.equal(ab.int(), lk._sample5(table[code, 5:10],
                                             (word >> 16).float() * inv))
    assert torch.equal(rows[:, 10], table[:, lk.COL_V])
    assert torch.equal(rows[:, 11].view(torch.int32),
                       torch.arange(n, dtype=torch.int32) * lk.NJ)


def test_rows_fit_shared_memory_on_5x4():
    """5x4's prepared rows (1104 x 48 B) fit one block's shared memory
    beside the ring of up to 512 lanes; 11x7's 13612 rows do not and are
    read from L2."""
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    assert lc.shared_rows(c54) and not lc.shared_rows(c117)
    assert lc.smem_bytes(64, 1104) == 96 + 52992 + 5120
    assert lc.smem_bytes(512, 1104) == 96 + 52992 + 40960 <= lc.SMEM_BUDGET
    assert lc.smem_bytes(512, 13612) > lc.SMEM_BUDGET
    assert lc.smem_bytes(512, 0) == 96 + 40960


def test_layout_of_the_one_allocation():
    """The sums, the stats and the counts lie together at the front (one
    memset), the planes and the rows 16-B aligned after them."""
    for n, B in ((1104, 8192), (13612, 65536), (8, 128)):
        lay = lc.layout(n, B)
        assert lay.sums == 0 and lay.stats == 8 * 25 * n
        assert lay.cnt == lay.stats + 32 and lay.zero == lay.cnt + 4 * 25 * n
        assert lay.fields % 16 == 0 and lay.fields >= lay.zero
        assert lay.rows % 16 == 0 and lay.rows >= lay.fields + 24 * B
        assert lay.total == lay.rows + 48 * n and lay.total % 8 == 0


@pytest.mark.parametrize("q_int", [0, 13107, 32768, 65535])
def test_class_move_is_the_effective_move(q_int):
    """The slip class and ``class_move`` name the effective move
    ``rollout_codes.effective_move`` names, for every action and u16."""
    a = torch.arange(5).repeat_interleave(65536)
    u = torch.arange(65536).repeat(5)
    assert torch.equal(lc.class_move(lc.slip_class(u, q_int), a),
                       rc.effective_move(a, u, q_int))


def test_lanes_per_block():
    """``threads`` is K5's lanes per block: by default the fewest multiples
    of 32 that keep the grid to one wave of 132 blocks, any multiple of 32
    up to 512, anything else refused with a ValueError on any device
    before a launch; it does not change the CPU result."""
    cfg = EnvConfig(5, 4, 0.2)
    assert [lc.default_lanes(b) for b in (128, 4224, 8192, 65536, 2 ** 22)] \
        == [32, 32, 64, 512, 512]
    for lanes in (32, 96, 480, 512):
        assert lc.check_lanes(8192, lanes) == lanes
    assert lc.check_lanes(65536, None) == 512
    table = torch.zeros((lk.n_codes(cfg), lk.TABLE_COLS))
    fields = lk.init_state_fields(cfg, 256, "cpu")
    for bad in (0, 48, 544, 1024, 64.0):
        with pytest.raises(ValueError, match="lanes per block"):
            lc.check_lanes(8192, bad)
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="lanes per block"):
                lk.packed_learner_chunk(cfg, 0, table.to(dev),
                                        [f.to(dev) for f in fields], 256, 4,
                                        threads=bad)
    table = lk.pack_m2(cfg, *(torch.as_tensor(x) for x in _tables(cfg, 4)),
                       0.2)
    _same(lk.packed_learner_chunk(cfg, 2, table, fields, 256, 4, threads=32),
          lk.packed_learner_chunk(cfg, 2, table, fields, 256, 4))


@pytest.mark.parametrize("name", sorted(learner_variants.VARIANTS))
def test_learner_variants_patch_the_committed_kernel(name):
    """Each timed variant of K5 (ops/learner_variants.py) applies its
    patches, each to exactly one place in the committed source, and
    changes it unless it is the kernel itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "learner_kernel.cu").read_text()
    got = learner_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in learner_variants.VARIANTS[name][0]:
        assert new in got
    with pytest.raises(ValueError, match="matches 0 times"):
        learner_variants.variant_source("rows-in-l2", "no kernel here")


# ----------------------------------------------------------------------
# K7 (both sites): the unpacked chunk's two stages
# ----------------------------------------------------------------------

MIX3 = ((5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3))   # tools/bench_all.py:421
jax_pack_m = jax.jit(jlk.pack_m, static_argnums=(0,))


def _k7_cfg(boards):
    """(JAX config, port config): one board, or a mixture's tuples."""
    if len(boards) == 1:
        return JaxConfig(*boards[0]), EnvConfig(*boards[0])
    return (tuple(JaxConfig(*b) for b in boards),
            tuple(EnvConfig(*b) for b in boards))


def _k7_tables(cfg, seed, bad=None):
    """The unpacked and the packed table of random policies, v and q in
    [-1, 1] (``bad`` added to every third state's q), as numpy and as
    the port's tables."""
    nS = lk.n_states(cfg)
    rng = np.random.default_rng(seed)
    pa, pb = (rng.dirichlet(np.ones(5), nS).astype(np.float32)
              for _ in range(2))
    v = rng.uniform(-1, 1, nS).astype(np.float32)
    q = rng.uniform(-1, 1, (nS, 5, 5)).astype(np.float32)
    if bad is not None:
        q[::3] += np.float32(bad)
    t = [torch.as_tensor(x) for x in (pa, pb, q, v)]
    return ((pa, pb, q, v), lk.pack_m(cfg, *t, 0.2),
            lk.pack_m2(cfg, t[0], t[1], t[3], 0.2))


def _k7_twin(cfg, seed, table, state, T):
    if isinstance(cfg, tuple):
        planes, fields = state
        return lc.chunk_twin(cfg, seed, table, fields, T, 0.99, planes)
    return lc.chunk_twin(cfg, seed, table, state, T, 0.99)


def _k7_plain(cfg, seed, table, state, B, T):
    if isinstance(cfg, tuple):
        return lk.multigrid_learner_chunk_plain(cfg, seed, table, *state, B, T)
    return lk.learner_chunk_plain(cfg, seed, table, state, B, T)


@pytest.mark.parametrize("boards,B,T,seed", [
    (((5, 4, 0.2),), 1024, 12, 3),
    (((11, 7, 0.2),), 256, 4, 5),
    (MIX3, 512, 8, 6),
], ids=["5x4", "11x7", "mixture"])
def test_k7_two_stages_equal_the_plain_versions_and_jax(boards, B, T, seed):
    """K7's codes then steps (the 36-column table's prepared rows, q(s, a)
    read after the sample) equal ``learner_chunk_plain`` /
    ``multigrid_learner_chunk_plain`` bit for bit (fields, stats, counts,
    int64 sums, out-of-range count), and JAX's ``learner_chunk`` /
    ``multigrid_learner_chunk`` in interpret mode fed the same table and
    state: fields, stats and counts exactly, the TD sums within cnt *
    (2**-8 * max|delta| + 1e-6), max|delta| <= 1 + 2 * max(|v|, |q|)
    (ROADMAP Queue 3: JAX rounds each TD to bfloat16 and reads v, q as
    double bfloat16)."""
    jc, cfg = _k7_cfg(boards)
    arrays, table, _ = _k7_tables(cfg, seed)
    m = jax_pack_m(jc, *(jnp.asarray(x) for x in arrays), 0.2)
    table = interop.table_from_m(cfg, np.asarray(m, np.float32), "cpu")
    if isinstance(cfg, tuple):
        jplanes, jfields0 = jlk.init_state_fields(jc, B)
        jfields, jacc, jstats = jlk.multigrid_learner_chunk(
            jc, seed, m, jplanes, jfields0, B, T, interpret=True)
        state = lk.init_state_fields(cfg, B, "cpu")
    else:
        jfields0 = jlk.init_state_fields(jc, B)
        jfields, jacc, jstats = jlk.learner_chunk(
            jc, seed, m, jfields0, B, T, interpret=True)
        state = interop.planes_from_tiles(jfields0, "cpu")
    got = _k7_twin(cfg, seed, table, state, T)
    _same(got, _k7_plain(cfg, seed, table, state, B, T))
    for a, b in zip(interop.planes_to_tiles(got[0]), jfields):
        assert np.array_equal(a, np.asarray(b))
    assert [int(x) for x in got[2][:3]] == [int(x) for x in jstats]
    assert int(got[2][3]) == 0
    td, cnt = (a.numpy() for a in lk.unpack_acc(cfg, got[1]))
    jtd, jcnt = (np.asarray(a) for a in jlk.unpack_acc(jc, jacc))
    assert np.array_equal(cnt, jcnt) and int(cnt.sum()) == B * T
    max_delta = 1 + 2 * float(table[:, lk.COL_V:].abs().max())
    assert (np.abs(td - jtd) <= cnt * (2.0 ** -8 * max_delta + 1e-6)).all()


@pytest.mark.parametrize("boards", [((5, 4, 0.2),), MIX3],
                         ids=["5x4", "mixture"])
def test_k7_goal_states_and_late_truncations_equal_the_plain_version(boards):
    """K7's two stages from lanes in goal states (where the tables still
    have rows) or a few steps before truncation, on one board and on each
    board of a mixture: equal to the plain version."""
    _, cfg = _k7_cfg(boards)
    B = 1024
    _, table, _ = _k7_tables(cfg, 1)
    state = lk.init_state_fields(cfg, B, "cpu")
    planes, fields = state if isinstance(cfg, tuple) else (None, state)
    ra, ca, rb, cb, p, t = (f.clone() for f in fields)
    W = planes[1] if planes is not None else torch.full_like(ra, cfg.W)
    glo = (planes[2] if planes is not None
           else torch.full_like(ra, cfg.goal_row_bounds[0]))
    ca[5::97], ra[5::97], p[5::97] = W[5::97] - 1, glo[5::97], 0
    rb[40::131], cb[40::131], p[40::131] = glo[40::131], W[40::131] - 1, 1
    t[::3] = 100 - 3
    fields = (ra, ca, rb, cb, p, t)
    state = fields if planes is None else (planes, fields)
    got = _k7_twin(cfg, 4, table, state, 12)
    want = _k7_plain(cfg, 4, table, state, B, 12)
    _same(got, want)
    assert int(want[2][2]) > 0


@pytest.mark.parametrize("boards", [((5, 4, 0.2),), MIX3],
                         ids=["5x4", "mixture"])
@pytest.mark.parametrize("bad", [float("nan"), 1e7])
def test_k7_counts_values_out_of_range_as_the_plain_version(boards, bad):
    """Tables whose q holds nan or 1e7: K7's two stages count the values
    read outside +-value_limit as the plain version does (the q(s, a) of
    each visit, tested at its retirement), and leave the sums and counts
    equal."""
    _, cfg = _k7_cfg(boards)
    B, T = 256, 16
    _, table, _ = _k7_tables(cfg, 2, bad)
    state = lk.init_state_fields(cfg, B, "cpu")
    got = _k7_twin(cfg, 5, table, state, T)
    want = _k7_plain(cfg, 5, table, state, B, T)
    assert int(want[2][3]) > 0
    assert int(got[2][3]) == int(want[2][3])
    assert torch.equal(got[1][1], want[1][1])
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))


def test_prepared_rows_of_the_unpacked_table():
    """The prep pass reads K7's 36-column table into the rows it makes of
    K5's 11-column one for the same pi and v: the same 48-B rows."""
    cfg = EnvConfig(5, 4, 0.2)
    _, table, packed = _k7_tables(cfg, 7)
    assert table.shape[1] == lk.TABLE_COLS_UNPACKED
    assert torch.equal(lc.prepare_rows(table), lc.prepare_rows(packed))


def test_k7_lanes_per_block_and_shared_memory():
    """K7's ``threads`` is lanes per block at both sites, as K5's: by
    default one wave, any multiple of 32 up to 512, anything else refused
    with a ValueError on any device before a launch; a mixture's block
    keeps a 16-B slip entry a lane beside the ring, its rows in L2 (8,928
    codes on the 3-board mixture) and a one-board mixture's in shared
    memory."""
    c54 = EnvConfig(5, 4, 0.2)
    mix = tuple(EnvConfig(*b) for b in MIX3)
    assert lc.smem_bytes(64, 0, multi=True) == 96 + 5120 + 1024
    assert lc.smem_bytes(512, 1104, multi=True) <= lc.SMEM_BUDGET
    assert not lc.shared_rows(mix) and lk.n_codes(mix) == 8928
    assert lc.shared_rows((c54,)) and lc.shared_rows(c54)
    for cfg in (c54, mix):
        _, table, _ = _k7_tables(cfg, 4)
        state = lk.init_state_fields(cfg, 256, "cpu")
        for bad in (0, 48, 544, 1024, 64.0):
            for dev in ("cpu", "meta"):
                moved = (lambda x: x.to(dev) if hasattr(x, "to")
                         else type(x)(moved(y) for y in x))
                with pytest.raises(ValueError, match="lanes per block"):
                    if isinstance(cfg, tuple):
                        lk.multigrid_learner_chunk(
                            cfg, 0, table.to(dev), *moved(state), 256, 4,
                            threads=bad)
                    else:
                        lk.learner_chunk(cfg, 0, table.to(dev), moved(state),
                                         256, 4, threads=bad)
        got = (lk.multigrid_learner_chunk(cfg, 2, table, *state, 256, 4,
                                          threads=32)
               if isinstance(cfg, tuple) else
               lk.learner_chunk(cfg, 2, table, state, 256, 4, threads=32))
        _same(got, _k7_plain(cfg, 2, table, state, 256, 4))


@pytest.mark.parametrize("name", sorted(learner_variants.K7_VARIANTS))
def test_k7_variants_patch_the_committed_kernel(name):
    """Each timed variant of K7 applies its patches, each to exactly one
    place in the committed source, and changes it unless it is the kernel
    itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "learner_kernel.cu").read_text()
    got = learner_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in learner_variants.K7_VARIANTS[name][0]:
        assert new in got


# ----------------------------------------------------------------------
# K6: the packed chunk over a mixture, K7 multigrid's split on the packed
# table
# ----------------------------------------------------------------------

MIX_BIG = ((5, 4, 0.2), (11, 7, 0.2))     # examples/train_minimax_tpu.py:141
MG_BOARDS = ((5, 4, 0.2), (6, 5, 0.2))    # its --multigrid recipe


@pytest.mark.parametrize("boards,B,T,seed", [
    (MIX3, 512, 8, 6),
    (MG_BOARDS, 512, 8, 9),
], ids=["mixture", "5x4+6x5"])
def test_k6_two_stages_equal_the_plain_version_and_jax(boards, B, T, seed):
    """K6's codes then steps (the packed table's prepared rows, each lane on
    its own board, the baseline v(s) from the row) equal
    ``multigrid_packed_learner_chunk_plain`` bit for bit (fields, stats,
    counts, int64 sums, out-of-range count), and JAX's
    ``multigrid_packed_learner_chunk`` in interpret mode fed the same table
    and state: fields, stats and counts exactly, the residual sums within
    cnt * (2**-8 * max|delta| + 1e-6), max|delta| <= 1 + 2 * max|v| (JAX
    rounds each residual to bfloat16 and reads v as double bfloat16)."""
    jc, cfg = _k7_cfg(boards)
    (pa, pb, _, v), _, _ = _k7_tables(cfg, seed)
    m = jax_pack(jc, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(v), 0.2)
    table = interop.table_from_packed_m(cfg, np.asarray(m, np.float32), "cpu")
    jplanes, jfields0 = jlk.init_state_fields(jc, B)
    jfields, jacc, jstats = jlk.multigrid_packed_learner_chunk(
        jc, seed, m, jplanes, jfields0, B, T, interpret=True)
    planes, fields0 = lk.init_state_fields(cfg, B, "cpu")
    got = lc.chunk_twin(cfg, seed, table, fields0, T, 0.99, planes)
    _same(got, lk.multigrid_packed_learner_chunk_plain(
        cfg, seed, table, planes, fields0, B, T))
    for a, b in zip(interop.planes_to_tiles(got[0]), jfields):
        assert np.array_equal(a, np.asarray(b))
    assert [int(x) for x in got[2][:3]] == [int(x) for x in jstats]
    assert int(got[2][3]) == 0
    res, cnt = (a.numpy() for a in lk.unpack_acc2(cfg, got[1]))
    jres, jcnt = (np.asarray(a) for a in jlk.unpack_acc2(jc, jacc))
    assert np.array_equal(cnt, jcnt) and int(cnt.sum()) == B * T
    max_delta = 1 + 2 * float(table[:, lk.COL_V].abs().max())
    assert (np.abs(res - jres) <= cnt * (2.0 ** -8 * max_delta + 1e-6)).all()


@pytest.mark.parametrize("bad", [float("nan"), 1e7])
def test_k6_counts_values_out_of_range_as_the_plain_version(bad):
    """A packed mixture table whose v holds nan or 1e7 on every third
    state: K6's two stages count the v values read outside +-value_limit
    as the plain version does, and leave the fields and counts equal."""
    _, cfg = _k7_cfg(MG_BOARDS)
    B, T = 256, 16
    (pa, pb, _, v), _, _ = _k7_tables(cfg, 2)
    v[::3] += np.float32(bad)
    table = lk.pack_m2(cfg, *(torch.as_tensor(x) for x in (pa, pb, v)), 0.2)
    planes, fields = lk.init_state_fields(cfg, B, "cpu")
    got = lc.chunk_twin(cfg, 5, table, fields, T, 0.99, planes)
    want = lk.multigrid_packed_learner_chunk_plain(cfg, 5, table, planes,
                                                  fields, B, T)
    assert int(want[2][3]) > 0
    assert int(got[2][3]) == int(want[2][3])
    assert torch.equal(got[1][1], want[1][1])
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))


def test_k6_rows_in_shared_memory_on_the_recipes_mixture():
    """A packed mixture's prepared rows go to shared memory where they fit
    beside the widest block's ring and its lanes' slip entries: the
    --multigrid recipe's 5x4+6x5 (3,624 codes, 223,200 B at 512 lanes) and
    a one-board mixture do; the 3-board mixture (8,928 codes) and 5x4+11x7
    (14,720) read them from L2."""
    recipe, mix, big = (_k7_cfg(b)[1] for b in (MG_BOARDS, MIX3, MIX_BIG))
    assert lk.n_codes(recipe) == 3624
    assert lc.smem_bytes(512, 3624, multi=True) == 223200 <= lc.SMEM_BUDGET
    assert lc.shared_rows(recipe) and lc.shared_rows((EnvConfig(5, 4, 0.2),))
    assert (lk.n_codes(mix), lk.n_codes(big)) == (8928, 14720)
    assert not lc.shared_rows(mix) and not lc.shared_rows(big)
    assert lc.smem_bytes(512, 8928, multi=True) > lc.SMEM_BUDGET
    # the recipe's 16384 lanes take the one-wave default of 128 a block
    assert lc.default_lanes(16384) == 128
    assert lc.smem_bytes(128, 3624, multi=True) == 96 + 173952 + 10240 + 2048


def test_k6_lanes_per_block():
    """``multigrid_packed_learner_chunk``'s ``threads`` is lanes per block,
    as ``packed_learner_chunk``'s: by default one wave, any multiple of 32
    up to 512, anything else refused with a ValueError on any device before
    a launch; it does not change the CPU result."""
    _, cfg = _k7_cfg(MG_BOARDS)
    (pa, pb, _, v), _, _ = _k7_tables(cfg, 4)
    table = lk.pack_m2(cfg, *(torch.as_tensor(x) for x in (pa, pb, v)), 0.2)
    planes, fields = lk.init_state_fields(cfg, 256, "cpu")
    for bad in (0, 48, 128 + 16, 544, 1024, 64.0):
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="lanes per block"):
                lk.multigrid_packed_learner_chunk(
                    cfg, 0, table.to(dev), [p.to(dev) for p in planes],
                    [f.to(dev) for f in fields], 256, 4, threads=bad)
    want = lk.multigrid_packed_learner_chunk_plain(cfg, 2, table, planes,
                                                  fields, 256, 4)
    for lanes in (None, 32, 96, 512):
        _same(lk.multigrid_packed_learner_chunk(cfg, 2, table, planes,
                                                fields, 256, 4,
                                                threads=lanes), want)


def test_mixture_wrappers_check_new_planes_and_remember_checked_ones():
    """The mixture wrappers check a mixture's planes once and remember the
    six tensors they checked: the same planes pass unchecked, while new
    planes, the same planes changed in place, or another batch or device
    are checked again and refused when bad."""
    _, cfg = _k7_cfg(MG_BOARDS)
    (pa, pb, _, v), _, _ = _k7_tables(cfg, 4)
    table = lk.pack_m2(cfg, *(torch.as_tensor(x) for x in (pa, pb, v)), 0.2)
    planes, fields = lk.init_state_fields(cfg, 256, "cpu")
    want = lk.multigrid_packed_learner_chunk(cfg, 2, table, planes, fields,
                                             256, 4)
    assert all(a is b for a, b in zip(lk._seen["planes"][0], planes))
    _same(lk.multigrid_packed_learner_chunk(cfg, 2, table, planes, fields,
                                            256, 4), want)
    bad = list(planes)
    bad[2] = bad[2].long()
    with pytest.raises(ValueError, match="planes must be contiguous int32"):
        lk.multigrid_packed_learner_chunk(cfg, 2, table, bad, fields, 256, 4)
    moved = [p.clone() for p in planes]
    moved[0].resize_(128)
    with pytest.raises(ValueError, match="planes must be contiguous int32"):
        lk.multigrid_packed_learner_chunk(cfg, 2, table, moved, fields, 256,
                                          4)
    lk.multigrid_packed_learner_chunk(cfg, 2, table, planes, fields, 256, 4)
    planes[0].resize_(128)
    try:
        with pytest.raises(ValueError, match="planes must be contiguous"):
            lk.multigrid_learner_chunk(cfg, 2, lk.pack_m(
                cfg, *(torch.as_tensor(x) for x in (pa, pb)),
                torch.zeros(lk.n_states(cfg), 5, 5), torch.as_tensor(v),
                0.2), planes, fields, 256, 4)
    finally:
        planes[0].resize_(256)
    with pytest.raises(ValueError, match=r"\[128\]"):
        lk.multigrid_packed_learner_chunk(cfg, 2, table, planes,
                                          [f[:128] for f in fields], 128, 4)
    with pytest.raises(ValueError, match="planes = 6 tensors"):
        lk.multigrid_packed_learner_chunk(cfg, 2, table, planes[:5], fields,
                                          256, 4)
    with torch.inference_mode():   # planes that keep no version counter
        iplanes = tuple(p.clone() for p in planes)
        for _ in range(2):
            _same(lk.multigrid_packed_learner_chunk(cfg, 2, table, iplanes,
                                                    fields, 256, 4), want)
        iplanes[1].resize_(128)
        with pytest.raises(ValueError, match="planes must be contiguous"):
            lk.multigrid_packed_learner_chunk(cfg, 2, table, iplanes, fields,
                                              256, 4)


@pytest.mark.parametrize("name", sorted(learner_variants.K6_VARIANTS))
def test_k6_variants_patch_the_committed_kernel(name):
    """Each timed variant of K6 (ops/learner_variants.py: the previous
    design, the rows in L2) applies its patches, each to exactly one place
    in the committed source, and changes it unless it is the kernel."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "learner_kernel.cu").read_text()
    got = learner_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in learner_variants.K6_VARIANTS[name][0]:
        assert new in got
