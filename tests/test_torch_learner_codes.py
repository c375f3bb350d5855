"""The two stages of the K5 learner kernel (gym_soccer_tpu_torch.ops.
learner_codes) on the CPU: the producers' words and side bytes, then the
consumers' steps on the prepared rows, held to
``packed_learner_chunk_plain`` bit for bit (fields, stats, visit counts and
the int64 sums) and to the JAX package's ``packed_learner_chunk`` in
interpret mode (fields, stats and counts exactly; the sums within the bf16
tolerance of ``tests/test_torch_learner_kernel.py``, since JAX rounds each
visit to bfloat16); the prepared rows, their shared memory, the layout of
the one allocation and the lanes per block."""
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
