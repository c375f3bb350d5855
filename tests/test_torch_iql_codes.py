"""The two stages of the K8/K9 independent-Q kernels (gym_soccer_tpu_torch.
ops.iql_codes) on the CPU: the producers' step codes, then the consumers'
steps on the prep pass's rows, held to ``iql_packed_chunk_plain`` /
``iql_chunk_plain`` bit for bit (fields, stats with the out-of-range
count, visit counts and the int64 sums) and to the JAX package's
``iql_packed_chunk`` / ``iql_chunk`` in interpret mode (fields, stats and
counts exactly; the sums per cell within cnt * (2**-8 * max|delta| +
1e-6), the tolerance of ``tests/test_torch_iql_kernel.py``, since JAX
rounds each value to bfloat16 before its scatter-add); the prepared rows
at near-ties, their shared memory, the layout of the one allocation, the
lanes per block and the variants' patches."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import iql_kernel as jik
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import rules
from gym_soccer_tpu_torch.ops import iql_codes as qc
from gym_soccer_tpu_torch.ops import iql_kernel as ik
from gym_soccer_tpu_torch.ops import iql_variants
from gym_soccer_tpu_torch.ops import rollout_codes as rc

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

EPS = int(round(0.3 * 65536))
KERNELS = {"K8": (True, ik.iql_packed_chunk_plain),
           "K9": (False, ik.iql_chunk_plain)}


def _q(cfg, seed):
    """(q_a, q_b) float32 numpy [nS, 5], uniform in [-1, 1]."""
    nS = len(ik.lk._cell_rows(cfg))
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (nS, 5)).astype(np.float32),
            rng.uniform(-1, 1, (nS, 5)).astype(np.float32))


def _table(cfg, seed):
    return ik.pack_iql_table(cfg, *(torch.as_tensor(q) for q in _q(cfg, seed)))


def _same(a, b):
    (fa, (sa, ca), ta), (fb, (sb, cb), tb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert torch.equal(sa, sb) and torch.equal(ca, cb)
    assert [int(x) for x in ta] == [int(x) for x in tb]


def _both(kernel, cfg, seed, eps_int, table, fields, T, off, gamma=0.99):
    """(the twin's chunk, the plain version's) of K8 or K9."""
    packed, plain = KERNELS[kernel]
    B = fields[0].shape[0]
    return (qc.chunk_twin(cfg, seed, eps_int, table, fields, T, gamma, off,
                          packed),
            plain(cfg, seed, eps_int, table, fields, B, T, gamma, off))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("board,B,T,seed,off", [
    ((5, 4), 512, 12, 3, 0),
    ((5, 4), 256, 10, 4, 37),
    ((11, 7), 256, 8, 5, 0),
    ((11, 7), 256, 6, 6, 37),
], ids=["5x4", "5x4-offset", "11x7", "11x7-offset"])
def test_two_stages_equal_the_plain_version(kernel, board, B, T, seed, off):
    """The producers' codes then the consumers' steps equal the plain
    version bit for bit, from step 0 and from a later chunk's step 37."""
    cfg = EnvConfig(*board, 0.2)
    got, want = _both(kernel, cfg, seed, EPS, _table(cfg, seed),
                      ik.init_iql_state_fields(cfg, B, "cpu"), T, off)
    _same(got, want)
    assert int(got[1][1].sum()) == 2 * B * T


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("board,B,T,seed,off", [
    ((5, 4), 512, 8, 3, 0),
    ((11, 7), 256, 4, 5, 8),
], ids=["5x4", "11x7"])
def test_two_stages_equal_jax(kernel, board, B, T, seed, off):
    """The twin equals the JAX kernel in interpret mode fed the same
    double-bf16 table and state: fields, stats and counts exactly, the
    sums within cnt * (2**-8 * max|delta| + 1e-6)."""
    packed = KERNELS[kernel][0]
    jcfg, cfg = JaxConfig(*board, 0.2), EnvConfig(*board, 0.2)
    qa, qb = _q(cfg, seed)
    pack, chunk, unpack = ((jik.pack_iql_m2, jik.iql_packed_chunk,
                            jik.unpack_iql_acc2) if packed else
                           (jik.pack_iql_m, jik.iql_chunk, jik.unpack_iql_acc))
    m = pack(jcfg, jnp.asarray(qa), jnp.asarray(qb))
    jfields0 = jik.init_iql_state_fields(jcfg, B)
    jf, jacc, jst = chunk(jcfg, seed, EPS, m, jfields0, B, T,
                          step_offset=off, interpret=True)
    table = interop.iql_table_from_packed_m(cfg, np.asarray(m, np.float32),
                                            packed, "cpu")
    f, acc, st = qc.chunk_twin(cfg, seed, EPS, table,
                               interop.planes_from_tiles(jfields0, "cpu"), T,
                               0.99, off, packed)
    for a, b in zip(interop.planes_to_tiles(f), jf):
        assert np.array_equal(a, np.asarray(b))
    assert [int(x) for x in st] == [int(x) for x in jst] + [0]
    ours = [a.numpy() for a in ik.unpack_iql_acc(cfg, acc)]
    theirs = [np.asarray(a) for a in unpack(jcfg, jacc)]
    max_delta = 1 + 1.99 * float(table.abs().max())
    for k in (0, 2):   # A's and B's sums, then counts
        c = ours[k + 1]
        assert np.array_equal(c, theirs[k + 1]) and int(c.sum()) == B * T
        tol = c * (2.0 ** -8 * max_delta + 1e-6)
        assert (np.abs(ours[k] - theirs[k]) <= tol).all()


@pytest.mark.parametrize("eps_int", [0, ik.EPS_ONE], ids=["greedy", "explore"])
def test_eps_edges(eps_int):
    """eps_int 0: every choice is the greedy marker; 65536: none is, each
    an action 0-4.  The slip classes, coin bits and ISD index are the
    words' in both; the twin equals the plain versions."""
    cfg = EnvConfig(5, 4, 0.2)
    lanes = torch.arange(1024)
    codes = qc.iql_codes(cfg, 11, eps_int, lanes, 6, 5).long()
    xa, xb = codes & 7, (codes >> 3) & 7
    if eps_int == 0:
        assert bool((xa == qc.GREEDY).all() & (xb == qc.GREEDY).all())
    else:
        assert int(xa.max()) <= 4 and int(xb.max()) <= 4
        assert len(xa.unique()) == 5 and len(xb.unique()) == 5
    b1, b2 = (ik.sk._random_word(11, 7, w, lanes) for w in (1, 2))
    q_int = ik.sk._q_int(cfg)
    assert torch.equal((codes[2] >> 6) & 3,
                       qc.lc.slip_class(ik.sk._u16(b1, 0), q_int))
    assert torch.equal((codes[2] >> 8) & 3,
                       qc.lc.slip_class(ik.sk._u16(b1, 1), q_int))
    assert torch.equal((codes[2] >> 10) & 3, b2 & 3)
    assert torch.equal(codes[2] >> 12, (ik.sk._u16(b2, 1) % 4).long())
    B = 512
    fields = ik.init_iql_state_fields(cfg, B, "cpu")
    for kernel in KERNELS:
        _same(*_both(kernel, cfg, 2, eps_int, _table(cfg, 2), fields, 8, 3))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_goal_states_and_late_truncations_equal_the_plain_version(kernel):
    """Lanes that start in goal states (where the tables still have rows)
    or a few steps before truncation: the chunk equals the plain version.
    The players are greedy (eps 0), and action 0 is greedy in the goal
    states, so no player steps off the board from one: the carrier stays
    in the goal and the lane scores and resets."""
    cfg = EnvConfig(5, 4, 0.2)
    B = 1024
    ra, ca, rb, cb, p, t = (f.clone() for f in
                            ik.init_iql_state_fields(cfg, B, "cpu"))
    lo = cfg.goal_row_bounds[0]
    ca[5::97], ra[5::97], p[5::97] = cfg.W - 1, lo, 0
    rb[40::131], cb[40::131], p[40::131] = lo, 0, 1
    t[::3] = cfg.max_steps - 3
    fields = (ra, ca, rb, cb, p, t)
    assert not rc.walkable(cfg, ra, ca, rb, cb, p).all()
    table = _table(cfg, 1)
    goal = rules.cellpair_encode(torch, ra, ca, rb, cb, p, cfg).long()[
        torch.cat([torch.arange(5, B, 97), torch.arange(40, B, 131)])]
    table[goal, 0] = table[goal, 5] = 2.0
    got, want = _both(kernel, cfg, 4, 0, table, fields, 12, 21, gamma=0.9)
    _same(got, want)
    assert int(want[2][1]) >= len(goal) and int(want[2][2]) > 0


def test_prepared_rows_are_the_strict_scan_at_near_ties():
    """The prep pass's greedy actions and maxes equal the plain version's
    strict ``>`` scan and the first maximum, on double-bf16 values of
    which neighbours one float32 step apart round to ties, and on exact
    ties; the lowest index wins a tie."""
    cfg = EnvConfig(5, 4, 0.2)
    n = ik.n_codes(cfg)
    rng = np.random.default_rng(11)
    y = torch.tensor(rng.uniform(-0.9, 0.9, (n, 10)), dtype=torch.float32)
    near = torch.nextafter(y, torch.tensor(2.0))
    y[::2, 3] = near[::2, 1]            # a near-tie after the max's index
    y[1::4, 7] = y[1::4, 6]             # an exact tie
    y[::3, 0] = y[::3, 4] = 0.95        # a tie of the max, far apart
    table = ik.double_bf16(y)
    assert bool((table[::2, 3] == table[::2, 1]).float().mean() > 0.5)
    vals, greedy = qc.prepare_rows(table)
    assert vals.shape == (n, 2) and vals.dtype == torch.float32
    for col, k in ((0, 0), (1, 5)):
        want_a, want_v = ik._greedy(table[:, k:k + 5])
        g = (greedy >> (3 * col)) & 7
        assert torch.equal(g.long(), want_a)
        assert torch.equal(vals[:, col], want_v)
        assert torch.equal(g.long(), torch.as_tensor(
            table[:, k:k + 5].numpy().argmax(1)))
    assert bool((greedy[::3] & 7 == 0).all())


def test_rows_fit_shared_memory_at_the_widest_block():
    """Both boards' prepared rows (9 B a code: 1104 and 13612 codes) fit
    one block's shared memory beside the ring of 512 lanes; 5x4's private
    accumulators (1104 x 10 cells of 16 B) fit beside them, 11x7's do
    not."""
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    assert qc.shared_rows(c54) and qc.shared_rows(c117)
    n54, n117 = ik.n_codes(c54), ik.n_codes(c117)
    assert (n54, n117) == (1104, 13612)
    assert qc.row_bytes(n54) == 9936 and qc.row_bytes(n117) == 122512
    assert qc.ring_bytes(512) == 16384 and qc.ring_bytes(64) == 2048
    assert qc.smem_bytes(64, n54) == 96 + 9936 + 2048
    assert qc.smem_bytes(512, n117) == 96 + 122512 + 16384 <= qc.SMEM_BUDGET
    assert qc.smem_bytes(512, n54, n54) == 96 + 9936 + 16384 + 176640
    assert qc.smem_bytes(512, n54, n54) <= qc.SMEM_BUDGET
    assert qc.smem_bytes(32, n117, n117) > qc.SMEM_BUDGET
    assert qc.smem_bytes(512, 0) == 96 + 16384


def test_private_accumulators_where_they_fit_and_stay_exact():
    """Each block keeps its own accumulators in shared memory on 5x4 while
    it adds at most 2**16 values to a cell (lanes x steps: 64 x 64 at 8192
    x 64, 512 x 32 at 65536 x 32), past that and on 11x7 its visits go to
    device memory; the block's shared memory follows."""
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    assert qc.ACC_MAX_VISITS == 2 ** 16
    assert qc.shared_acc(c54, 64, 64) and qc.shared_acc(c54, 512, 32)
    assert qc.shared_acc(c54, 512, 128) and not qc.shared_acc(c54, 512, 129)
    assert not qc.shared_acc(c117, 64, 64)
    assert qc.block_smem_bytes(c54, 64, 64) == 96 + 9936 + 2048 + 176640
    assert qc.block_smem_bytes(c54, 512, 129) == 96 + 9936 + 16384
    assert qc.block_smem_bytes(c117, 64, 64) == 96 + 122512 + 2048


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("bad", [float("nan"), 1e7])
def test_out_of_range_counts_equal_the_plain_version(kernel, bad):
    """Tables holding nan or 1e7: the twin counts the values outside
    +-value_limit as the plain version does and steps the same fields and
    counts."""
    cfg = EnvConfig(5, 4, 0.2)
    B, T = 256, 16
    got, want = _both(kernel, cfg, 5, EPS, _table(cfg, 2) + bad,
                      ik.init_iql_state_fields(cfg, B, "cpu"), T, 9)
    assert int(want[2][3]) > 0
    assert int(got[2][3]) == int(want[2][3])
    assert torch.equal(got[1][1], want[1][1])
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))


def test_layout_of_the_one_allocation():
    """The sums, the stats and the counts lie together at the front (one
    memset), the planes and the rows 16-B aligned after them."""
    for n, B in ((1104, 8192), (13612, 65536), (8, 128)):
        lay = qc.layout(n, B)
        assert lay.sums == 0 and lay.stats == 8 * 10 * n
        assert lay.cnt == lay.stats + 32 and lay.zero == lay.cnt + 4 * 10 * n
        assert lay.fields % 16 == 0 and lay.fields >= lay.zero
        assert lay.rows % 16 == 0 and lay.rows >= lay.fields + 24 * B
        assert lay.total == lay.rows + qc.row_bytes(n)
        assert lay.total % 16 == 0


def test_lanes_per_block():
    """``threads`` is K8/K9's lanes per block: by default one wave of 132
    blocks, any multiple of 32 up to 512, anything else refused with a
    ValueError on any device before a launch; it does not change the CPU
    result."""
    cfg = EnvConfig(5, 4, 0.2)
    assert [qc.default_lanes(b) for b in (128, 8192, 65536)] == [32, 64, 512]
    table = _table(cfg, 4)
    fields = ik.init_iql_state_fields(cfg, 256, "cpu")
    for fn in (ik.iql_packed_chunk, ik.iql_chunk):
        for bad in (0, 48, 544, 1024, 64.0):
            for dev in ("cpu", "meta"):
                with pytest.raises(ValueError, match="lanes per block"):
                    fn(cfg, 0, EPS, table.to(dev),
                       [f.to(dev) for f in fields], 256, 4, threads=bad)
        _same(fn(cfg, 2, EPS, table, fields, 256, 4, threads=32),
              fn(cfg, 2, EPS, table, fields, 256, 4))


@pytest.mark.parametrize("name", sorted(iql_variants.VARIANTS))
def test_iql_variants_patch_the_committed_kernel(name):
    """Each timed variant of K8/K9 (ops/iql_variants.py) applies its
    patches, each to exactly one place in the committed source, and
    changes it unless it is the kernel itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "iql_kernel.cu").read_text()
    got = iql_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in iql_variants.VARIANTS[name][0]:
        assert new in got
    with pytest.raises(ValueError, match="matches 0 times"):
        iql_variants.variant_source("rows-in-l2", "no kernel here")
