"""The two stages of the K10/K11 turn-based Q kernels (gym_soccer_tpu_torch.
ops.altq_codes) on the CPU: the producers' step codes, then the consumers'
steps on the prep pass's rows (by K4's tick table on 5x4, by arithmetic on
11x7 and for warps the table cannot start from), held to
``altq_packed_chunk_plain`` / ``altq_chunk_plain`` bit for bit (fields,
stats with the out-of-range count, visit counts and the int64 sums) and to
the JAX package's ``altq_packed_chunk`` / ``altq_chunk`` in interpret mode
(fields, stats and counts exactly; the sums per cell within cnt * (2**-8 *
max|delta| + 1e-6), the tolerance of ``tests/test_torch_altq_kernel.py``,
since JAX rounds each value to bfloat16 before its scatter-add); the
prepared rows at near-ties and on NaN rows (the plain version's scan, not
K8's), the shared memory of the rows, the tick table and the private
accumulators, the layout of the one allocation, the lanes per block, the
constants shared with ``csrc/altq_kernel.cu`` and the variants' patches."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import altq_kernel as jak
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import rules
from gym_soccer_tpu_torch.envs.soccer_alternating_env import build_alt_tables
from gym_soccer_tpu_torch.ops import altq_codes as ac
from gym_soccer_tpu_torch.ops import altq_kernel as ak
from gym_soccer_tpu_torch.ops import altq_variants
from gym_soccer_tpu_torch.ops import iql_codes as qc
from gym_soccer_tpu_torch.ops import rollout_codes as rc

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

EPS = int(round(0.3 * 65536))
KERNELS = {"K10": (True, ak.altq_packed_chunk_plain),
           "K11": (False, ak.altq_chunk_plain)}


def _q(cfg, seed):
    """q float32 numpy [nS, 5], uniform in [-1, 1]."""
    nS = build_alt_tables(cfg).nS
    return np.random.default_rng(seed).uniform(-1, 1, (nS, 5)).astype(
        np.float32)


def _table(cfg, seed):
    return ak.pack_alt_table(cfg, torch.as_tensor(_q(cfg, seed)))


def _same(a, b, sums=True):
    (fa, (sa, ca), ta), (fb, (sb, cb), tb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert torch.equal(ca, cb)
    assert not sums or torch.equal(sa, sb)
    assert [int(x) for x in ta] == [int(x) for x in tb]


def _both(kernel, cfg, seed, eps_int, table, fields, T, off, gamma=0.99,
          walk_table=None):
    """(the twin's chunk, the plain version's) of K10 or K11."""
    packed, plain = KERNELS[kernel]
    B = fields[0].shape[0]
    return (ac.chunk_twin(cfg, seed, eps_int, table, fields, T, gamma, off,
                          packed, walk_table),
            plain(cfg, seed, eps_int, table, fields, B, T, gamma, off))


def _odd_fields(cfg, B):
    """Initial fields with lanes in goal states (A carrying the ball into
    the right goal, B into the left), a few steps before truncation, and
    with turn 2 (a turn the game never holds)."""
    ra, ca, rb, cb, p, turn, t = (f.clone() for f in
                                  ak.init_alt_state_fields(cfg, B, "cpu"))
    lo = cfg.goal_row_bounds[0]
    ca[5::97], ra[5::97], p[5::97] = cfg.W - 1, lo, 0
    rb[40::131], cb[40::131], p[40::131] = lo, 0, 1
    t[::3] = cfg.max_steps - 3
    return ra, ca, rb, cb, p, turn, t


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("board,B,T,seed,off,walk", [
    ((5, 4), 512, 12, 3, 0, None),
    ((5, 4), 256, 10, 4, 37, None),
    ((5, 4), 256, 10, 4, 37, False),
    ((11, 7), 256, 8, 5, 0, None),
    ((11, 7), 256, 6, 6, 37, None),
], ids=["5x4", "5x4-offset", "5x4-arith", "11x7", "11x7-offset"])
def test_two_stages_equal_the_plain_version(kernel, board, B, T, seed, off,
                                            walk):
    """The producers' codes then the consumers' steps (5x4: the tick
    table, or the arithmetic walk; 11x7: the arithmetic walk) equal the
    plain version bit for bit, from step 0 and from a later chunk's step
    37."""
    cfg = EnvConfig(*board, 0.2)
    assert ac.uses_table(cfg) == (board == (5, 4))
    got, want = _both(kernel, cfg, seed, EPS, _table(cfg, seed),
                      ak.init_alt_state_fields(cfg, B, "cpu"), T, off,
                      walk_table=walk)
    _same(got, want)
    assert int(got[1][1].sum()) == B * T


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("board,B,T,seed,off", [
    ((5, 4), 256, 8, 3, 0),
    ((11, 7), 256, 4, 5, 8),
], ids=["5x4", "11x7"])
def test_two_stages_equal_jax(kernel, board, B, T, seed, off):
    """The twin equals the JAX kernel in interpret mode fed the same
    double-bf16 table and state: fields, stats and counts exactly, the
    sums within cnt * (2**-8 * max|delta| + 1e-6)."""
    packed = KERNELS[kernel][0]
    jcfg, cfg = JaxConfig(*board, 0.2), EnvConfig(*board, 0.2)
    pack, chunk, unpack = ((jak.pack_alt_m2, jak.altq_packed_chunk,
                            jak.unpack_alt_acc2) if packed else
                           (jak.pack_alt_m, jak.altq_chunk, jak.unpack_alt_acc))
    m = pack(jcfg, jnp.asarray(_q(cfg, seed)))
    jfields0 = jak.init_alt_state_fields(jcfg, B)
    jf, jacc, jst = chunk(jcfg, seed, EPS, m, jfields0, B, T,
                          step_offset=off, interpret=True)
    table = interop.alt_table_from_m(cfg, np.asarray(m, np.float32), packed,
                                     "cpu")
    f, acc, st = ac.chunk_twin(cfg, seed, EPS, table,
                               interop.planes_from_tiles(jfields0, "cpu"), T,
                               0.99, off, packed)
    for a, b in zip(interop.planes_to_tiles(f), jf):
        assert np.array_equal(a, np.asarray(b))
    assert [int(x) for x in st] == [int(x) for x in jst] + [0]
    ours = [a.numpy() for a in ak.unpack_alt_acc(cfg, acc)]
    theirs = [np.asarray(a) for a in unpack(jcfg, jacc)]
    c = ours[1]
    assert np.array_equal(c, theirs[1]) and int(c.sum()) == B * T
    tol = c * (2.0 ** -8 * (1 + 1.99 * float(table.abs().max())) + 1e-6)
    assert (np.abs(ours[0] - theirs[0]) <= tol).all()


@pytest.mark.parametrize("eps_int", [0, ak.EPS_ONE], ids=["greedy", "explore"])
def test_eps_edges(eps_int):
    """eps_int 0: every choice is the greedy marker; 65536: none is, each
    an action 0-4.  The slip class and ISD index are the words' in both;
    the twin equals the plain versions."""
    cfg = EnvConfig(5, 4, 0.2)
    lanes = torch.arange(1024)
    codes = ac.altq_codes(cfg, 11, eps_int, lanes, 6, 5).long()
    x = codes & 7
    if eps_int == 0:
        assert bool((x == ac.GREEDY).all())
    else:
        assert int(x.max()) <= 4 and len(x.unique()) == 5
    assert int(codes.max()) < 1 << 7
    b1, b2 = (ak.sk._random_word(11, 7, w, lanes) for w in (1, 2))
    assert torch.equal((codes[2] >> 3) & 3, ac.lc.slip_class(
        ak.sk._u16(b1, 0), ak.sk._q_int(cfg)))
    assert torch.equal(codes[2] >> 5, (ak.sk._u16(b2, 1) % 4).long())
    fields = ak.init_alt_state_fields(cfg, 512, "cpu")
    for kernel in KERNELS:
        _same(*_both(kernel, cfg, 2, eps_int, _table(cfg, 2), fields, 8, 3))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_goal_states_and_late_truncations_equal_the_plain_version(kernel):
    """Lanes that start in goal states (where the table still has rows), a
    few steps before truncation, or with turn 2: their warps step by
    arithmetic, every other warp by the tick table, and the chunk equals
    the plain version.  The players are greedy (eps 0), and action 0 is
    greedy in the goal states, so no player steps off the board from one:
    the carrier stays in the goal and the lane scores and resets."""
    cfg = EnvConfig(5, 4, 0.2)
    B = 1024
    ra, ca, rb, cb, p, turn, t = _odd_fields(cfg, B)
    turn[7::301] = 2
    fields = (ra, ca, rb, cb, p, turn, t)
    assert not rc.walkable(cfg, ra, ca, rb, cb, p).all()
    table = _table(cfg, 1)
    goal = rules.cellpair_encode(torch, ra, ca, rb, cb, p, cfg).long()[
        torch.cat([torch.arange(5, B, 97), torch.arange(40, B, 131)])]
    table[goal, 0] = 2.0
    table[goal, 5] = -2.0
    got, want = _both(kernel, cfg, 4, 0, table, fields, 12, 21, gamma=0.9)
    _same(got, want)
    assert int(want[2][1]) >= len(goal) and int(want[2][2]) > 0


def test_prepared_rows_are_the_altq_scan_at_near_ties():
    """The prep pass's V pair and greedy actions equal the plain version's
    mover scan on sgn * q (strict ``>``, the lowest index wins a tie; B
    minimises) and its max / min, on double-bf16 values of which
    neighbours one float32 step apart round to ties, and on exact ties."""
    cfg = EnvConfig(5, 4, 0.2)
    n = ak.n_codes(cfg)
    rng = np.random.default_rng(11)
    y = torch.tensor(rng.uniform(-0.9, 0.9, (n, 10)), dtype=torch.float32)
    near = torch.nextafter(y, torch.tensor(2.0))
    y[::2, 3] = near[::2, 1]            # a near-tie after A's max's index
    y[1::4, 7] = y[1::4, 6]             # an exact tie
    y[::3, 0] = y[::3, 4] = 0.95        # a tie of A's max, far apart
    y[::3, 5] = y[::3, 9] = -0.95       # a tie of B's min, far apart
    table = ak.double_bf16(y)
    assert bool((table[::2, 3] == table[::2, 1]).float().mean() > 0.5)
    vals, greedy = ac.prepare_rows(table)
    assert vals.shape == (n, 2) and vals.dtype == torch.float32
    assert greedy.dtype == torch.int32 and int(greedy.max()) < 1 << 6
    qa, qb = table[:, :5].numpy(), table[:, 5:].numpy()
    assert torch.equal(vals[:, 0], torch.as_tensor(qa.max(1)))
    assert torch.equal(vals[:, 1], torch.as_tensor(qb.min(1)))
    assert torch.equal((greedy & 7).long(), torch.as_tensor(qa.argmax(1)))
    assert torch.equal((greedy >> 3).long(), torch.as_tensor(qb.argmin(1)))
    assert bool((greedy[::3] == 0).all())


def test_nan_rows_pin_the_altq_scan():
    """A NaN at column k ends the mover's scan: its running best becomes
    NaN, so no later column is chosen, and V is NaN.  K8's prep pass
    (``iql_codes.prepare_rows``) skips the NaN and picks the later column;
    the turn-based prep pass does not.  A greedy chunk on such a table
    takes action 0 at every step, as the plain version does, and counts
    every value out of range."""
    cfg = EnvConfig(5, 4, 0.2)
    n = ak.n_codes(cfg)
    table = torch.zeros((n, 10))
    table[:, 1] = table[:, 6] = float("nan")
    table[:, 3], table[:, 8] = 0.75, -0.75   # each mover's best after it
    vals, greedy = ac.prepare_rows(table)
    assert bool(torch.isnan(vals).all())
    assert bool((greedy == 0).all())
    _, iql_greedy = qc.prepare_rows(table)
    assert bool(((iql_greedy & 7) == 3).all())
    _, neg_greedy = qc.prepare_rows(-table)   # K8's scan on B's sgn * q
    assert bool(((neg_greedy >> 3) == 3).all())
    B, T = 256, 8
    fields = ak.init_alt_state_fields(cfg, B, "cpu")
    for kernel in KERNELS:
        got, want = _both(kernel, cfg, 3, 0, table, fields, T, 5)
        _same(got, want, sums=False)
        cnt = want[1][1]
        assert int(cnt[:, 0].sum() + cnt[:, 5].sum()) == B * T
        assert int(want[2][3]) == B * T


def test_rows_table_and_accumulators_fit_shared_memory():
    """At the widest block (512 lanes) on 5x4 the head (96 B), the rows
    (9 B a code: 9,936 B), the tick table (22,080 B), its raw codes (2,208
    B), the ring (16,384 B) and the private accumulators (1104 x 10 cells
    of 16 B: 176,640 B) take 227,344 B of the 232,448 B budget; 11x7 keeps
    its rows (122,512 B) and walks by arithmetic, its accumulators in
    device memory."""
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    n54, n117 = ak.n_codes(c54), ak.n_codes(c117)
    assert (n54, n117) == (1104, 13612)
    assert ac.HEAD_BYTES == 96 and ac.SMEM_BUDGET == 232448
    assert ac.row_bytes(n54) == 9936 and ac.row_bytes(n117) == 122512
    assert ac.tick_bytes(n54) == 22080 and ac.raw_bytes(n54) == 2208
    assert ac.ring_bytes(512) == 16384 and ac.acc_bytes(n54) == 176640
    assert ac.smem_bytes(512, n54, n54, n54) == 227344 <= ac.SMEM_BUDGET
    assert ac.shared_rows(c54) and ac.shared_rows(c117)
    assert ac.uses_table(c54) and not ac.uses_table(c117)
    assert ac.block_smem_bytes(c54, 512, 32) == 227344
    assert ac.block_smem_bytes(c54, 64, 64) == 227344 - 16384 + 2048
    assert ac.block_smem_bytes(c117, 512, 32) == 96 + 122512 + 16384
    assert ac.smem_bytes(512, 0) == 96 + 16384


def test_private_accumulators_where_they_fit():
    """Each block keeps its own accumulators in shared memory on 5x4 while
    it adds at most 2**16 values to a cell (lanes x steps: 64 x 64 at 8192
    x 64, 512 x 32 at 65536 x 32); past that and on 11x7 its visits go to
    device memory; the arithmetic walk on 5x4 keeps them too."""
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    assert ac.ACC_MAX_VISITS == 2 ** 16
    assert ac.shared_acc(c54, 64, 64) and ac.shared_acc(c54, 512, 32)
    assert ac.shared_acc(c54, 512, 128) and not ac.shared_acc(c54, 512, 129)
    assert ac.shared_acc(c54, 64, 64, table=False)
    assert not ac.shared_acc(c117, 64, 64)
    assert ac.block_smem_bytes(c54, 512, 129) == 96 + 9936 + 22080 + 2208 \
        + 16384


def test_layout_of_the_one_allocation():
    """The sums, the stats and the counts lie together at the front (one
    memset), the seven planes and the rows 16-B aligned after them."""
    for n, B in ((1104, 8192), (13612, 65536), (8, 128)):
        lay = ac.layout(n, B)
        assert lay.sums == 0 and lay.stats == 8 * 10 * n
        assert lay.cnt == lay.stats + 32 and lay.zero == lay.cnt + 4 * 10 * n
        assert lay.fields % 16 == 0 and lay.fields >= lay.zero
        assert lay.rows % 16 == 0 and lay.rows >= lay.fields + 28 * B
        assert lay.total == lay.rows + ac.row_bytes(n)
        assert lay.total % 16 == 0


def test_lanes_per_block():
    """``threads`` is K10/K11's lanes per block: by default one wave of 132
    blocks, any multiple of 32 up to 512, anything else refused with a
    ValueError on any device before a launch; it does not change the CPU
    result."""
    cfg = EnvConfig(5, 4, 0.2)
    assert [ac.default_lanes(b) for b in (128, 8192, 65536)] == [32, 64, 512]
    table = _table(cfg, 4)
    fields = ak.init_alt_state_fields(cfg, 256, "cpu")
    for fn in (ak.altq_packed_chunk, ak.altq_chunk):
        for bad in (0, 48, 544, 1024, 64.0):
            for dev in ("cpu", "meta"):
                with pytest.raises(ValueError, match="lanes per block"):
                    fn(cfg, 0, EPS, table.to(dev),
                       [f.to(dev) for f in fields], 256, 4, threads=bad)
        _same(fn(cfg, 2, EPS, table, fields, 256, 4, threads=32),
              fn(cfg, 2, EPS, table, fields, 256, 4))


def test_constants_are_the_kernels():
    """altq_codes' ring, budget, greedy marker and accumulator limit are
    csrc/altq_kernel.cu's, and the tick entry's bits K4's."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "altq_kernel.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        return eval(m.group(1))   # an integer literal or a shift

    assert (const("kTile"), const("kRingStages"), const("kProducers"),
            const("kMaxLanes"), const("kSmemBudget"), const("kGreedy"),
            const("kAccMaxVisits"), const("kMoves")) == (
        ac.TILE_STEPS, ac.STAGES, ac.PRODUCER_WARPS, ac.MAX_LANES,
        ac.SMEM_BUDGET, ac.GREEDY, ac.ACC_MAX_VISITS, rc.ALT_INPUTS)
    assert (const("kCodeMask"), const("kRewardBit"), const("kGoalBit")) == (
        rc.CODE_MASK, rc.REWARD_BIT, rc.GOAL_BIT)
    assert "constexpr int kHead = 16 + 4 * kMaxIsd * 5;" in src
    assert ac.HEAD_BYTES == 16 + 4 * 4 * 5


@pytest.mark.parametrize("name", sorted(altq_variants.VARIANTS))
def test_altq_variants_patch_the_committed_kernel(name):
    """Each timed variant of K10/K11 (ops/altq_variants.py) applies its
    patches, each to exactly one place in the committed source, and
    changes it unless it is the kernel itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "altq_kernel.cu").read_text()
    got = altq_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in altq_variants.VARIANTS[name][0]:
        assert new in got
    with pytest.raises(ValueError, match="matches 0 times"):
        altq_variants.variant_source("arith-walk", "no kernel here")
