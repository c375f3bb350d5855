"""The two stages of the K1/K2 kernels (gym_soccer_tpu_torch.ops.rollout_codes)
on the CPU: step codes made from the counter words, then the walk of the
state chain from the codes, by the step table and by arithmetic, held to
the plain versions and to the JAX package's ``pallas_journal_rollout`` in
interpret mode; the step table held to the JAX package's
``transition_core`` for every walkable state and all 100 inputs; the
constant-divisor ISD pick and the effective moves.  Tolerance: exact
equality throughout, since every operation is integer."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import step_kernel as jsk
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import rules
from gym_soccer_tpu_torch.ops import rollout_codes as rc
from gym_soccer_tpu_torch.ops import rollout_variants
from gym_soccer_tpu_torch.ops import step_kernel as sk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, T = 1024, 64
BOARDS = [(5, 4), (11, 7)]


def _cfgs(board, q=0.2):
    w, h = board
    return JaxConfig(width=w, height=h, slip_prob=q), \
        EnvConfig(width=w, height=h, slip_prob=q)


def _two_stages(cfg, seed, fields, n_steps, step_offset=0, table=None):
    codes = rc.step_codes(cfg, seed, torch.arange(B), n_steps, step_offset)
    return rc.walk_codes(cfg, fields, codes, True, table)


def _equal(got, want):
    (gf, gs, gj), (wf, ws, wj) = got, want
    assert all(torch.equal(a, b) for a, b in zip(gf, wf))
    assert [int(x.sum()) for x in gs] == [int(x.sum()) for x in ws]
    assert torch.equal(gj, wj)


@pytest.mark.parametrize("board", BOARDS)
def test_two_stages_equal_the_plain_version_and_pallas(board):
    """Codes then walk equal ``_plain`` (fields, per-lane sums, journal)
    and the JAX package's Pallas journal kernel in interpret mode; on 5x4
    the table walk and the arithmetic walk agree."""
    jcfg, cfg = _cfgs(board)
    fields = sk._start_fields(cfg, B, T, "cpu", None, 0)
    got = _two_stages(cfg, 7, fields, T)
    out, sums, words = sk._plain(cfg, 7, fields, T, 0, True)
    assert all(torch.equal(a, b) for a, b in zip(got[1], sums))
    _equal(got, (out, sums, words))
    if rc.uses_table(cfg):
        _equal(_two_stages(cfg, 7, fields, T, table=False), got)
    jfields, jstats, jjournal = jsk.pallas_journal_rollout(
        jcfg, jnp.int32(7), B, T, interpret=True)
    assert [int(x.sum()) for x in got[1]] == [int(x) for x in jstats]
    assert np.array_equal(interop.journal_to_tiles(got[2]),
                          np.asarray(jjournal))
    for a, b in zip(interop.planes_to_tiles(got[0]), jfields):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("board", BOARDS)
def test_two_stages_resume_at_a_step_offset(board):
    """Walking 24 steps, then 40 more from their fields with codes made at
    step offset 24, equals one 64-step walk, and the JAX kernel resumed
    from the same fields."""
    jcfg, cfg = _cfgs(board)
    fields = sk._start_fields(cfg, B, T, "cpu", None, 0)
    whole = _two_stages(cfg, 9, fields, T)
    first = _two_stages(cfg, 9, fields, 24)
    second = _two_stages(cfg, 9, first[0], T - 24, step_offset=24)
    assert all(torch.equal(a, b) for a, b in zip(second[0], whole[0]))
    assert torch.equal(torch.cat([first[2], second[2]]), whole[2])
    assert [int(x.sum() + y.sum()) for x, y in zip(first[1], second[1])] \
        == [int(x.sum()) for x in whole[1]]
    _, jstats, jjournal = jsk.pallas_journal_rollout(
        jcfg, jnp.int32(9), B, T - 24, interpret=True, step_offset=24,
        init_fields=[jnp.asarray(p)
                     for p in interop.planes_to_tiles(first[0])])
    assert np.array_equal(interop.journal_to_tiles(second[2]),
                          np.asarray(jjournal))
    assert [int(x.sum()) for x in second[1]] == [int(x) for x in jstats]


def test_unwalkable_warps_walk_by_arithmetic():
    """Lanes that start where the game cannot go (a player without the
    ball in a goal column, both players on one cell) take their warp off
    the table; the result still equals the plain version."""
    _, cfg = _cfgs((5, 4))
    ra, ca, rb, cb, p, t = (f.clone() for f in
                            sk._start_fields(cfg, B, T, "cpu", None, 0))
    ca[5::97], ra[5::97] = 0, 1            # goal column, ball with B
    p[5::97] = 1
    rb[40::131], cb[40::131] = ra[40::131], ca[40::131]   # one cell
    fields = (ra, ca, rb, cb, p, t)
    walkable = rc.walkable(cfg, ra, ca, rb, cb, p)
    assert not walkable.all() and walkable.reshape(-1, 32).all(1).any()
    _equal(_two_stages(cfg, 5, fields, T),
           sk._plain(cfg, 5, fields, T, 0, True))


def _entries(st, codes, inputs):
    e = st.table.reshape(rc.INPUTS, st.n_codes)[inputs, codes].astype(
        np.int64)
    return (e & rc.CODE_MASK) >> 1, e < 0, np.where(
        e < 0, np.where(e & rc.REWARD_BIT, 1, -1), 0)


def test_step_table_equals_jax_transition_core():
    """Every walkable state under all 100 inputs: the table's next code,
    goal and reward equal the JAX package's transition_core under the
    effective moves played without slip; and under slipped actions the
    table at the effective moves equals transition_core with the slip."""
    jcfg, cfg = _cfgs((5, 4))
    st = rc.build_step_table(cfg)
    live = np.flatnonzero(rc.walkable(cfg, *st.code_fields.T))
    assert len(live) == 2 * 20 * 19       # 20 interior cells, distinct, p
    code, inp = (a.ravel() for a in np.meshgrid(live, np.arange(rc.INPUTS)))
    f = [jnp.asarray(st.code_fields[code, k]) for k in range(5)]
    ea, eb, coin = inp // 20, (inp // 4) % 5, inp % 4
    out = jsk.transition_core(*f, jnp.asarray(ea), jnp.asarray(eb),
                              jnp.zeros(len(code), jnp.uint32),
                              jnp.asarray(coin, jnp.uint32), jcfg, 0)
    nra, nca, nrb, ncb, npz, goal, r = (np.asarray(x) for x in out)
    nxt, tgoal, tr = _entries(st, code, inp)
    assert np.array_equal(
        nxt, rules.cellpair_encode(np, nra, nca, nrb, ncb, npz, cfg))
    assert np.array_equal(tgoal, goal) and np.array_equal(tr, r)
    # slipped actions: the effective moves carry the whole slip
    rng = np.random.default_rng(0)
    n = 20000
    code = rng.choice(live, n)
    a, b = rng.integers(0, 5, n), rng.integers(0, 5, n)
    u = rng.integers(0, 65536, (2, n))
    coin = rng.integers(0, 4, n)
    q = sk._q_int(cfg)
    f = [jnp.asarray(st.code_fields[code, k]) for k in range(5)]
    out = jsk.transition_core(
        *f, jnp.asarray(a), jnp.asarray(b),
        jnp.asarray((u[0] | (u[1] << 16)).astype(np.uint32)),
        jnp.asarray(coin.astype(np.uint32)), jcfg, q)
    nra, nca, nrb, ncb, npz, goal, r = (np.asarray(x) for x in out)
    em = [rc.effective_move(torch.as_tensor(x), torch.as_tensor(y), q)
          .numpy() for x, y in ((a, u[0]), (b, u[1]))]
    nxt, tgoal, tr = _entries(st, code, (em[0] * 5 + em[1]) * 4 + coin)
    assert np.array_equal(
        nxt, rules.cellpair_encode(np, nra, nca, nrb, ncb, npz, cfg))
    assert np.array_equal(tgoal, goal) and np.array_equal(tr, r)


def test_step_table_fits_one_block():
    """5x4's table, 220,800 B, fits one block's shared memory beside the
    ring of 64 or 96 lanes (the default and the ragged size), up to 192,
    not of 224; 11x7's does not fit and walks by arithmetic."""
    _, c54 = _cfgs((5, 4))
    _, c117 = _cfgs((11, 7))
    st = rc.build_step_table(c54)
    assert st.n_codes == 1104 and st.table.nbytes == 220800
    assert rc.smem_bytes(64, 1104) == 112 + 220800 + 2208 + 3072 \
        <= rc.SMEM_BUDGET
    assert rc.smem_bytes(64, 0) == 112 + 3072
    assert rc.smem_bytes(96, 1104) <= rc.SMEM_BUDGET
    assert rc.smem_bytes(192, 1104) <= rc.SMEM_BUDGET
    assert rc.smem_bytes(224, 1104) > rc.SMEM_BUDGET
    assert rc.uses_table(c54) and not rc.uses_table(c117)
    assert rules.n_cellpairs(c117) == 13612
    assert rc.table_bytes(13612) > rc.SMEM_BUDGET
    with pytest.raises(ValueError, match="13 bits"):
        rc.build_step_table(c117)


@pytest.mark.parametrize("nI", [1, 2, 3, 4])
def test_isd_pick_equals_the_remainder(nI):
    u = torch.arange(65536, dtype=torch.int64)
    assert torch.equal(rc.isd_pick(u, nI), u % nI)
    with pytest.raises(ValueError):
        rc.isd_pick(u, 5)


@pytest.mark.parametrize("q_int", [0, 13107, 32768, 65535, 65536])
def test_effective_move_is_the_slipped_move(q_int):
    """The action ``effective_move`` names moves as ``_slipped_move`` does,
    for every action and every u16; it is 0 exactly when the action is."""
    a = torch.arange(5).repeat_interleave(65536)
    u = torch.arange(65536).repeat(5)
    e = rc.effective_move(a, u, q_int)
    assert torch.equal(torch.stack(sk._slipped_move(e, torch.zeros_like(u),
                                                    0)),
                       torch.stack(sk._slipped_move(a, u, q_int)))
    assert torch.equal(e == 0, a == 0)


@pytest.mark.parametrize("name", sorted(rollout_variants.VARIANTS))
def test_rollout_variants_patch_the_committed_kernel(name):
    """Each timed variant of K1/K2 (ops/rollout_variants.py) applies its
    patches, each to exactly one place in the committed source, and changes
    it unless it is the kernel itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "step_kernel.cu").read_text()
    got = rollout_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in rollout_variants.VARIANTS[name][0]:
        assert new in got
    with pytest.raises(ValueError, match="matches 0 times"):
        rollout_variants.variant_source("tile-16", "no kernel here")


@pytest.mark.parametrize("name", sorted(rollout_variants.ALT_VARIANTS))
def test_alt_variants_patch_the_committed_kernel(name):
    """Each timed variant of K4 applies its patches, each to exactly one
    place in the committed source, and changes it unless it is the kernel
    itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "step_kernel.cu").read_text()
    got = rollout_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in rollout_variants.ALT_VARIANTS[name][0]:
        assert new in got


# ----------------------------------------------------------------------
# K4: the alternating game's tick codes and walk
# ----------------------------------------------------------------------

def _alt_two_stages(cfg, seed, fields, n_steps, step_offset=0, table=None):
    codes = rc.alt_step_codes(cfg, seed, torch.arange(B), n_steps,
                              step_offset)
    return rc.alt_walk_codes(cfg, fields, codes, table)


def _alt_equal(got, want):
    (gf, gs), (wf, ws) = got, want
    assert all(torch.equal(a, b) for a, b in zip(gf, wf))
    assert [int(x.sum()) for x in gs] == [int(x) for x in ws]


@pytest.mark.parametrize("board", BOARDS)
def test_alt_two_stages_equal_the_plain_version_and_pallas(board):
    """K4's tick codes then walk equal ``alt_rollout_plain`` and the JAX
    package's ``pallas_alt_rollout`` in interpret mode (1024 lanes x 64
    ticks); on 5x4 the table walk and the arithmetic walk agree."""
    jcfg, cfg = _cfgs(board)
    fields = sk.init_alt_fields(cfg, B, "cpu")
    got = _alt_two_stages(cfg, 7, fields, T)
    _alt_equal(got, sk.alt_rollout_plain(cfg, 7, B, T, "cpu"))
    if rc.uses_alt_table(cfg):
        _alt_equal(_alt_two_stages(cfg, 7, fields, T, table=False),
                   (got[0], [x.sum() for x in got[1]]))
    jf, js = jsk.pallas_alt_rollout(jcfg, 7, B, T, interpret=True)
    assert [int(x.sum()) for x in got[1]] == [int(x) for x in js]
    for a, b in zip(interop.planes_to_tiles(got[0]), jf):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("board", BOARDS)
def test_alt_two_stages_resume_at_a_step_offset(board):
    """24 ticks, then 40 more from their fields with codes made at step
    offset 24, equal one 64-tick walk, and the JAX kernel resumed from the
    same fields."""
    jcfg, cfg = _cfgs(board)
    fields = sk.init_alt_fields(cfg, B, "cpu")
    whole = _alt_two_stages(cfg, 9, fields, T)
    first = _alt_two_stages(cfg, 9, fields, 24)
    second = _alt_two_stages(cfg, 9, first[0], T - 24, step_offset=24)
    assert all(torch.equal(a, b) for a, b in zip(second[0], whole[0]))
    assert [int(x.sum() + y.sum()) for x, y in zip(first[1], second[1])] \
        == [int(x.sum()) for x in whole[1]]
    jf, js = jsk.pallas_alt_rollout(
        jcfg, 9, B, T - 24, interpret=True, step_offset=24,
        init_fields=[jnp.asarray(p)
                     for p in interop.planes_to_tiles(first[0])])
    assert [int(x.sum()) for x in second[1]] == [int(x) for x in js]
    for a, b in zip(interop.planes_to_tiles(second[0]), jf):
        assert np.array_equal(a, np.asarray(b))


def test_alt_unwalkable_warps_walk_by_arithmetic():
    """Lanes the tick table cannot start from (a player without the ball in
    a goal column, a turn other than 0 or 1) take their warp off the
    table; the result still equals the plain version."""
    _, cfg = _cfgs((5, 4))
    ra, ca, rb, cb, p, turn, t = (f.clone() for f in
                                  sk.init_alt_fields(cfg, B, "cpu"))
    ca[5::97], ra[5::97], p[5::97] = 0, 1, 1
    turn[40::131] = 2
    t[::3] = cfg.max_steps - 2
    fields = (ra, ca, rb, cb, p, turn, t)
    walkable = rc.walkable(cfg, ra, ca, rb, cb, p) & (turn <= 1)
    assert not walkable.all() and walkable.reshape(-1, 32).all(1).any()
    _alt_equal(_alt_two_stages(cfg, 5, fields, T),
               sk.alt_rollout_plain(cfg, 5, B, T, "cpu", init_fields=fields))


def test_alt_table_equals_jax_alt_step_once():
    """Every walkable (code, turn) under all 5 moves: the tick table's next
    (code, turn), goal and reward equal the port's alt_transition_core and
    the JAX package's ``_alt_step_once`` with the move as the action, no
    slip and no truncation (a goal resets, so only its flag and reward are
    compared)."""
    jcfg, cfg = _cfgs((5, 4))
    at = rc.build_alt_table(cfg)
    fields = rc.code_fields(cfg)
    live = np.flatnonzero(rc.walkable(cfg, *fields.T))
    code, turn, move = (a.ravel() for a in np.meshgrid(
        live, np.arange(2), np.arange(rc.ALT_INPUTS), indexing="ij"))
    e = at.table.reshape(rc.ALT_INPUTS, at.n_codes, 2)[move, code, turn] \
        .astype(np.int64)
    goal, nxt2 = e < 0, (e & rc.CODE_MASK) >> 1
    reward = np.where(goal, np.where(e & rc.REWARD_BIT, 1, -1), 0)
    f = [fields[code, k] for k in range(5)]
    port = sk.alt_transition_core(
        *(torch.as_tensor(x.astype(np.int64)) for x in (*f, turn, move)),
        torch.zeros(len(code), dtype=torch.int64), cfg, 0)
    zeros = jnp.zeros(len(code), jnp.int32)
    jout = jsk._alt_step_once(
        (*(jnp.asarray(x, jnp.int32) for x in (*f, turn)), zeros, zeros,
         zeros, zeros), jnp.asarray(move, jnp.uint32),
        jnp.zeros(len(code), jnp.uint32), jnp.zeros(len(code), jnp.uint32),
        jcfg, 0)
    jfields = [np.asarray(x) for x in jout[:6]]
    assert np.array_equal(np.asarray(jout[8]), goal)
    assert np.array_equal(np.asarray(jout[7]), reward)
    assert np.array_equal(port[5].numpy(), goal)
    assert np.array_equal(port[6].numpy(), reward)
    moved = ~goal
    want = rules.cellpair_encode(np, *(x[moved] for x in jfields[:5]), cfg)
    assert np.array_equal(nxt2[moved] >> 1, want)
    assert np.array_equal(nxt2[moved] & 1, jfields[5][moved])
    assert np.array_equal(nxt2[moved] >> 1, rules.cellpair_encode(
        np, *(x.numpy()[moved] for x in port[:5]), cfg))
    assert np.array_equal(nxt2[moved] & 1, 1 - turn[moved])


def test_alt_table_fits_one_block():
    """5x4's tick table is 22,080 B, a tenth of K1's step table, and fits
    one block's shared memory beside the ring of any block size up to 512
    lanes; 11x7's entries would not hold its codes, so it walks by
    arithmetic."""
    _, c54 = _cfgs((5, 4))
    _, c117 = _cfgs((11, 7))
    at = rc.build_alt_table(c54)
    assert at.n_codes == 1104 and at.table.nbytes == 22080
    assert rc.alt_smem_bytes(64, 1104) == 112 + 22080 + 2208 + 3072
    assert rc.alt_smem_bytes(rc.MAX_LANES, 1104) <= rc.SMEM_BUDGET
    assert rc.uses_alt_table(c54) and not rc.uses_alt_table(c117)
    with pytest.raises(ValueError, match="13 bits"):
        rc.build_alt_table(c117)


@pytest.mark.parametrize("board", BOARDS)
def test_alt_lanes_per_block(board):
    """``threads`` is K4's lanes per block: 64 by default, any multiple of
    32 up to 512 (all fit), anything else refused with a ValueError on any
    device, before a launch; it does not change the CPU result."""
    _, cfg = _cfgs(board)
    assert rc.check_alt_lanes(cfg, None) == 64
    for lanes in (32, 96, 480, 512):
        assert rc.check_alt_lanes(cfg, lanes) == lanes
    for bad in (0, 48, 544, 1024, 64.0):
        with pytest.raises(ValueError, match="lanes per block"):
            rc.check_alt_lanes(cfg, bad)
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="lanes per block"):
                sk.alt_rollout(cfg, 0, 1024, 4, dev, threads=bad)
    want = sk.alt_rollout(cfg, 3, 1024, 8, "cpu")
    got = sk.alt_rollout(cfg, 3, 1024, 8, "cpu", threads=32)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))


# ----------------------------------------------------------------------
# K3: the mixture's step codes and walk
# ----------------------------------------------------------------------

MIX3 = ((5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3))   # tools/bench_all.py:421
MG_T, MG_SPLIT = 20, 12


def _mg_cfgs():
    return (tuple(JaxConfig(*b) for b in MIX3),
            tuple(EnvConfig(*b) for b in MIX3))


def _mg_two_stages(cfgs, seed, fields, n_steps, step_offset=0):
    """K3's step codes of each lane on its board, then its walk."""
    planes = sk._geo(cfgs, fields[0].shape[0], torch.device("cpu"))
    geo = sk.GeoPlanes(*planes[:5], cfgs[0].max_steps)
    codes = rc.mg_step_codes(geo, seed, torch.arange(fields[0].shape[0]),
                             n_steps, step_offset)
    return rc.mg_walk_codes(cfgs, fields, planes, codes)


@pytest.fixture(scope="module")
def mg_runs():
    """The two stages over MG_T steps, and over MG_SPLIT then the rest at
    that step offset, from the mixture's ISD spread; the JAX kernel in
    interpret mode over MG_T steps and resumed from the first part's
    fields."""
    jcfgs, cfgs = _mg_cfgs()
    fields = sk._start_fields(cfgs, B, MG_T, "cpu", None, 0)
    whole = _mg_two_stages(cfgs, 9, fields, MG_T)
    first = _mg_two_stages(cfgs, 9, fields, MG_SPLIT)
    second = _mg_two_stages(cfgs, 9, first[0], MG_T - MG_SPLIT, MG_SPLIT)
    jwhole = jsk.pallas_multigrid_rollout(jcfgs, jnp.int32(9), B, MG_T,
                                          interpret=True)
    jsecond = jsk.pallas_multigrid_rollout(
        jcfgs, jnp.int32(9), B, MG_T - MG_SPLIT, interpret=True,
        step_offset=MG_SPLIT,
        init_fields=[jnp.asarray(p) for p in interop.planes_to_tiles(
            first[0])])
    return cfgs, whole, first, second, jwhole, jsecond


def _mg_equal_jax(got, jgot):
    (fields, stats), (jfields, jstats) = got, jgot
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(stats.numpy(), np.asarray(jstats))


def test_mg_two_stages_equal_the_plain_version_and_pallas(mg_runs):
    """K3's step codes then walk (1024 lanes x 20 steps on the 3-board
    mixture) equal ``multigrid_rollout_plain`` (fields and per-variant
    stats) and the JAX package's ``pallas_multigrid_rollout`` in interpret
    mode."""
    cfgs, whole, _, _, jwhole, _ = mg_runs
    pf, ps = sk.multigrid_rollout_plain(cfgs, 9, B, MG_T, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(whole[0], pf))
    assert torch.equal(whole[1], ps) and int(ps[:, 1].sum()) > 0
    _mg_equal_jax(whole, jwhole)


def test_mg_two_stages_resume_at_a_step_offset(mg_runs):
    """12 steps, then 8 more from their fields with codes made at step
    offset 12, equal one 20-step walk, and the JAX kernel resumed from the
    same fields."""
    _, whole, first, second, _, jsecond = mg_runs
    assert all(torch.equal(a, b) for a, b in zip(second[0], whole[0]))
    assert torch.equal(first[1] + second[1], whole[1])
    _mg_equal_jax(second, jsecond)


def test_mg_two_stages_from_goal_states_and_late_steps():
    """Lanes that start in goal states, on one cell, or a step before
    truncation, on every board of the mixture: the two stages equal the
    plain version, truncations counted."""
    _, cfgs = _mg_cfgs()
    ra, ca, rb, cb, p, t = (f.clone() for f in
                            sk._start_fields(cfgs, B, 8, "cpu", None, 0))
    _, W, glo, *_ = sk._geo(cfgs, B, torch.device("cpu"))
    ca[5::97], ra[5::97], p[5::97] = W[5::97] - 1, glo[5::97], 0   # goal
    rb[40::131], cb[40::131] = ra[40::131], ca[40::131]   # one cell
    t[::3] = cfgs[0].max_steps - 1
    fields = (ra, ca, rb, cb, p, t)
    got = _mg_two_stages(cfgs, 5, fields, 8)
    pf, ps = sk.multigrid_rollout_plain(cfgs, 5, B, 8, "cpu",
                                        init_fields=fields)
    assert all(torch.equal(a, b) for a, b in zip(got[0], pf))
    assert torch.equal(got[1], ps) and int(ps[:, 2].sum()) > 0


def test_mg_step_codes_use_each_lanes_board():
    """A lane's K3 code is K1's on its own board without the joint action:
    for the one-variant mixtures of each board, the low 9 bits of
    ``step_codes``."""
    _, cfgs = _mg_cfgs()
    lanes = torch.arange(B)
    planes = sk._geo(cfgs, B, torch.device("cpu"))
    codes = rc.mg_step_codes(sk.GeoPlanes(*planes[:5], 100), 4, lanes, 6, 3)
    for v, cfg in enumerate(cfgs):
        mine = planes[5] == v
        want = rc.step_codes(cfg, 4, lanes[mine], 6, 3) & 0x1FF
        assert torch.equal(codes[:, mine], want)


def test_mg_lanes_per_block_and_shared_memory():
    """``threads`` is K3's lanes per block: 64 by default, any multiple of
    32 up to 512 (33,152 B of shared memory at 512: the per-variant sums, a
    16-B slip entry and the ring a lane), anything else refused with a
    ValueError on any device, before a launch; it does not change the CPU
    result."""
    _, cfgs = _mg_cfgs()
    assert rc.lanes_per_block(None) == 64
    for lanes in (32, 96, 480, 512):
        assert rc.lanes_per_block(lanes) == lanes
    assert rc.mg_smem_bytes(64) == 384 + 16 * 64 + 3 * 8 * 2 * 64
    assert rc.mg_smem_bytes(512) == 33152 < 48 * 1024
    for bad in (0, 48, 544, 1024, 64.0):
        with pytest.raises(ValueError, match="lanes per block"):
            rc.lanes_per_block(bad)
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="lanes per block"):
                sk.multigrid_rollout(cfgs, 0, 1024, 4, dev, threads=bad)
    want = sk.multigrid_rollout(cfgs, 3, 1024, 8, "cpu")
    got = sk.multigrid_rollout(cfgs, 3, 1024, 8, "cpu", threads=32)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", sorted(rollout_variants.MG_VARIANTS))
def test_mg_variants_patch_the_committed_kernel(name):
    """Each timed variant of K3 applies its patches, each to exactly one
    place in the committed source, and changes it unless it is the kernel
    itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "step_kernel.cu").read_text()
    got = rollout_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in rollout_variants.MG_VARIANTS[name][0]:
        assert new in got
