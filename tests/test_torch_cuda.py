"""The CUDA kernels K1-K13, R1, T1, S1, S2, S3 and A1 against their plain PyTorch
versions on the card, bit for bit (S1's builds and previous design too,
ops/engine_variants), and the trainers' grouped dispatch
modes (CUDA-graph replays) against their per-chunk runs.  Skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os

import pytest
import torch

from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import step_kernel as sk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BOARDS = [(5, 4), (11, 7)]


def _ints(stats):
    return [int(x) for x in stats]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("board", BOARDS)
def test_kernels_equal_plain_versions(cuda, board):
    """K1 and K2 equal the plain versions at 64 lanes per block (the
    default), 96 (a ragged last block) and 32, and a run resumed through
    step_offset equals one run."""
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B, T = 2048, 64
    pf, ps, pj = sk.fused_journal_rollout_plain(cfg, 4, B, T, cuda)
    for threads in (None, 96, 32):
        kf, ks = sk.fused_rollout(cfg, 4, B, T, cuda, threads=threads)
        jf, js, jj = sk.fused_journal_rollout(cfg, 4, B, T, cuda,
                                              threads=threads)
        assert all(torch.equal(a, b) for a, b in zip(kf, pf))
        assert all(torch.equal(a, b) for a, b in zip(jf, pf))
        assert _ints(ks) == _ints(ps) == _ints(js)
        assert torch.equal(jj, pj)
    fa, _ = sk.fused_rollout(cfg, 4, B, T // 2, cuda)
    fb, _ = sk.fused_rollout(cfg, 4, B, T - T // 2, cuda, init_fields=fa,
                             step_offset=T // 2)
    assert all(torch.equal(a, b) for a, b in zip(fb, pf))


@pytest.mark.cuda
@pytest.mark.parametrize("board", BOARDS)
def test_kernels_odd_steps_and_unwalkable_lanes(cuda, board):
    """A partial last tile of step codes (37 steps), no steps at all, and
    lanes the step table cannot start from (a player without the ball in
    a goal column: their warps walk by arithmetic) equal the plain
    versions; a block whose shared memory does not fit is refused."""
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B = 1024
    fields = [f.clone() for f in sk.fused_rollout(cfg, 2, B, 50, cuda)[0]]
    fields[0][::5], fields[1][::5], fields[4][::5] = \
        cfg.goal_row_bounds[0], 0, 1
    for T in (37, 0):
        got = sk.fused_journal_rollout(cfg, 6, B, T, cuda, init_fields=fields,
                                       step_offset=50)
        want = sk.fused_journal_rollout_plain(cfg, 6, B, T, cuda,
                                              init_fields=fields,
                                              step_offset=50)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert _ints(got[1]) == _ints(want[1])
        assert torch.equal(got[2], want[2])
    if board == (5, 4):
        with pytest.raises(ValueError, match="shared memory"):
            sk.fused_rollout(cfg, 0, B, 8, cuda, threads=224)


@pytest.mark.cuda
def test_kernels_equal_cpu_plain_versions(cuda):
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    cf, cs, cj = sk.fused_journal_rollout(cfg, 8, 1024, 32, "cpu")
    gf, gs, gj = sk.fused_journal_rollout(cfg, 8, 1024, 32, cuda)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(gf, cf))
    assert torch.equal(gj.cpu(), cj) and _ints(gs) == _ints(cs)


@pytest.mark.cuda
def test_launch_is_counted(cuda):
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    sk.reset_launch_counts()
    sk.fused_rollout(cfg, 0, 1024, 8, cuda)
    sk.fused_rollout_plain(cfg, 0, 1024, 8, cuda)
    assert sk.launch_counts == {"fused_rollout": 1,
                                "fused_journal_rollout": 0,
                                "multigrid_rollout": 0, "alt_rollout": 0}


# ----------------------------------------------------------------------
# K5: the packed minimax-Q learner chunk
# ----------------------------------------------------------------------

def _learner_inputs(cfg, B, device, seed=1):
    """A non-uniform table with non-zero v, made from a numpy seed, and the
    initial fields."""
    import numpy as np
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    nS = len(lk._cell_rows(cfg))
    rng = np.random.default_rng(seed)
    pa, pb = (torch.tensor(rng.dirichlet(np.ones(5), nS), dtype=torch.float32,
                           device=device) for _ in range(2))
    v = torch.tensor(rng.uniform(-1, 1, nS), dtype=torch.float32,
                     device=device)
    return lk.pack_m2(cfg, pa, pb, v, 0.2), lk.init_state_fields(cfg, B,
                                                                  device)


def _same_chunk(a, b):
    (fa, (ra, ca), sa), (fb, (rb, cb), sb) = a, b
    return (all(torch.equal(x, y.to(x.device)) for x, y in zip(fa, fb))
            and torch.equal(ra, rb.to(ra.device))
            and torch.equal(ca, cb.to(ca.device))
            and _ints(sa) == _ints(sb))


@pytest.mark.cuda
@pytest.mark.parametrize("board", BOARDS)
def test_learner_kernel_equals_plain_version(cuda, board):
    """K5 equals its plain version bit for bit (fields, stats, counts and
    the int64 residual sums) at the default lanes per block and at sizes
    that leave a ragged last block, from states the walk table cannot
    start from (goal states), and on a small input equals the plain
    version run on the CPU."""
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B, T = 2048, 32
    table, fields = _learner_inputs(cfg, B, cuda)
    plain = lk.packed_learner_chunk_plain(cfg, 5, table, fields, B, T, 0.99)
    for threads in (None, 32, 96, 480):
        got = lk.packed_learner_chunk(cfg, 5, table, fields, B, T, 0.99,
                                      threads=threads)
        assert _same_chunk(got, plain)
    bad = [f.clone() for f in fields]
    bad[0][::7], bad[1][::7], bad[4][::7] = cfg.goal_row_bounds[0], \
        cfg.W - 1, 0
    assert _same_chunk(
        lk.packed_learner_chunk(cfg, 6, table, bad, B, 13, 0.9),
        lk.packed_learner_chunk_plain(cfg, 6, table, bad, B, 13, 0.9))
    table_c, fields_c = table.cpu(), tuple(f.cpu() for f in fields)
    cpu = lk.packed_learner_chunk(cfg, 5, table_c, fields_c, B, 8, 0.99)
    assert _same_chunk(lk.packed_learner_chunk(cfg, 5, table, fields, B, 8,
                                               0.99), cpu)


@pytest.mark.cuda
def test_learner_launch_is_counted_and_resume_is_exact(cuda):
    """The trainer launches K5 once a chunk, and 2 chunks equal 1 + 1
    through the resume dict, bit for bit."""
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    kw = dict(batch=1024, chunk_len=16, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, solver_iters=40, seed=3,
              device=cuda)
    lk.reset_launch_counts()
    whole = lk.fused_minimax_train(cfg, n_chunks=2, return_state=True, **kw)
    assert lk.launch_counts["packed_learner_chunk"] == 2
    assert sum(lk.launch_counts.values()) == 2
    r = lk.fused_minimax_train(cfg, n_chunks=1, return_state=True, **kw)[5]
    part = lk.fused_minimax_train(
        cfg, n_chunks=1, return_state=True,
        init=tuple(r[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
        fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
    for a, b in zip(whole[:4], part[:4]):
        assert torch.equal(a, b)
    assert torch.equal(whole[5]["n"], part[5]["n"])
    assert all(torch.equal(a, b) for a, b in zip(whole[5]["fields"],
                                                 part[5]["fields"]))


# ----------------------------------------------------------------------
# K3: the mixed-geometry rollout; K6/K7: the mixture and unpacked learners
# ----------------------------------------------------------------------

MIX = [(5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3)]


@pytest.mark.cuda
def test_multigrid_rollout_equals_plain_version(cuda):
    """K3 equals its plain version (fields and per-variant stats) at 64
    lanes per block (the default) and 96 (a ragged last block), a run
    split by step_offset equals one run, and a one-variant mixture equals
    K1."""
    cfgs = tuple(EnvConfig(*b) for b in MIX)
    B, T = 2048, 64
    pf, ps = sk.multigrid_rollout_plain(cfgs, 4, B, T, cuda)
    sk.reset_launch_counts()
    for threads in (None, 96):
        kf, ks = sk.multigrid_rollout(cfgs, 4, B, T, cuda, threads=threads)
        assert all(torch.equal(a, b) for a, b in zip(kf, pf))
        assert torch.equal(ks, ps)
    assert sk.launch_counts["multigrid_rollout"] == 2
    fa, sa = sk.multigrid_rollout(cfgs, 4, B, T // 2, cuda)
    fb, sb = sk.multigrid_rollout(cfgs, 4, B, T - T // 2, cuda,
                                  init_fields=fa, step_offset=T // 2)
    assert all(torch.equal(a, b) for a, b in zip(fb, pf))
    assert torch.equal(sa + sb, ps)
    one = EnvConfig(5, 4, 0.2)
    f1, s1 = sk.fused_rollout(one, 4, B, T, cuda)
    fm, sm = sk.multigrid_rollout((one,), 4, B, T, cuda)
    assert all(torch.equal(a, b) for a, b in zip(f1, fm))
    assert _ints(s1) == _ints(sm[0])


@pytest.mark.cuda
def test_split_k3_k7_partial_tiles_and_goal_states(cuda):
    """K3 and K7 (both sites) from lanes in goal states or a step before
    truncation, over a partial last tile of steps (37 and 13) and no steps
    (K3), at 32 lanes per block: equal to the plain versions."""
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    cfgs = tuple(EnvConfig(*b) for b in MIX)
    B = 1024
    fields = [f.clone() for f in sk.multigrid_rollout(cfgs, 2, B, 50, cuda)[0]]
    _, W, glo, *_ = sk.mg_planes(cfgs, B, cuda)[0]
    fields[0][::5], fields[1][::5], fields[4][::5] = glo[::5], W[::5] - 1, 0
    fields[5][1::3] = 99
    for T in (37, 0):
        got = sk.multigrid_rollout(cfgs, 6, B, T, cuda, init_fields=fields,
                                   step_offset=50, threads=32)
        want = sk.multigrid_rollout_plain(cfgs, 6, B, T, cuda,
                                          init_fields=fields, step_offset=50)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert torch.equal(got[1], want[1])
    for cfg in (EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2), cfgs):
        _, m = _mix_tables(cfg, cuda)
        state = lk.init_state_fields(cfg, B, cuda)
        planes, f = state if isinstance(cfg, tuple) else (None, state)
        f = [x.clone() for x in f]
        W = planes[1] if planes is not None else torch.full_like(f[0], cfg.W)
        glo = (planes[2] if planes is not None
               else torch.full_like(f[0], cfg.goal_row_bounds[0]))
        f[0][::7], f[1][::7], f[4][::7] = glo[::7], W[::7] - 1, 0
        f[5][2::3] = 99
        if planes is None:
            args = (cfg, 6, m, f, B, 13, 0.9)
            fn, plain = lk.learner_chunk, lk.learner_chunk_plain
        else:
            args = (cfg, 6, m, planes, f, B, 13, 0.9)
            fn = lk.multigrid_learner_chunk
            plain = lk.multigrid_learner_chunk_plain
        assert _same_chunk(fn(*args, threads=32), plain(*args))


def _mix_tables(cfg, device, seed=1, big=False):
    """Non-uniform pi, v and q tables made from a numpy seed: the packed
    and the unpacked table."""
    import numpy as np
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    nS = lk.n_states(cfg)
    rng = np.random.default_rng(seed)
    pa, pb = (torch.tensor(rng.dirichlet(np.ones(5), nS), dtype=torch.float32,
                           device=device) for _ in range(2))
    v = torch.tensor(rng.uniform(-1, 1, nS), dtype=torch.float32,
                     device=device)
    q = torch.tensor(rng.uniform(-1, 1, (nS, 5, 5)), dtype=torch.float32,
                     device=device)
    if big:
        v[::7] = 1e7
    return lk.pack_m2(cfg, pa, pb, v, 0.2), lk.pack_m(cfg, pa, pb, q, v, 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [MIX, [(5, 4, 0.2), (11, 7, 0.2)],
                                 [(5, 4, 0.2)], [(11, 7, 0.2)],
                                 [(5, 4, 0.2), (6, 5, 0.2)]],
                         ids=["3-variant", "5x4+11x7", "5x4", "11x7",
                              "5x4+6x5"])
def test_learner_kernels_k6_k7_equal_plain_versions(cuda, mix):
    """K6 and K7 (both sites) equal their plain versions bit for bit
    (fields, stats, counts, int64 sums, out-of-range count) at two sizes of
    lanes per block (the default and 96, a ragged last block), their
    prepared rows in L2 (the 3-variant mixture, 5x4+11x7, 11x7) or in
    shared memory (5x4, the --multigrid recipe's 5x4+6x5); K6 and K7 step
    the same fields, stats and counts; tables holding 1e7 are counted alike
    by kernels and plain versions."""
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    B, T = 2048, 32
    multi = len(mix) > 1
    cfg = tuple(EnvConfig(*b) for b in mix) if multi else EnvConfig(*mix[0])
    m2, m = _mix_tables(cfg, cuda)
    if multi:
        planes, fields = lk.init_state_fields(cfg, B, cuda)
        runs = {"multigrid_packed_learner_chunk": m2,
                "multigrid_learner_chunk": m}
        args = lambda t: (cfg, 5, t, planes, fields, B, T, 0.99)
    else:
        fields = lk.init_state_fields(cfg, B, cuda)
        runs = {"packed_learner_chunk": m2, "learner_chunk": m}
        args = lambda t: (cfg, 5, t, fields, B, T, 0.99)
    lk.reset_launch_counts()
    got = {}
    for name, table in runs.items():
        want = getattr(lk, name + "_plain")(*args(table))
        for threads in (None, 96):
            assert _same_chunk(getattr(lk, name)(*args(table),
                                                 threads=threads), want)
        assert int(want[2][3]) == 0
        got[name] = want
        assert lk.launch_counts[name] == 2
    (fa, (_, ca), sa), (fb, (_, cb), sb) = got.values()
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert torch.equal(ca, cb) and _ints(sa) == _ints(sb)
    assert int(ca.sum()) == B * T
    bad2, bad = _mix_tables(cfg, cuda, big=True)
    for name, table in zip(runs, (bad2, bad)):
        k = getattr(lk, name)(*args(table))[2][3]
        p = getattr(lk, name + "_plain")(*args(table))[2][3]
        assert int(k) == int(p) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_mixture_trainer_resume_is_exact(cuda, packed):
    """The tuple trainer launches K6 (or K7) once a chunk, 2 chunks equal
    1 + 1 through the resume dict, and a one-variant mixture trains like
    the static trainer."""
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    cfgs = (EnvConfig(5, 4, 0.2), EnvConfig(6, 5, 0.2))
    kw = dict(batch=1024, chunk_len=16, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, solver_iters=40, seed=3,
              packed=packed, device=cuda)
    lk.reset_launch_counts()
    whole = lk.fused_minimax_train(cfgs, n_chunks=2, return_state=True, **kw)
    name = ("multigrid_packed_learner_chunk" if packed
            else "multigrid_learner_chunk")
    assert lk.launch_counts[name] == 2 and sum(lk.launch_counts.values()) == 2
    r = lk.fused_minimax_train(cfgs, n_chunks=1, return_state=True, **kw)[5]
    part = lk.fused_minimax_train(
        cfgs, n_chunks=1, return_state=True,
        init=tuple(r[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
        fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
    for a, b in zip(whole[:4], part[:4]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(whole[5]["fields"],
                                                 part[5]["fields"]))
    one = lk.fused_minimax_train((cfgs[0],), n_chunks=2, **kw)
    static = lk.fused_minimax_train(cfgs[0], n_chunks=2, **kw)
    for a, b in zip(one[:4], static[:4]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# K8/K9: the independent-Q learner chunks
# ----------------------------------------------------------------------

def _iql_inputs(cfg, B, device, seed=1):
    """Q tables in [-1, 1] with near-ties (every third state's action 1
    one float32 step above action 0), made from a numpy seed, as the
    chunk's table; and the initial fields."""
    import numpy as np
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    nS = len(ik.lk._cell_rows(cfg))
    rng = np.random.default_rng(seed)
    qa, qb = (torch.tensor(rng.uniform(-1, 1, (nS, 5)), dtype=torch.float32)
              for _ in range(2))
    qa[::3, 1] = torch.nextafter(qa[::3, 0], torch.tensor(2.0))
    table = ik.pack_iql_table(cfg, qa.to(device), qb.to(device))
    return table, ik.init_iql_state_fields(cfg, B, device)


@pytest.mark.cuda
@pytest.mark.parametrize("board", BOARDS)
def test_iql_kernels_equal_plain_versions(cuda, board):
    """K8 and K9 equal their plain versions bit for bit (fields, stats,
    counts and the int64 sums) at the default lanes per block and at 96 (a
    ragged last block) with a step offset, and at 512 lanes x 129 steps
    (device-memory atomics); K8 and K9 step the same fields, stats and
    counts; on a small input the kernels equal the plain versions run on
    the CPU."""
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B, T, eps = 2048, 32, 19661
    table, fields = _iql_inputs(cfg, B, cuda)
    ik.reset_launch_counts()
    runs = {}
    for name in ("iql_packed_chunk", "iql_chunk"):
        kernel, plain = getattr(ik, name), getattr(ik, name + "_plain")
        want = plain(cfg, 5, eps, table, fields, B, T, 0.99, 7)
        for lanes in (None, 96):
            got = kernel(cfg, 5, eps, table, fields, B, T, 0.99, 7, lanes)
            assert _same_chunk(got, want)
        # past a block's private accumulators (512 lanes x 129 steps)
        assert _same_chunk(
            kernel(cfg, 6, eps, table, fields, B, 129, 0.99, 3, 512),
            plain(cfg, 6, eps, table, fields, B, 129, 0.99, 3))
        cpu = kernel(cfg, 5, eps, table.cpu(), [f.cpu() for f in fields], B,
                     8, 0.99, 7)
        assert _same_chunk(kernel(cfg, 5, eps, table, fields, B, 8, 0.99, 7),
                           cpu)
        runs[name] = want
    assert ik.launch_counts == {"iql_packed_chunk": 4, "iql_chunk": 4}
    (fa, (_, ca), sa), (fb, (_, cb), sb) = runs.values()
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert torch.equal(ca, cb) and _ints(sa) == _ints(sb)
    assert int(ca.sum()) == 2 * B * T


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_iql_launch_is_counted_and_resume_is_exact(cuda, packed):
    """The trainer launches K8 (or K9) once a chunk, and 2 chunks equal
    1 + 1 through the resume dict, bit for bit."""
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    kw = dict(batch=1024, chunk_len=16, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, seed=3, packed=packed)
    ik.reset_launch_counts()
    whole = ik.fused_iql_train(cfg, n_chunks=2, return_state=True, **kw)
    name = "iql_packed_chunk" if packed else "iql_chunk"
    assert ik.launch_counts[name] == 2 and sum(ik.launch_counts.values()) == 2
    r = ik.fused_iql_train(cfg, n_chunks=1, return_state=True, **kw)[3]
    part = ik.fused_iql_train(
        cfg, n_chunks=1, return_state=True, init=(r["q_a"], r["q_b"]),
        fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
    for a, b in zip(whole[:2], part[:2]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(whole[3]["fields"],
                                                 part[3]["fields"]))


# ----------------------------------------------------------------------
# K12/K13: the parity kernel, closed loop and scripted
# ----------------------------------------------------------------------

def _same_events(a, b):
    return all(torch.equal(x, y.to(x.device)) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("board", BOARDS)
def test_parity_kernels_equal_plain_versions(cuda, board):
    """K12 and K13 equal their plain versions (journal and the 8 final
    fields) for two block sizes, the default (64 lanes) and 80 lanes, which
    leaves a ragged last block, and count their launches; a block whose
    shared memory does not fit is refused."""
    import numpy as np
    from gym_soccer_tpu_torch.core import tables
    from gym_soccer_tpu_torch.ops import parity_kernel as pk
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B, E, T = 2048, 700, 200
    nS = tables.build_statespace(cfg).nS
    rng = np.random.RandomState(board[0])
    jr = pk.jointrow_raw(cfg, *rng.randint(0, 5, (2, nS)))
    rows = rng.randint(0, 25, (T, B)).astype(np.int32)
    seeds = np.arange(B) % 997
    plain = pk.parity_events_plain(cfg, seeds, jr, E, cuda)
    splain = pk.parity_scripted_events_plain(cfg, seeds, rows, 2 * T, cuda)
    pk.reset_launch_counts()
    for threads in (None, 80):
        assert _same_events(pk.parity_events(cfg, seeds, jr, E, cuda,
                                             threads=threads), plain)
        assert _same_events(pk.parity_scripted_events(
            cfg, seeds, rows, 2 * T, cuda, threads=threads), splain)
    assert pk.launch_counts == {"parity_events": 2,
                                "parity_scripted_events": 2}
    with pytest.raises(ValueError, match="budget"):
        pk.parity_events(cfg, seeds, jr, E, cuda, threads=128)
    assert bool((splain.steps > T).any()), "no lane ran past the script"


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [1, 2, 3])
def test_parity_kernels_blocks_smaller_than_the_isd(cuda, threads):
    """Blocks of fewer lanes than the 5x4 board's four ISD states still
    load every ISD word: K12 and K13 equal their plain versions, across a
    twist and many resets."""
    import numpy as np
    from gym_soccer_tpu_torch.core import tables
    from gym_soccer_tpu_torch.ops import parity_kernel as pk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    assert len(pk.build_pk(cfg).isd_cum) == 4
    B, E, T = 256, 700, 200
    rng = np.random.RandomState(threads)
    jr = pk.jointrow_raw(cfg, *rng.randint(
        0, 5, (2, tables.build_statespace(cfg).nS)))
    rows = rng.randint(0, 25, (T, B)).astype(np.int32)
    seeds = np.arange(B) * 13 + threads
    assert _same_events(pk.parity_events(cfg, seeds, jr, E, cuda,
                                         threads=threads),
                        pk.parity_events_plain(cfg, seeds, jr, E, cuda))
    assert _same_events(
        pk.parity_scripted_events(cfg, seeds, rows, 2 * T, cuda,
                                  threads=threads),
        pk.parity_scripted_events_plain(cfg, seeds, rows, 2 * T, cuda))


@pytest.mark.cuda
def test_parity_kernels_clamp_rows_like_the_plain_versions(cuda):
    """Joint rows outside [0, 25), in jr and in the script, given as tensors
    on the card: K12 and K13 equal their plain versions on the CPU."""
    import numpy as np
    import torch
    from gym_soccer_tpu_torch.core import tables
    from gym_soccer_tpu_torch.ops import parity_kernel as pk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    B, E, T = 128, 300, 100
    rng = np.random.RandomState(11)
    jr = pk.jointrow_raw(cfg, *rng.randint(
        0, 5, (2, tables.build_statespace(cfg).nS))).astype(np.int64)
    rows = rng.randint(0, 25, (T, B)).astype(np.int64)
    jr[::5], rows[::3, ::2] = 40, -9
    seeds = np.arange(B) + 5
    assert _same_events(
        pk.parity_events(cfg, seeds, torch.as_tensor(jr, device=cuda), E,
                         cuda),
        pk.parity_events(cfg, seeds, jr, E, "cpu"))
    assert _same_events(
        pk.parity_scripted_events(cfg, seeds, torch.as_tensor(
            rows, device=cuda), 2 * T, cuda),
        pk.parity_scripted_events(cfg, seeds, rows, 2 * T, "cpu"))


# ----------------------------------------------------------------------
# K4, K10, K11: the alternating-turn game
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("board", BOARDS)
def test_alt_rollout_equals_plain_version(cuda, board):
    """K4 equals its plain version at the default lanes per block and at
    sizes that leave a ragged last block, a run resumed through
    step_offset equals one run, lanes the tick table cannot start from
    walk by arithmetic, and the launches are counted."""
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B, T = 2048, 61
    pf, ps = sk.alt_rollout_plain(cfg, 4, B, T, cuda)
    sk.reset_launch_counts()
    for threads in (None, 32, 96):
        kf, ks = sk.alt_rollout(cfg, 4, B, T, cuda, threads=threads)
        assert all(torch.equal(a, b) for a, b in zip(kf, pf))
        assert _ints(ks) == _ints(ps)
    fa, _ = sk.alt_rollout(cfg, 4, B, T // 2, cuda)
    fb, _ = sk.alt_rollout(cfg, 4, B, T - T // 2, cuda, init_fields=fa,
                           step_offset=T // 2)
    assert all(torch.equal(a, b) for a, b in zip(fb, pf))
    assert sk.launch_counts["alt_rollout"] == 5
    bad = [f.clone() for f in pf]
    bad[0][::7], bad[1][::7], bad[4][::7] = cfg.goal_row_bounds[0], 0, 1
    bad[5][::11] = 2
    kf, ks = sk.alt_rollout(cfg, 4, B, 40, cuda, init_fields=bad)
    qf, qs = sk.alt_rollout_plain(cfg, 4, B, 40, cuda, init_fields=bad)
    assert all(torch.equal(a, b) for a, b in zip(kf, qf))
    assert _ints(ks) == _ints(qs)


@pytest.mark.cuda
@pytest.mark.parametrize("board", BOARDS)
def test_altq_kernels_equal_plain_versions(cuda, board):
    """K10 and K11 equal their plain versions bit for bit (fields, stats,
    counts and the int64 sums) at 64 lanes per block (the default for 8192
    lanes), 96 (a ragged last block) and 32 with a step offset, across a
    step_offset split, and from goal-state, late-truncation and odd-turn
    lanes; K10 and K11 step the same fields, stats and counts; the
    trainer launches K10 once a chunk and resumes exactly."""
    import numpy as np
    from gym_soccer_tpu_torch.envs.soccer_alternating_env import (
        build_alt_tables)
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B, T, eps = 8192, 32, 19661
    nS = build_alt_tables(cfg).nS
    q = torch.tensor(np.random.default_rng(3).uniform(-1, 1, (nS, 5)),
                     dtype=torch.float32)
    q[::3, 1] = torch.nextafter(q[::3, 0], torch.tensor(2.0))
    table = ak.pack_alt_table(cfg, q.to(cuda))
    fields = ak.init_alt_state_fields(cfg, B, cuda)
    ak.reset_launch_counts()
    runs = {}
    for name in ("altq_packed_chunk", "altq_chunk"):
        kernel, plain = getattr(ak, name), getattr(ak, name + "_plain")
        want = plain(cfg, 5, eps, table, fields, B, T, 0.99, 7)
        for threads in (None, 96, 32):
            got = kernel(cfg, 5, eps, table, fields, B, T, 0.99, 7, threads)
            assert _same_chunk(got, want)
        h = T // 2
        fa, (sa, ca), ta = kernel(cfg, 5, eps, table, fields, B, h, 0.99, 7)
        fb, (sb, cb), tb = kernel(cfg, 5, eps, table, fa, B, T - h, 0.99,
                                  7 + h)
        assert all(torch.equal(x, y) for x, y in zip(fb, want[0]))
        assert torch.equal(sa + sb, want[1][0])
        assert torch.equal(ca + cb, want[1][1])
        assert [x + y for x, y in zip(_ints(ta), _ints(tb))] == \
            _ints(want[2])
        odd = [f.clone() for f in fields]
        lo = cfg.goal_row_bounds[0]
        odd[1][5::97], odd[0][5::97], odd[4][5::97] = cfg.W - 1, lo, 0
        odd[2][40::131], odd[3][40::131], odd[4][40::131] = lo, 0, 1
        odd[6][::3] = cfg.max_steps - 3
        odd[5][7::301] = 2
        assert _same_chunk(kernel(cfg, 4, 0, table, odd, B, 24, 0.9, 21),
                           plain(cfg, 4, 0, table, odd, B, 24, 0.9, 21))
        runs[name] = want
    assert ak.launch_counts == {"altq_packed_chunk": 6, "altq_chunk": 6}
    (fa, (_, ca), sa), (fb, (_, cb), sb) = runs.values()
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert torch.equal(ca, cb) and _ints(sa) == _ints(sb)
    assert int(ca.sum()) == B * T
    kw = dict(batch=1024, chunk_len=16, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, seed=3)
    ak.reset_launch_counts()
    whole = ak.fused_altq_train(cfg, n_chunks=2, return_state=True, **kw)
    assert ak.launch_counts == {"altq_packed_chunk": 2, "altq_chunk": 0}
    r = ak.fused_altq_train(cfg, n_chunks=1, return_state=True, **kw)[2]
    part = ak.fused_altq_train(cfg, n_chunks=1, return_state=True,
                               init=r["q"], fields_init=r["fields"],
                               start_chunk=r["next_chunk"], **kw)
    assert torch.equal(whole[0], part[0])
    assert all(torch.equal(a, b) for a, b in zip(whole[2]["fields"],
                                                 part[2]["fields"]))


# ----------------------------------------------------------------------
# R1: the RM+ solve; the trainers' grouped dispatch modes
# ----------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("games,iters", [(761, 400), (11705, 60), (64, 1),
                                         (33, 0), (7, 300), (1, 300)])
def test_rmplus_kernel_equals_plain_version(cuda, games, iters):
    """R1 equals the plain version on the card bit for bit (NaN for NaN at
    iters == 0), on random games with near-ties among them, also where the
    games leave a warp's lane groups partly empty (7 games, 1 game); it
    takes only float32 games of 5 actions, and counts its launches."""
    import numpy as np

    from gym_soccer_tpu_torch.agents import learners
    rng = np.random.default_rng(games + iters)
    M = rng.uniform(-1, 1, (games, 5, 5)).astype(np.float32)
    M[::3] = np.round(M[::3] * 4) / 4
    M = torch.tensor(M, device=cuda)
    learners.reset_launch_counts()
    got = learners.solve_matrix_games(M, iters)
    assert learners.launch_counts == {"solve_matrix_games": 1}
    want = learners.solve_matrix_games_plain(M, iters)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="float32"):
        learners.solve_matrix_games(M.double(), iters)
    with pytest.raises(ValueError, match="float32"):
        learners.solve_matrix_games(M[:, :4, :4], iters)


def _grouped_runs(cuda):
    """(name, per-chunk run, grouped run, launch counter dict, kernel) of
    each trainer at 1024 lanes x 7 chunks of 16 steps in segments of 3,
    under annealed schedules."""
    import numpy as np

    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    mix = (cfg, EnvConfig(width=6, height=5, slip_prob=0.2))
    kw = dict(batch=1024, n_chunks=7, chunk_len=16, lr=0.5, eps=0.35,
              eps_halflife=64, eps_min=0.1, lr_anneal_start=2,
              lr_anneal_tau=3.0, lr_anneal_pow=1.2, seed=3, device=cuda,
              return_state=True)
    mm = dict(kw, solver_iters=40, avg_after=3, avg_q=True)
    opp = np.random.default_rng(2).integers(0, 5, 761)
    return [
        ("K5", lambda **g: lk.fused_minimax_train(cfg, **mm, **g),
         lk.launch_counts, "packed_learner_chunk"),
        ("K7", lambda **g: lk.fused_minimax_train(cfg, packed=False, **mm,
                                                  **g),
         lk.launch_counts, "learner_chunk"),
        ("K6", lambda **g: lk.fused_minimax_train(mix, **mm, **g),
         lk.launch_counts, "multigrid_packed_learner_chunk"),
        ("K7-multigrid", lambda **g: lk.fused_minimax_train(
            mix, packed=False, **mm, **g),
         lk.launch_counts, "multigrid_learner_chunk"),
        ("K5-best-response", lambda **g: lk.fused_best_response_train(
            cfg, opp, "player_b", **kw, **g),
         lk.launch_counts, "packed_learner_chunk"),
        ("K8", lambda **g: ik.fused_iql_train(cfg, **kw, **g),
         ik.launch_counts, "iql_packed_chunk"),
        ("K9", lambda **g: ik.fused_iql_train(cfg, packed=False, **kw, **g),
         ik.launch_counts, "iql_chunk"),
        ("K10", lambda **g: ak.fused_altq_train(cfg, **kw, **g),
         ak.launch_counts, "altq_packed_chunk"),
        ("K11", lambda **g: ak.fused_altq_train(cfg, packed=False, **kw,
                                                **g),
         ak.launch_counts, "altq_chunk"),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(9), ids=["K5", "K7", "K6",
                                                 "K7-multigrid", "K5-br",
                                                 "K8", "K9", "K10", "K11"])
def test_grouped_run_equals_per_chunk_run(cuda, index):
    """Each trainer's grouped mode (two CUDA-graph replays of 3 chunks and
    one chunk more) equals its per-chunk run bit for bit, with its chunk
    kernel and, for minimax, R1 launched replays x 3 + 1 times."""
    from gym_soccer_tpu_torch.agents import learners
    name, train, counts, kernel = _grouped_runs(cuda)[index]
    per = train()
    for d in (counts, learners.launch_counts):
        for k in d:
            d[k] = 0
    timing = {}
    grouped = train(chunks_per_dispatch=3, timing=timing)
    torch.cuda.synchronize()
    assert counts[kernel] == 7 and sum(counts.values()) == 7
    assert timing["replays"] == 2 and timing["chunks_per_replay"] == 3
    if name.startswith(("K5", "K6", "K7")) and "best" not in name:
        # 7 re-solves and the final solve of the averaged Q
        assert learners.launch_counts["solve_matrix_games"] == 8
    n = len(per) - 2   # the tensors before the history
    for a, b in zip(per[:n], grouped[:n]):
        assert torch.equal(a, b)
    for key, x in per[-1].items():
        y = grouped[-1][key]
        if key == "fields":
            assert all(torch.equal(f, g) for f, g in zip(x, y))
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
    assert len(grouped[-2]) == 7


@pytest.mark.cuda
def test_chunk_kernels_read_their_scalars_from_device_memory(cuda):
    """K5-K11 with their seed (K8-K11: seed, eps_int, step offset) in an
    int32 tensor on the card equal the by-value calls bit for bit."""
    import numpy as np

    from gym_soccer_tpu_torch.envs.soccer_alternating_env import \
        build_alt_tables
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    mix = (cfg, EnvConfig(width=6, height=5, slip_prob=0.2))
    rng = np.random.default_rng(8)
    B, T = 2048, 24
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda)
    for c in (cfg, mix):
        nS = lk.n_states(c)
        pa, pb = (torch.tensor(rng.dirichlet(np.ones(5), nS),
                               dtype=torch.float32, device=cuda)
                  for _ in range(2))
        v = torch.tensor(rng.uniform(-1, 1, nS), dtype=torch.float32,
                         device=cuda)
        q = torch.tensor(rng.uniform(-1, 1, (nS, 5, 5)), dtype=torch.float32,
                         device=cuda)
        state = lk.init_state_fields(c, B, cuda)
        args = state if isinstance(c, tuple) else (state,)
        for packed in (True, False):
            table = (lk.pack_m2(c, pa, pb, v, 0.2) if packed
                     else lk.pack_m(c, pa, pb, q, v, 0.2))
            fn = ((lk.multigrid_packed_learner_chunk if packed
                   else lk.multigrid_learner_chunk) if isinstance(c, tuple)
                  else lk.packed_learner_chunk if packed
                  else lk.learner_chunk)
            assert _same_chunk(fn(c, seed, table, *args, B, T),
                               fn(c, 123457, table, *args, B, T))
    scalars = torch.tensor([99, 20000, 640], dtype=torch.int32, device=cuda)
    nS = lk.n_states(cfg)
    qa, qb = (torch.tensor(rng.uniform(-1, 1, (nS, 5)), dtype=torch.float32,
                           device=cuda) for _ in range(2))
    table = ik.pack_iql_table(cfg, qa, qb)
    fields = ik.init_iql_state_fields(cfg, B, cuda)
    for fn in (ik.iql_packed_chunk, ik.iql_chunk):
        assert _same_chunk(fn(cfg, scalars, None, table, fields, B, T),
                           fn(cfg, 99, 20000, table, fields, B, T, 0.99, 640))
    nA = build_alt_tables(cfg).nS
    table = ak.pack_alt_table(cfg, torch.tensor(
        rng.uniform(-1, 1, (nA, 5)), dtype=torch.float32, device=cuda))
    fields = ak.init_alt_state_fields(cfg, B, cuda)
    for fn in (ak.altq_packed_chunk, ak.altq_chunk):
        assert _same_chunk(fn(cfg, scalars, None, table, fields, B, T),
                           fn(cfg, 99, 20000, table, fields, B, T, 0.99, 640))


@pytest.mark.cuda
@pytest.mark.parametrize("count,salt", [(1, 0), (2, 9), (4, 0), (7, 1)])
def test_t1_equals_its_plain_version(cuda, count, salt):
    """T1 (per-lane threefry uniforms) bit-equal to its plain version on
    the card and on the CPU, counters up to 2**31 - 1; one launch a call."""
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    g = torch.Generator().manual_seed(count)
    key = torch.randint(0, 2 ** 32, (3000, 2), generator=g,
                        dtype=torch.int64)
    n = torch.randint(0, 2 ** 31 - 1, (3000,), generator=g,
                      dtype=torch.int32)
    n[:2] = torch.tensor([0, 2 ** 31 - 1], dtype=torch.int32)
    tk.reset_launch_counts()
    got = tk.threefry_uniforms(key.to(cuda), n.to(cuda), count, salt)
    assert tk.launch_counts["threefry_uniforms"] == 1
    assert torch.equal(got, tk.threefry_uniforms_plain(
        key.to(cuda), n.to(cuda), count, salt))
    assert torch.equal(got.cpu(), tk.threefry_uniforms(key, n, count, salt))


@pytest.mark.cuda
def test_learner_graph_mode_counts_every_step(cuda):
    """The HBM-table learners' grouped mode on the card (150 steps at
    resolve_every 8: two replays of 64 steps, two periods on their own and
    a tail of 6): T1 (the action draw) and S1 (the engine's step) counted
    once a step and R1 once a re-solve, as for single steps; the tables
    finite."""
    from gym_soccer_tpu_torch.agents import learners
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.ops import engine_kernel as ek
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    st = learners.minimax_init(cfg, threefry.key(0), 512, cuda)
    tk.reset_launch_counts()
    ek.reset_launch_counts()
    learners.reset_launch_counts()
    st, td = learners.minimax_train(
        cfg, learners.MinimaxQConfig(resolve_every=8), st, 150)
    torch.cuda.synchronize()
    assert tk.launch_counts["threefry_uniforms"] == 150
    assert ek.launch_counts["engine_step"] == 150
    assert learners.launch_counts["solve_matrix_games"] == 150 // 8
    assert int(st.step) == 150 and td.shape == (150,)
    assert bool(torch.isfinite(st.q).all()) and float(st.v.abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["threefry", "counter"])
@pytest.mark.parametrize("autoreset", [True, False])
def test_s1_equals_step_plain(cuda, rng, autoreset):
    """S1 (the engine's step) bit-equal to step_plain on the card and on
    the CPU in every state and StepOut field, on 5x4 and 11x7 at slip 0
    and 0.2, from goal-state, wrapping and truncating lanes, under int32
    and int64 actions; one launch a step."""
    from chip_smoke import engine_start
    from gym_soccer_tpu_torch.core import batch
    from gym_soccer_tpu_torch.ops import engine_kernel as ek
    for (w, h), q in [(b, q) for b in BOARDS for q in (0.0, 0.2)]:
        cfg = EnvConfig(width=w, height=h, slip_prob=q)
        st = engine_start(torch, cfg, rng, 3000, cuda, w)
        g = torch.Generator().manual_seed(w)
        for s in range(12):
            acts = torch.randint(0, 5, (2, 3000), generator=g).to(cuda)
            if s % 2:
                acts = acts.int()
            ek.reset_launch_counts()
            got = batch.step(cfg, st, acts[0], acts[1], autoreset, rng)
            assert ek.launch_counts["engine_step"] == 1
            want = batch.step_plain(cfg, st, acts[0], acts[1], autoreset,
                                    rng)
            cpu = batch.step_plain(
                cfg, batch.EnvState(*(f.cpu() for f in st)), acts[0].cpu(),
                acts[1].cpu(), autoreset, rng)
            for a, b, c in zip((*got[0], *got[1]), (*want[0], *want[1]),
                               (*cpu[0], *cpu[1])):
                assert a.dtype == b.dtype and torch.equal(a, b)
                assert torch.equal(a.cpu(), c)
            st = got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["threefry", "counter"])
@pytest.mark.parametrize("autoreset", [True, False])
def test_s1_designs_equal_step_plain(cuda, rng, autoreset):
    """S1's builds at each other lanes a block and its previous design
    (ops/engine_variants) bit-equal to step_plain in every state and
    StepOut field, on 5x4 and 11x7 at slip 0 and 0.2, from goal-state,
    wrapping and truncating lanes, under int32 and int64 actions, and
    each replayed from a CUDA graph equal to its eager call."""
    from chip_smoke import engine_start
    from gym_soccer_tpu_torch.core import batch
    from gym_soccer_tpu_torch.ops import engine_kernel as ek
    from gym_soccer_tpu_torch.ops import engine_variants as ev
    for (w, h), q in [(b, q) for b in BOARDS for q in (0.0, 0.2)]:
        cfg = EnvConfig(width=w, height=h, slip_prob=q)
        st = engine_start(torch, cfg, rng, 3000, cuda, w + 1)
        g = torch.Generator().manual_seed(w + 1)
        for s in range(6):
            acts = torch.randint(0, 5, (2, 3000), generator=g).to(cuda)
            if s % 2:
                acts = acts.int()
            want = batch.step_plain(cfg, st, acts[0], acts[1], autoreset,
                                    rng)
            ek.reset_launch_counts()
            for design in ev.designs():
                got = ev.engine_step_on(design, cfg, st, acts[0], acts[1],
                                        autoreset, rng)
                assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b
                           in zip((*got[0], *got[1]), (*want[0], *want[1]),
                                  strict=True)), design
            assert ek.launch_counts["engine_step"] == 0   # not counted
            st = want[0]
    aa, ab = torch.randint(0, 5, (2, 3000), generator=g).to(cuda)
    for design in ev.designs():
        eager = ev.engine_step_on(design, cfg, st, aa, ab, autoreset, rng)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ev.engine_step_on(design, cfg, st, aa, ab, autoreset,
                                         rng)
        for x in (*captured[0][:7], *captured[1]):
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(
            (*captured[0], *captured[1]), (*eager[0], *eager[1])))


@pytest.mark.cuda
def test_s1_replays_from_a_graph(cuda):
    """S1 through batch.step captured in a CUDA graph and replayed equals
    its eager call, the reset table riding in the captured arguments."""
    from chip_smoke import engine_start
    from gym_soccer_tpu_torch.core import batch
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    st = engine_start(torch, cfg, "threefry", 3000, cuda, 5)
    aa, ab = torch.randint(0, 5, (2, 3000), device=cuda)
    eager = batch.step(cfg, st, aa, ab)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = batch.step(cfg, st, aa, ab)
    for x in (*captured[0][:7], *captured[1]):
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        (*captured[0], *captured[1]), (*eager[0], *eager[1])))
    assert int(eager[1].done.sum()) and int(eager[1].truncated.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("autoreset", [True, False])
def test_s2_equals_step_plain(cuda, autoreset):
    """S2 (the mixed-geometry engine's step) bit-equal to step_plain and
    step_obs_plain on the card and on the CPU in every output, on each of
    chip_smoke's mixtures, from goal-state, wrapping and truncating lanes,
    int32 and int64 actions, with and without the observations; one launch
    a step.  Its previous design (ops/mixed_alt_variants) and the kernel at
    each lanes-a-block shape equal them too."""
    from chip_smoke import S2_MIXTURES, _step_outputs, mixed_start
    from gym_soccer_tpu_torch.core import multigrid as mg
    from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
    from gym_soccer_tpu_torch.ops import mixed_alt_variants as mv
    for k, mix in enumerate(S2_MIXTURES.values()):
        cfgs = tuple(EnvConfig(*b) for b in mix)
        codec = mg.build_codec(cfgs)
        st = mixed_start(torch, cfgs, 3000, cuda, k)
        g = torch.Generator().manual_seed(k)
        for s in range(12):
            aa, ab = torch.randint(0, 5, (2, 3000), generator=g).to(cuda)
            if s % 2:
                aa, ab = aa.int(), ab.int()
            mk.reset_launch_counts()
            if s % 4 < 2:
                got = mg.step_obs(codec, st, aa, ab, autoreset)
                want = mg.step_obs_plain(codec, st, aa, ab, autoreset)
                cpu = mg.step_obs_plain(codec, _cpu_state(st), aa.cpu(),
                                        ab.cpu(), autoreset)
            else:
                got = mg.step(st, aa, ab, autoreset)
                want = mg.step_plain(st, aa, ab, autoreset)
                cpu = mg.step_plain(_cpu_state(st), aa.cpu(), ab.cpu(),
                                    autoreset)
            assert mk.launch_counts["multigrid_step"] == 1
            for a, b, c in zip(*(_step_outputs(r, 7)
                                 for r in (got, want, cpu))):
                assert a.dtype == b.dtype and torch.equal(a, b)
                assert torch.equal(a.cpu(), c)
            geo = st.geo
            planes = (geo.H, geo.W, geo.glo, geo.ghi, geo.vid, geo.slip)
            maps = mg._codec_on(codec.cfgs, cuda) if s % 4 < 2 else None
            for design in mv.designs():
                ints, rew, flags = mv.multigrid_step_on(
                    design, st[:7], st.key, aa, ab, planes, geo.max_steps,
                    autoreset, maps)
                other = [*ints[:7], rew, *flags, *ints[7:]]
                assert all(torch.equal(a, b) for a, b in
                           zip(other, _step_outputs(want, 7), strict=True))
            st = got[0]


def _cpu_state(st):
    """A multigrid state with every tensor on the CPU."""
    return st._replace(**{f: getattr(st, f).cpu() for f in st._fields[:8]},
                       geo=st.geo._replace(**{
                           f: getattr(st.geo, f).cpu()
                           for f in st.geo._fields[:6]}))


@pytest.mark.cuda
@pytest.mark.parametrize("autoreset", [True, False])
def test_s3_equals_alt_step_plain(cuda, autoreset):
    """S3 (the alternating engine's tick) bit-equal to alt_step_plain and
    alt_step_obs_plain on the card and on the CPU in every output, on 5x4
    and 11x7 at slip 0.2, from both movers, goal-state, wrapping and
    truncating lanes, int32 and int64 actions; one launch a tick.  Its
    previous design (ops/mixed_alt_variants) and the kernel at each
    lanes-a-block shape equal them too."""
    from chip_smoke import _step_outputs, alt_start
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
    from gym_soccer_tpu_torch.ops import mixed_alt_variants as mv
    for w, h in BOARDS:
        cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
        st = alt_start(torch, cfg, 3000, cuda, w)
        g = torch.Generator().manual_seed(w)
        for s in range(12):
            a = torch.randint(0, 5, (3000,), generator=g).to(cuda)
            a = a.int() if s % 2 else a
            cst = alt.AltEnvState(*(f.cpu() for f in st))
            mk.reset_launch_counts()
            if s % 4 < 2:
                got = alt.alt_step_obs(cfg, st, a, autoreset)
                want = alt.alt_step_obs_plain(cfg, st, a, autoreset)
                cpu = alt.alt_step_obs_plain(cfg, cst, a.cpu(), autoreset)
            else:
                got = alt.alt_step(cfg, st, a, autoreset)
                want = alt.alt_step_plain(cfg, st, a, autoreset)
                cpu = alt.alt_step_plain(cfg, cst, a.cpu(), autoreset)
            assert mk.launch_counts["alt_step"] == 1
            for x, y, z in zip(*(_step_outputs(r, 8)
                                 for r in (got, want, cpu))):
                assert x.dtype == y.dtype and torch.equal(x, y)
                assert torch.equal(x.cpu(), z)
            for design in mv.designs():
                ints, rew, flags = mv.alt_step_on(design, cfg, st[:8],
                                                  st.key, a, autoreset)
                obs = ints[8:] if s % 4 < 2 else ()
                other = [*ints[:8], rew, *flags, *obs]
                assert all(torch.equal(x, y) for x, y in
                           zip(other, _step_outputs(want, 8), strict=True))
            st = got[0]


@pytest.mark.cuda
def test_mixture_and_turn_based_learners_replay_s2_s3(cuda):
    """The mixture minimax-Q and turn-based Q learners' grouped mode on
    the card (150 steps: two replays of 64 steps and a tail) launch S2 or
    S3 once a step, as single steps do, and equal the same calls on the
    CPU in every state leaf."""
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    mix = (cfg, EnvConfig(width=6, height=5, slip_prob=0.2))
    mc = L.MinimaxQConfig(resolve_every=64)
    runs = {"multigrid_step": (
                L.multigrid_minimax_init(mix, threefry.key(3), 256, "cpu"),
                lambda s: L.multigrid_minimax_train(mix, mc, s, 150)),
            "alt_step": (L.altq_init(cfg, threefry.key(2), 256, "cpu"),
                         lambda s: L.altq_train(cfg, L.AltQConfig(), s, 150))}
    for name, (st, train) in runs.items():
        card = L._rebuild(st, [t.to(cuda) for t in L._tensors(st)])
        mk.reset_launch_counts()
        got, _ = train(card)
        torch.cuda.synchronize()
        assert mk.launch_counts == {"multigrid_step": 0, "alt_step": 0,
                                    name: 150}
        want, _ = train(st)
        assert all(torch.equal(a.cpu(), b) for a, b in
                   zip(L._tensors(got), L._tensors(want)))


@pytest.mark.cuda
def test_keyed_entry_equals_its_plain_version(cuda):
    """T1's keyed entry bit-equal to its plain versions on the card and on
    the CPU at odd shapes and indices up to 2**31 - 1; one launch a
    call."""
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    key = threefry.key(7, cuda)
    for shape in ((3,), (2, 7), (5, 1, 3), (2, 1024), (2, 8192)):
        for i in (0, 37, 2 ** 31 - 1):
            tk.reset_launch_counts()
            u = tk.keyed_uniform(key, i, shape)
            r = tk.keyed_randint(key, i, shape, -3, 100_000)
            assert tk.launch_counts["threefry_keyed"] == 2
            assert torch.equal(u, tk.keyed_uniform_plain(key, i, shape))
            assert torch.equal(u.cpu(), tk.keyed_uniform(key.cpu(), i, shape))
            assert torch.equal(r, tk.keyed_randint_plain(key, i, shape, -3,
                                                         100_000))
            assert torch.equal(r.cpu(), tk.keyed_randint(
                key.cpu(), i, shape, -3, 100_000))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one cell", "minimax table", "3 cells",
                                  "one lane", "learner step 1",
                                  "learner step 64", "tiles"])
def test_a1_equals_its_plain_version(cuda, case):
    """A1 (the learners' scatter-add in lane order) bit-equal to its plain
    version (index_add_ on the CPU) in sums and counts on chip_smoke.py
    phase 50's inputs (the learner's own at its steps 1 and 64, a cell on
    both sides of every tile's edge with a run longer than a tile), one
    launch a call, and again from the replay of a CUDA graph that
    captured it, replayed twice."""
    import numpy as np
    from chip_smoke import bits_equal, scatter_inputs
    from gym_soccer_tpu_torch.ops import scatter_kernel as sc
    idx, v, n = scatter_inputs(np, case)
    gi, gv = torch.from_numpy(idx).to(cuda), torch.from_numpy(v).to(cuda)
    want = sc.scatter_add(torch.from_numpy(idx), torch.from_numpy(v), n)
    sc.reset_launch_counts()
    got = sc.scatter_add(gi, gv, n)
    assert sc.launch_counts["scatter_add"] == 1
    assert all(bits_equal(a.cpu(), b) for a, b in zip(got, want))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sc.scatter_add(gi, gv, n)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(bits_equal(a.cpu(), b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n_cells", [(300, 19025), (257, 255),
                                           (1000, 256), (2, 292625),
                                           (20000, 292625), (700, 1)])
def test_a1_small_blocks_and_dropped_cells(cuda, lanes, n_cells):
    """A1 in blocks of fewer warps, over one, two and three radix passes,
    bit-equal to a lane-order loop; cells outside [0, n) dropped."""
    import numpy as np
    from gym_soccer_tpu_torch.ops import scatter_kernel as sc
    rng = np.random.default_rng(lanes + n_cells)
    idx = rng.integers(-3, n_cells + 3, lanes).astype(np.int64)
    idx[: lanes // 3] = n_cells // 2
    v = (10.0 ** rng.uniform(-6, 2, lanes) * rng.choice(
        (-1.0, 1.0), lanes)).astype(np.float32)
    keep = (idx >= 0) & (idx < n_cells)
    want = np.zeros(n_cells, np.float32)
    for i in np.flatnonzero(keep):
        want[idx[i]] = np.float32(want[idx[i]] + v[i])
    sums, counts = sc.scatter_add(torch.from_numpy(idx).to(cuda),
                                  torch.from_numpy(v).to(cuda), n_cells)
    assert sums.cpu().numpy().view(np.uint32).tolist() == \
        want.view(np.uint32).tolist()
    assert counts.cpu().numpy().tolist() == np.bincount(
        idx[keep], minlength=n_cells).astype(np.float32).tolist()
