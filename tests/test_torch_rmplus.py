"""Kernel R1's arithmetic (gym_soccer_tpu_torch/ops/csrc/rmplus_kernel.cu)
on the CPU, where the kernel cannot run: a mirror of its lane-group loop
in numpy float32 / float64 scalars (each of a warp's 32 simulated lanes
computes its own actions' values and reads the group's sums from the
other lanes' registers in index order, as ``__shfl_sync`` gives them), at
5 and 10 lanes a game, and a per-game mirror of the previous design's
one-thread loop (csrc/rmplus_thread_kernel.cu), each held bit for bit to
``solve_matrix_games_plain`` on random games, near-ties, all-zero games,
at ``iters=0`` and at game counts that leave a warp partly empty; and
``solve_matrix_games``'s dispatch by device.  The kernel itself is held
to the plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py."""
import os

import numpy as np
import pytest
import torch

from gym_soccer_tpu_torch.agents import learners
from gym_soccer_tpu_torch.ops import rmplus_variants

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

f32, f64 = np.float32, np.float64


def _chain(acc, p, z):
    """float32(double(p) * double(z) + double(acc)): the kernel's
    __double2float_rn(__fma_rn(p, z, acc)), whose product is exact."""
    return f32(f64(p) * f64(z) + f64(acc))


def _seq_sum(a):
    s = a[0]
    for v in a[1:]:
        s = f32(s + v)
    return s


def _seq_dot(a, b):
    s = f32(a[0] * b[0])
    for i in range(1, 5):
        s = f32(s + f32(a[i] * b[i]))
    return s


def _strategy(r):
    s = _seq_sum(r)
    d = max(s, f32(1e-30))
    return [(v if v == 0 else f32(v / d)) if s > 0 else f32(0.2) for v in r]


def _clamp0(v):
    return v if v != v else max(v, f32(0.0))


def _payoffs(m, x, y):
    px, py = [], []
    for i in range(5):
        a = f32(m[i][0] * y[0])
        b = f32(m[0][i] * x[0])
        for j in range(1, 5):
            a = _chain(a, m[i][j], y[j])
            b = _chain(b, m[j][i], x[j])
        px.append(a)
        py.append(b)
    return px, py


def rmplus_mirror(m, iters: int):
    """One game's (value, x, y) as rmplus_kernel computes it."""
    m = [[f32(v) for v in row] for row in m]
    rx, ry, sx, sy = ([f32(0.0)] * 5 for _ in range(4))
    for t in range(iters):
        x, y = _strategy(rx), _strategy(ry)
        px, py = _payoffs(m, x, y)
        vx = _seq_dot(x, px)
        w = f64(t + 1)
        rx = [_clamp0(f32(r + f32(p - vx))) for r, p in zip(rx, px)]
        ry = [_clamp0(f32(r + -f32(p - vx))) for r, p in zip(ry, py)]
        sx = [f32(f64(a) * w + f64(s)) for a, s in zip(x, sx)]
        sy = [f32(f64(a) * w + f64(s)) for a, s in zip(y, sy)]
    with np.errstate(invalid="ignore"):
        nx, ny = _seq_sum(sx), _seq_sum(sy)
        x = [f32(s / nx) for s in sx]
        y = [f32(s / ny) for s in sy]
    _, py = _payoffs(m, x, y)
    return _seq_dot(py, y), x, y


class _Lane:
    """One simulated lane of rmplus_kernel: its game, its group's first
    lane and, for each slot k of the (player, action) pairs it owns, the
    player, the row or column of M (first entry in float32, the others in
    float64) and the registers r, s, z and pay."""

    def __init__(self, M, lane: int, warp: int, lanes: int):
        games = 32 // lanes
        spare = lane >= games * lanes
        group = games - 1 if spare else lane // lanes
        sub = lane - games * lanes if spare else lane % lanes
        self.base = group * lanes
        self.sub, action, me = sub, sub % 5, sub // 5
        first = warp * games + group
        self.writes = not spare and first < len(M)
        self.g = min(first, len(M) - 1)
        self.action = action
        self.player = [k if lanes == 5 else me for k in range(10 // lanes)]
        m = [[f32(v) for v in row] for row in M[self.g]]
        line = [m[action] if p == 0 else [row[action] for row in m]
                for p in self.player]
        self.m0 = [v[0] for v in line]
        self.md = [[f64(v) for v in ln[1:]] for ln in line]
        self.r = [f32(0.0)] * len(self.player)
        self.s = [f32(0.0)] * len(self.player)
        self.z, self.pay = list(self.r), list(self.r)


def _lane_mirror(M, iters: int, lanes: int):
    """Every game's (value, x, y) as rmplus_kernel computes them with
    ``lanes`` lanes a game (5: a lane owns an action of both players; 10:
    one player's action), warp by warp: each lane's own values, with the
    group's sums read from the other lanes' registers in index order; the
    spare lanes and the lanes of games past the last shadow the last game
    of their warp and write nothing."""
    n, games = len(M), 32 // lanes
    slot = (lambda p: p) if lanes == 5 else (lambda p: 0)

    def owner(ln, p, j):
        return ln.base + (j if lanes == 5 else 5 * p + j)

    def group_sum(warp, ln, reg, k, p):
        """group_sum(reg[k], base, p): register ``reg`` slot k of the
        owners of player p's actions, added in index order."""
        vals = [getattr(warp[owner(ln, p, j)], reg)[k] for j in range(5)]
        return _seq_sum(vals)

    def payoffs(warp):
        for ln in warp:
            ln.pay = []
            for k, p in enumerate(ln.player):
                q = 1 - p
                zq = [warp[owner(ln, q, j)].z[slot(q)] for j in range(5)]
                acc = f32(ln.m0[k] * zq[0])
                for j in range(1, 5):
                    acc = _chain(acc, ln.md[k][j - 1], zq[j])
                ln.pay.append(acc)

    value = np.full(n, np.nan, np.float32)
    x, y = np.full((n, 5), np.nan, np.float32), np.full((n, 5), np.nan,
                                                        np.float32)
    for w in range(-(-n // games)):
        warp = [_Lane(M, lane, w, lanes) for lane in range(32)]
        for t in range(iters):
            sums = [[group_sum(warp, ln, "r", k, p)
                     for k, p in enumerate(ln.player)] for ln in warp]
            for ln, sm in zip(warp, sums):
                ln.z = [_strategy_share(r, s) for r, s in zip(ln.r, sm)]
            payoffs(warp)
            for ln in warp:
                ln.prod = [f32(ln.z[0] * ln.pay[0])]
            vxs = [group_sum(warp, ln, "prod", 0, 0) for ln in warp]
            for ln, vx in zip(warp, vxs):
                for k, p in enumerate(ln.player):
                    d = f32(ln.pay[k] - vx)
                    ln.r[k] = _clamp0(f32(ln.r[k] + (d if p == 0 else -d)))
                    ln.s[k] = f32(f64(ln.z[k]) * f64(t + 1) + f64(ln.s[k]))
        sums = [[group_sum(warp, ln, "s", k, p)
                 for k, p in enumerate(ln.player)] for ln in warp]
        with np.errstate(invalid="ignore"):
            for ln, sm in zip(warp, sums):
                ln.z = [f32(s / d) for s, d in zip(ln.s, sm)]
        payoffs(warp)
        for ln in warp:
            ln.prod = [f32(ln.pay[slot(1)] * ln.z[slot(1)])]
        vals = [group_sum(warp, ln, "prod", 0, 1) for ln in warp]
        for ln, v in zip(warp, vals):
            if not ln.writes:
                continue
            for k, p in enumerate(ln.player):
                (x if p == 0 else y)[ln.g, ln.action] = ln.z[k]
            if ln.sub == 0:
                value[ln.g] = v
    return value, x, y


def _strategy_share(r, s):
    """rmplus_kernel's share(r, s)."""
    d = max(s, f32(1e-30))
    return (r if r == 0 else f32(r / d)) if s > 0 else f32(0.2)


def _games(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    M = rng.uniform(-1, 1, (n, 5, 5)).astype(np.float32)
    if kind == "near-ties":   # quarter steps: rows and columns that tie
        M = (np.round(M * 4) / 4).astype(np.float32)
        M[::2, :, 1] = M[::2, :, 0]
        M[1::2, 2] = M[1::2, 3]
    elif kind == "zero":
        M[:] = 0.0
    elif kind == "small":     # q-like values after a few updates
        M *= np.float32(1e-3)
    return M


@pytest.mark.parametrize("kind,iters", [
    ("random", 40), ("random", 1), ("near-ties", 40), ("zero", 7),
    ("small", 40), ("random", 0)])
def test_mirror_equals_plain_version(kind, iters):
    """The one-thread design's loop (csrc/rmplus_thread_kernel.cu), step
    for step, equals the plain version bit for bit (NaN where iters == 0,
    as 0 / 0)."""
    M = _games(kind, 12, seed=len(kind) + iters)
    want = learners.solve_matrix_games_plain(torch.tensor(M), iters)
    for g in range(len(M)):
        value, x, y = rmplus_mirror(M[g], iters)
        got = (np.array([value], np.float32), np.array(x, np.float32),
               np.array(y, np.float32))
        for a, b in zip(got, (w[g].reshape(-1).numpy() for w in want)):
            np.testing.assert_array_equal(a, b)
    if iters == 0:
        assert torch.isnan(want[1]).all() and torch.isnan(want[0]).all()


@pytest.mark.parametrize("lanes", [5, 10])
@pytest.mark.parametrize("kind,iters,games", [
    ("random", 40, 12), ("random", 1, 12), ("near-ties", 40, 12),
    ("zero", 7, 12), ("small", 40, 12), ("random", 0, 12),
    ("random", 30, 7), ("near-ties", 30, 1)])
def test_lane_mirror_equals_plain_version(kind, iters, games, lanes):
    """rmplus_kernel's lane-group loop, lane by lane, equals the plain
    version bit for bit (NaN where iters == 0): every lane of a group
    holds the same sums; 12 games leave the second warp's last groups past
    the last game at 5 lanes a game (6 a warp) and fill 4 warps at 10 (3
    a warp); 7 and 1 games leave a warp partly empty."""
    M = _games(kind, games, seed=len(kind) + iters + games)
    want = learners.solve_matrix_games_plain(torch.tensor(M), iters)
    got = _lane_mirror(M, iters, lanes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    if iters == 0:
        assert np.isnan(got[1]).all() and np.isnan(got[0]).all()


def test_solver_dispatches_on_the_device():
    """A CPU tensor runs the plain version; a tensor on a device with no
    kernel is refused, with no fallback."""
    M = torch.tensor(_games("random", 5, 3))
    for a, b in zip(learners.solve_matrix_games(M, 9),
                    learners.solve_matrix_games_plain(M, 9)):
        assert torch.equal(a, b)
    before = dict(learners.launch_counts)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        learners.solve_matrix_games(M.to("meta"), 9)
    assert learners.launch_counts == before


def test_plain_version_keeps_batch_shapes():
    M = torch.tensor(_games("random", 6, 4)).reshape(2, 3, 5, 5)
    v, x, y = learners.solve_matrix_games(M, 5)
    assert v.shape == (2, 3) and x.shape == y.shape == (2, 3, 5)
    flat = learners.solve_matrix_games(M.reshape(6, 5, 5), 5)
    assert torch.equal(v.reshape(6), flat[0])


@pytest.mark.parametrize("name", sorted(rmplus_variants.VARIANTS))
def test_rmplus_variants_patch_the_committed_kernel(name):
    """Each timed variant of R1 (ops/rmplus_variants.py) applies its
    patches, each to exactly one place in the committed source, and
    changes it unless it is the kernel itself or the previous design,
    which builds csrc/rmplus_thread_kernel.cu as it is (with the
    committed kernel's C interface, so one wrapper loads either)."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "rmplus_kernel.cu").read_text()
    got = rmplus_variants.variant_source(name, src)
    assert (got == src) == (name in ("kernel", rmplus_variants.PREVIOUS))
    for _, new in rmplus_variants.VARIANTS[name]:
        assert new in got
    thread = (_build.CSRC / rmplus_variants.THREAD_SOURCE).read_text()
    for fn in ("gst_rmplus_solve", "gst_rmplus_shape", "gst_error_string"):
        assert f" {fn}(" in src and f" {fn}(" in thread
    with pytest.raises(ValueError, match="matches 0 times"):
        rmplus_variants.variant_source("5 lanes a game", "no kernel here")
