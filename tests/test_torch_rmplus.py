"""Kernel R1's arithmetic (gym_soccer_tpu_torch/ops/csrc/rmplus_kernel.cu)
on the CPU, where the kernel cannot run: a per-game mirror of its loop in
numpy float32 / float64 scalars, in the order the kernel writes it, held
bit for bit to ``solve_matrix_games_plain`` on random games, near-ties,
all-zero games and at ``iters=0``; and ``solve_matrix_games``'s dispatch
by device.  The kernel itself is held to the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py."""
import os

import numpy as np
import pytest
import torch

from gym_soccer_tpu_torch.agents import learners

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
    """The .cu loop's arithmetic, step for step, equals the plain version
    bit for bit (NaN where iters == 0, as 0 / 0)."""
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
