"""Kernel A1's contract on the CPU (ops/scatter_kernel.py): the plain
version of ``scatter_add`` (``index_add_`` on the CPU) adds each cell's
values in lane order from 0, as XLA's scatter-add on the CPU does
(``jnp.zeros(n).at[idx].add(v)``, the JAX package's HBM-table learners'
update), bit for bit; a sum in reversed order differs on the same
inputs, so the comparison sees the order; the counts are exact.  The
inputs are chip_smoke.py phase 50's crafted ones (every lane on one cell,
8192 lanes over the 5x4 minimax table, 8192 over 3 cells) and one lane.
The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py phase 50)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gym_soccer_tpu_torch.ops import scatter_kernel as sc

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CASES = [*chip_smoke.SCATTER_CASES, "one lane"]


def _inputs(case):
    return chip_smoke.scatter_inputs(np, case)


def _loop(idx, values, n_cells, order):
    """float32 sums of ``values`` at ``idx``, one lane at a time in
    ``order``, from 0."""
    out = np.zeros(n_cells, np.float32)
    for i in order:
        out[idx[i]] = np.float32(out[idx[i]] + values[i])
    return out


@pytest.mark.parametrize("case", CASES)
def test_plain_version_adds_in_lane_order_as_xla(case):
    idx, values, n_cells = _inputs(case)
    sums, counts = sc.scatter_add(torch.from_numpy(idx),
                                  torch.from_numpy(values), n_cells)
    assert sums.dtype == counts.dtype == torch.float32
    assert sums.shape == counts.shape == (n_cells,)
    xla = np.asarray(jnp.zeros(n_cells, jnp.float32).at[
        jnp.asarray(idx)].add(jnp.asarray(values)))
    lane_order = _loop(idx, values, n_cells, range(len(idx)))
    got = sums.numpy()
    assert got.view(np.uint32).tolist() == xla.view(np.uint32).tolist()
    assert got.view(np.uint32).tolist() == lane_order.view(
        np.uint32).tolist()
    assert np.array_equal(counts.numpy(),
                          np.bincount(idx, minlength=n_cells).astype(
                              np.float32))


@pytest.mark.parametrize("case", CASES)
def test_the_order_shows_in_the_bits(case):
    """Reversed order changes some cell's bits wherever a cell takes three
    or more addends; one lane has no order."""
    idx, values, n_cells = _inputs(case)
    fwd = _loop(idx, values, n_cells, range(len(idx)))
    rev = _loop(idx, values, n_cells, range(len(idx) - 1, -1, -1))
    differ = int((fwd.view(np.uint32) != rev.view(np.uint32)).sum())
    if case == "one lane":
        assert differ == 0
    else:
        assert np.bincount(idx).max() >= 3 and differ > 0
        assert np.allclose(fwd, rev, rtol=1e-4, atol=1e-3)


def test_plain_version_returns_on_the_inputs_device_and_checks_them():
    idx = torch.tensor([2, 0, 2], dtype=torch.int64)
    v = torch.tensor([1.0, 2.0, 3.0])
    sums, counts = sc.scatter_add_plain(idx, v, 4)
    assert sums.tolist() == [2.0, 0.0, 4.0, 0.0]
    assert counts.tolist() == [1.0, 0.0, 2.0, 0.0]
    assert sums.device.type == "cpu"
    assert sums.data_ptr() + 4 * 4 == counts.data_ptr()   # one [2, n]
    with pytest.raises(ValueError, match="int64 idx and float32 values"):
        sc.scatter_add(idx.int(), v, 4)
    with pytest.raises(ValueError, match=r"idx \[B\] and values \[B\]"):
        sc.scatter_add(idx, v[:2], 4)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sc._launch(idx, v, 4)
