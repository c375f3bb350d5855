"""Kernel A1's contract on the CPU (ops/scatter_kernel.py): the plain
version of ``scatter_add`` (``index_add_`` on the CPU) adds each cell's
values in lane order from 0, as XLA's scatter-add on the CPU does
(``jnp.zeros(n).at[idx].add(v)``, the JAX package's HBM-table learners'
update), bit for bit; a sum in reversed order differs on the same
inputs, so the comparison sees the order; the counts are exact.  The
inputs are chip_smoke.py phase 50's (every lane on one cell, 8192 lanes
over the 5x4 minimax table, 8192 over 3 cells, the port's minimax
learner's own cells and TDs at its steps 1 and 64) and the checked ones
(a cell on both sides of every tile's edge with a run longer than a tile,
one lane).  A numpy mirror of the kernel (csrc/scatter_kernel.cu: a
range of cells a block, its lanes ordered by cell tile by tile with one
stable counting-sort pass, ranks among a 32's peers of one cell and a
scan of the warps' counts in (cell, warp) order; each cell's run added
by its thread in lane order)
equals the plain version bit for bit on all of them, in small blocks and
many tiles and over out-of-range cells too; the launch's shape is pinned
to the .cu's constants.  The kernel itself
runs on the card only (tests/test_torch_cuda.py, chip_smoke.py phase
50)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gym_soccer_tpu_torch.ops import _build
from gym_soccer_tpu_torch.ops import scatter_kernel as sc
from gym_soccer_tpu_torch.ops import scatter_variants as sv

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CASES = [*chip_smoke.SCATTER_CASES, *chip_smoke.SCATTER_CHECKED]
# The learner's step-1 TDs are rewards, -1, 0 or 1: their sums are exact
# in any order, so only the other cases can show the order.
ORDERED = [c for c in CASES if c != "learner step 1"]


def _inputs(case):
    return chip_smoke.scatter_inputs(np, case)


def _loop(idx, values, n_cells, order):
    """float32 sums of ``values`` at ``idx``, one lane at a time in
    ``order``, from 0; cells outside [0, n_cells) dropped."""
    out = np.zeros(n_cells, np.float32)
    for i in order:
        if 0 <= idx[i] < n_cells:
            out[idx[i]] = np.float32(out[idx[i]] + values[i])
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32).tolist()


# Kept lanes times cells below which a tile is listed in lane order and
# each thread picks its cell's items, not ordered by cell
# (csrc/scatter_kernel.cu kFewLanes).
FEW_LANES = 1 << int(re.search(
    r"constexpr uint64_t kFewLanes = uint64_t\(1\) << (\d+);",
    (_build.CSRC / "scatter_kernel.cu").read_text()).group(1))


def _mirror(idx, values, n_cells):
    """(sums, counts) as csrc/scatter_kernel.cu computes them, step by
    step: block b keeps, tile by tile, the lanes whose cell is in its
    range [b * cells, (b + 1) * cells).  A tile with few kept lanes
    (fewer than FEW_LANES / cells, and half a tile at most) is listed in
    lane order and each cell's thread picks its items; else the block
    orders them by cell: round q of
    32 lanes (warp q // 8's round q % 8) ranks each kept lane among its
    peers of the same cell, the warps' counts are scanned in (cell, warp)
    order, and each kept lane goes to its cell's first place for its warp
    plus the same cell's lanes in the warp's earlier rounds plus its rank.
    Each cell's run must hold only that cell's lanes, in lane order; its
    thread adds the run in order (-0.0 past its last, which leaves the sum
    as it is: test_minus_zero_...), from the sum the earlier tiles left,
    and every cell of the range is written at the end."""
    shape = sc.launch_shape(len(idx), n_cells)
    per, tile = shape["cells"], shape["tile"]
    warps = shape["threads"] // 32
    rounds = warps * sc.ITEMS
    sums = np.full(n_cells, np.nan, np.float32)
    counts = np.full(n_cells, np.nan, np.float32)
    lanes32 = np.arange(32)
    below = lanes32[None, :] < lanes32[:, None]   # [lane, other lane]
    warp_of = np.arange(rounds) // sc.ITEMS
    for b in range(shape["blocks"]):
        lo, hi = b * per, min((b + 1) * per, n_cells)
        acc = np.zeros(per, np.float32)
        cnt = np.zeros(per, np.int64)
        for base in range(0, len(idx), tile):
            at = base + np.arange(rounds)[:, None] * 32 + lanes32[None, :]
            c = np.where(at < len(idx), idx[np.minimum(at, len(idx) - 1)],
                         -1)
            keep = (c >= lo) & (c < hi)
            if not keep.any():
                continue
            K = int(keep.sum())
            if K * per < FEW_LANES and 2 * K <= tile:   # listed, picked
                listed = at[keep]                        # lane order
                assert (np.diff(listed) > 0).all()
                for lane in listed:
                    j = idx[lane] - lo
                    acc[j] = np.float32(acc[j] + values[lane])
                    cnt[j] += 1
                continue
            cell = np.where(keep, c - lo, per)
            same = keep[:, :, None] & (cell[:, :, None] == cell[:, None, :])
            rank = (same & below[None]).sum(2)
            qq, ll = np.nonzero(keep)
            per_round = np.zeros((rounds, per), np.int64)
            np.add.at(per_round, (qq, cell[qq, ll]), 1)
            table = np.zeros((per, warps), np.int64)         # (cell, warp)
            np.add.at(table.T, warp_of, per_round)
            flat = table.reshape(-1)
            first = (np.cumsum(flat) - flat).reshape(per, warps)
            earlier = np.zeros_like(per_round)   # same warp, earlier rounds
            for q in range(1, rounds):
                if warp_of[q] == warp_of[q - 1]:
                    earlier[q] = earlier[q - 1] + per_round[q - 1]
            k = cell[qq, ll]
            dest = first[k, warp_of[qq]] + earlier[qq, k] + rank[qq, ll]
            assert sorted(dest.tolist()) == list(range(len(dest)))
            lane_of = np.empty(len(dest), np.int64)
            lane_of[dest] = at[qq, ll]
            run_cell = np.empty(len(dest), np.int64)
            run_cell[dest] = k
            starts = list(first[:, 0]) + [len(dest)]
            for j in range(per):   # each run: its cell's lanes, lane order
                run = slice(starts[j], starts[j + 1])
                assert (run_cell[run] == j).all()
                assert (np.diff(lane_of[run]) > 0).all()
                for lane in lane_of[run]:
                    acc[j] = np.float32(acc[j] + values[lane])
                cnt[j] += len(lane_of[run])
        sums[lo:hi] = acc[:hi - lo]
        counts[lo:hi] = cnt[:hi - lo].astype(np.float32)
    return sums, counts


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
    assert _bits(got) == _bits(xla) == _bits(lane_order)
    assert np.array_equal(counts.numpy(),
                          np.bincount(idx, minlength=n_cells).astype(
                              np.float32))


@pytest.mark.parametrize("case", ORDERED)
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


def test_minus_zero_leaves_every_sum_as_it_is():
    """x + (-0.0) is x, bit for bit, in float32 round-to-nearest, for
    every x the kernel's sums can hold (normal, subnormal, +0.0, the
    largest, infinities; NaN aside): the kernel adds -0.0 for an item of another
    cell and past a run's last value."""
    rng = np.random.default_rng(3)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 100000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 0x7f7fffff, 0x7f800000, 0xff800000, 0x80000001,
                  0x00800000], np.uint32)])
    x = bits.view(np.float32)
    x = x[~np.isnan(x)]
    got = (x + np.float32(-0.0)).astype(np.float32)
    assert got.view(np.uint32).tolist() == x.view(np.uint32).tolist()
    assert np.float32(np.float32(0.0) + np.float32(-0.0)).tobytes() == \
        np.float32(0.0).tobytes()


@pytest.mark.parametrize("case", CASES)
def test_kernel_mirror_equals_plain_version(case):
    """The mirror of A1's block gives the plain version's sums and counts
    bit for bit (the tiles' runs continued across tiles on the 65536-lane
    cases)."""
    idx, values, n_cells = _inputs(case)
    want = sc.scatter_add_plain(torch.from_numpy(idx),
                                torch.from_numpy(values), n_cells)
    got = _mirror(idx, values, n_cells)
    assert _bits(got[0]) == _bits(want[0].numpy())
    assert _bits(got[1]) == _bits(want[1].numpy())


@pytest.mark.parametrize("lanes,n_cells", [(300, 19025), (257, 255),
                                           (1000, 33), (2, 292625),
                                           (700, 1), (9000, 40000)])
def test_kernel_mirror_small_blocks_and_dropped_cells(lanes, n_cells):
    """Blocks of a few warps, one range or 286 of 1024 cells (11x7's
    292,625), a last range cut short, two tiles; cells outside [0, n)
    dropped as a lane-order loop drops them, every cell written."""
    rng = np.random.default_rng(lanes + n_cells)
    idx = rng.integers(-3, n_cells + 3, lanes).astype(np.int64)
    idx[: lanes // 3] = n_cells // 2
    values = (10.0 ** rng.uniform(-6, 2, lanes) * rng.choice(
        (-1.0, 1.0), lanes)).astype(np.float32)
    sums, counts = _mirror(idx, values, n_cells)
    keep = (idx >= 0) & (idx < n_cells)
    assert _bits(sums) == _bits(_loop(idx, values, n_cells,
                                      range(lanes)))
    assert np.array_equal(counts, np.bincount(
        idx[keep], minlength=n_cells).astype(np.float32))


def test_kernel_mirror_in_many_small_tiles(monkeypatch):
    """With blocks of at most one warp (tiles of 256 lanes, ranges of 32
    cells), the first 4096 lanes of the tiling case take 16 tiles in each
    of 595 blocks and give the lane-order loop's bits: every cell's sum
    goes on from one tile to the next."""
    idx, values, n_cells = _inputs("tiles")
    idx, values = idx[:4096], values[:4096]
    monkeypatch.setattr(sc, "MAX_WARPS", 1)
    assert sc.launch_shape(4096, n_cells) == {
        "threads": 32, "tile": 256, "smem": 4 * (256 + 32 * 2 + 33 + 33),
        "blocks": 595, "cells": 32, "cell_bits": 5}
    sums, counts = _mirror(idx, values, n_cells)
    assert _bits(sums) == _bits(_loop(idx, values, n_cells, range(4096)))
    assert np.array_equal(counts, np.bincount(
        idx, minlength=n_cells).astype(np.float32))


def test_launch_shape_is_the_kernels():
    """launch_shape's constants are the .cu's; at the learners' 8192 lanes
    over the 5x4 tables' 19025 cells 119 blocks of 1024 threads, 160 cells
    a block (8 bits of index), one tile of 8192 lanes in 54,664 B of
    shared memory (past 8192 lanes, in tiles); 286 blocks of 1024 cells
    over 11x7's 292,625, within a block's shared memory; one block of 32
    cells over 3; small batches take blocks of the power of two of warps
    their cells need."""
    src = (_build.CSRC / "scatter_kernel.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             src).group(1).split("*")[-1].strip())

    assert const("kItems") == sc.ITEMS
    assert const("kMaxWarps") == sc.MAX_WARPS
    assert const("kBlocks") == sc.BLOCKS
    assert const("kCellBits") == (32 * sc.MAX_WARPS - 1).bit_length()
    assert sc.launch_shape(8192, 19025) == {
        "threads": 1024, "tile": 8192,
        "smem": 4 * (8192 + 160 * 33 + 33 + 161), "blocks": 119,
        "cells": 160, "cell_bits": 8}
    assert sc.launch_shape(8192, 19025)["smem"] == 54664
    assert sc.launch_shape(65536, 19025) == sc.launch_shape(8192, 19025)
    big = sc.launch_shape(8192, 292625)
    assert (big["blocks"], big["cells"], big["cell_bits"]) == (286, 1024, 10)
    assert big["smem"] <= 232448
    assert sc.launch_shape(8192, 3)["blocks"] == 1
    assert sc.launch_shape(8192, 3)["cell_bits"] == 5
    assert sc.launch_shape(2, 19025) == {
        "threads": 256, "tile": 2048,
        "smem": 4 * (2048 + 160 * 9 + 33 + 161), "blocks": 119,
        "cells": 160, "cell_bits": 8}
    assert sc.launch_shape(2, 3)["threads"] == 32


def test_learner_cases_are_the_entry_points_recipe():
    """The learner's cases are minimax_train's own scatter-add inputs at
    steps 1 and 64 of the entry point's recipe: 19025 cells, 8192 lanes
    in range; step 1 hits 2223 cells, 1959 of them twice or more, its
    longest run 14 lanes (the rewards as TDs); step 64 hits 6059, its
    longest run 11."""
    stats = {}
    for case in sv.LEARNER_STEPS:
        idx, values, n = _inputs(case)
        assert idx.shape == values.shape == (8192,) and n == 19025
        assert 0 <= idx.min() and idx.max() < n
        bc = np.bincount(idx, minlength=n)
        stats[case] = (int((bc > 0).sum()), int((bc >= 2).sum()),
                       int(bc.max()))
    assert stats == {"learner step 1": (2223, 1959, 14),
                     "learner step 64": (6059, 1473, 11)}
    step1 = _inputs("learner step 1")[1]
    assert set(np.unique(step1).tolist()) == {-1.0, 0.0, 1.0}


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


@pytest.mark.parametrize("name", sorted(sv.VARIANTS))
def test_scatter_variants_patch_the_committed_kernel(name):
    """Each timed variant of A1 (ops/scatter_variants.py) applies its
    patches to its source, each text found once; the previous
    design builds csrc/scatter_walk_kernel.cu as it is, with its third
    row of first lanes, and the sort design csrc/scatter_sort_kernel.cu,
    both after a zero fill."""
    source, patches = sv.VARIANTS[name]
    src = (_build.CSRC / source).read_text()
    got = sv.variant_source(name, src)
    assert (got == src) == (not patches)
    for _, new in patches:
        assert new in got
    assert sv.VARIANTS["kernel"] == ("scatter_kernel.cu", [])
    walk = (_build.CSRC / sv.WALK_SOURCE).read_text()
    assert "walk_kernel" in walk and "count_kernel" in walk
    assert "sort_add_kernel" in (_build.CSRC / sv.SORT_SOURCE).read_text()
    assert sv.OUTPUT == {"scatter_kernel.cu": (2, False),
                         "scatter_walk_kernel.cu": (3, True),
                         "scatter_sort_kernel.cu": (2, True)}
    with pytest.raises(ValueError, match="matches 0 times"):
        sv.variant_source("264 blocks aimed at", "no kernel here")
