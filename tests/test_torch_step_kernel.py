"""The port's fused rollouts (gym_soccer_tpu_torch.ops.step_kernel) on the
CPU, where the wrappers run their plain PyTorch versions, against the JAX
package: ``xla_journal_twin`` (final fields and journal, word for word)
and ``pallas_rollout``/``pallas_journal_rollout`` in interpret mode
(stats).  Tolerance: exact equality throughout, since every operation is
integer.  The CUDA kernels are held against these plain versions on the
card by chip_smoke.py and tests/test_torch_cuda.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.ops import step_kernel as jsk
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import step_kernel as sk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B = 1024
BOARDS = [(5, 4), (11, 7)]


def _cfgs(board, q=0.2):
    w, h = board
    return JaxConfig(width=w, height=h, slip_prob=q), \
        EnvConfig(width=w, height=h, slip_prob=q)


def _ints(stats):
    return [int(x) for x in stats]


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("board", BOARDS)
def test_plain_rollouts_equal_xla_twin(board):
    jcfg, cfg = _cfgs(board)
    T = 96
    jfields, jjournal = jsk.xla_journal_twin(jcfg, 5, B, T)
    fields, stats, journal = sk.fused_journal_rollout(cfg, 5, B, T, "cpu")
    assert journal.dtype == torch.int32 and tuple(journal.shape) == (T, B)
    assert np.array_equal(interop.journal_to_tiles(journal),
                          np.asarray(jjournal))
    _assert_planes_equal(fields, jfields)
    kfields, kstats = sk.fused_rollout(cfg, 5, B, T, "cpu")
    _assert_planes_equal(kfields, jfields)
    assert _ints(kstats) == _ints(stats)
    assert all(s.dtype == torch.int64 for s in kstats)


@pytest.mark.parametrize("board", BOARDS)
def test_stats_equal_pallas_interpret(board):
    jcfg, cfg = _cfgs(board)
    jfields, jstats = jsk.pallas_rollout(jcfg, jnp.int32(7), B, 32,
                                         interpret=True)
    fields, stats = sk.fused_rollout(cfg, 7, B, 32, "cpu")
    assert _ints(stats) == _ints(jstats)
    _assert_planes_equal(fields, jfields)


def test_journal_stats_equal_pallas_journal_interpret():
    jcfg, cfg = _cfgs((5, 4))
    _, jstats, jjournal = jsk.pallas_journal_rollout(jcfg, jnp.int32(3), B, 32,
                                                     interpret=True)
    _, stats, journal = sk.fused_journal_rollout(cfg, 3, B, 32, "cpu")
    assert _ints(stats) == _ints(jstats)
    assert np.array_equal(interop.journal_to_tiles(journal),
                          np.asarray(jjournal))


@pytest.mark.parametrize("board", BOARDS)
def test_step_offset_resume_equals_one_call(board):
    """Two calls chained through init_fields/step_offset equal one long
    call, and equal the JAX twin resumed from the same carried planes."""
    jcfg, cfg = _cfgs(board)
    f1, s1, j1 = sk.fused_journal_rollout(cfg, 9, B, 56, "cpu")
    fa, sa, ja = sk.fused_journal_rollout(cfg, 9, B, 24, "cpu")
    fb, sb, jb = sk.fused_journal_rollout(cfg, 9, B, 32, "cpu",
                                          init_fields=fa, step_offset=24)
    for a, b in zip(f1, fb):
        assert torch.equal(a, b)
    assert torch.equal(j1, torch.cat([ja, jb]))
    assert _ints(s1) == [x + y for x, y in zip(_ints(sa), _ints(sb))]
    kf, ks = sk.fused_rollout(cfg, 9, B, 32, "cpu", init_fields=fa,
                              step_offset=24)
    assert all(torch.equal(a, b) for a, b in zip(kf, fb))
    assert _ints(ks) == _ints(sb)
    # the JAX twin, resumed from the port's planes
    tfields, tjournal = jsk.xla_journal_twin(
        jcfg, 9, B, 32,
        init_fields=[jnp.asarray(p) for p in interop.planes_to_tiles(fa)],
        step_offset=24)
    assert np.array_equal(interop.journal_to_tiles(jb), np.asarray(tjournal))
    _assert_planes_equal(fb, tfields)
    # and the port, resumed from the JAX twin's planes
    jfa, _ = jsk.xla_journal_twin(jcfg, 9, B, 24)
    kf, _ = sk.fused_rollout(cfg, 9, B, 32, "cpu", step_offset=24,
                             init_fields=interop.planes_from_tiles(jfa, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(kf, fb))


@pytest.mark.parametrize("board", BOARDS)
def test_unpack_journal_equals_jax(board):
    jcfg, cfg = _cfgs(board)
    _, jjournal = jsk.xla_journal_twin(jcfg, 2, B, 48)
    want = jsk.unpack_journal(jcfg, jjournal)
    got = sk.unpack_journal(cfg, interop.journal_from_tiles(jjournal, "cpu"))
    assert set(got) == set(want)
    for k, v in want.items():
        g, v = got[k].numpy(), np.asarray(v).reshape(48, B)
        assert g.dtype == v.dtype, k
        assert np.array_equal(g, v), k


def test_counter_prng_equals_jax():
    """murmur3 words in int64 arithmetic equal the JAX package's uint32
    ones, across the whole uint32 range (products pass 2**63 there)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        [0, 1, 2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    got = sk._fmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32),
                          np.asarray(jsk._fmix32(jnp.asarray(x))))
    lane = torch.as_tensor(x.astype(np.int64))
    for seed, step, w in ((0, 0, 0), (7, 123456, 2), (2**31 - 1, 2**31 - 1, 1)):
        want = jsk._random_word(jnp.uint32(seed), jnp.int32(step), w,
                                jnp.asarray(x))
        got = sk._random_word(seed, step, w, lane).numpy().astype(np.uint32)
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("board", BOARDS)
def test_isd_spread_fields_equal_jax(board):
    jcfg, cfg = _cfgs(board)
    want = jsk.isd_spread_fields(jcfg, B, (B // 128, 128))
    got = sk.isd_spread_fields(cfg, B, "cpu")
    _assert_planes_equal(got, want)


def test_wrappers_check_their_arguments():
    _, cfg = _cfgs((5, 4))
    with pytest.raises(ValueError, match="multiple of 1024"):
        sk.fused_rollout(cfg, 0, 1000, 4, "cpu")
    bad = [torch.zeros(B, dtype=torch.int64)] * 6
    with pytest.raises(ValueError, match="int32"):
        sk.fused_rollout(cfg, 0, B, 4, "cpu", init_fields=bad)
    with pytest.raises(ValueError, match="6 tensors"):
        sk.fused_rollout(cfg, 0, B, 4, "cpu", init_fields=bad[:5])
    with pytest.raises(ValueError, match="16 bits"):
        sk.fused_journal_rollout(EnvConfig(width=20, height=10), 0, B, 4,
                                 "cpu")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        sk.fused_rollout(cfg, 0, B, 4, "cpu", step_offset=2**31 - 2)


def test_no_kernel_for_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device reaches
    neither the plain version nor a kernel."""
    _, cfg = _cfgs((5, 4))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sk.fused_rollout(cfg, 0, B, 4, "meta")


def test_wrappers_check_lanes_per_block():
    """``threads`` is K1/K2's lanes per block: a multiple of 32 in [32,
    512] whose shared memory fits, checked before any launch on every
    device; 5x4's step table leaves room for 192 lanes, not 224, and 11x7,
    walked by arithmetic, takes 512."""
    _, cfg = _cfgs((5, 4))
    _, big = _cfgs((11, 7))
    for bad in (0, 48, 544, 1024):
        for fn in (sk.fused_rollout, sk.fused_journal_rollout):
            with pytest.raises(ValueError, match="multiple of 32"):
                fn(cfg, 0, B, 4, "cpu", threads=bad)
    with pytest.raises(ValueError, match="shared memory"):
        sk.fused_rollout(cfg, 0, B, 4, "cpu", threads=224)
    want = sk.fused_rollout(cfg, 0, B, 4, "cpu")
    for lanes in (32, 96, 192):
        got = sk.fused_rollout(cfg, 0, B, 4, "cpu", threads=lanes)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    sk.fused_journal_rollout(big, 0, B, 4, "cpu", threads=512)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sk.fused_journal_rollout(cfg, 0, B, 4, "meta", threads=64)
