"""The CUDA kernels K1 and K2 against their plain PyTorch versions on the
card, bit for bit.  Skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import step_kernel as sk

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
    """K1 and K2 equal the plain versions for two block sizes, and a run
    resumed through step_offset equals one run."""
    cfg = EnvConfig(width=board[0], height=board[1], slip_prob=0.2)
    B, T = 2048, 64
    pf, ps, pj = sk.fused_journal_rollout_plain(cfg, 4, B, T, cuda)
    for threads in (128, 256):
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
                                "fused_journal_rollout": 0}
