"""Batched zero-sum matrix-game solver (CUDA kernel R1 and its plain
version) and the alternating game's greedy policy.

The port of ``solve_matrix_games`` and ``altq_greedy_policy`` from
gym_soccer_tpu/agents/learners.py.  The JAX package's generic learners
(IQL, minimax-Q and alternating Q over the batched engine) are not ported
yet; the fused trainers in ops/learner_kernel.py and the evaluation tools
use this solver.  ``solve_matrix_games`` runs its plain version
(``solve_matrix_games_plain``) on a CPU tensor and launches R1
(``ops/csrc/rmplus_kernel.cu``) on a CUDA tensor; there is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

N_ACTIONS = 5

# Launches of the CUDA kernel R1 in this process, counted by the wrapper
# where it launches and nowhere else.
launch_counts = {"solve_matrix_games": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _fma_dot(P64, Z64):
    """sum_j P[..., i, j] * Z[..., j] as a chain of float32 fused
    multiply-adds in j order, starting from 0: how XLA on the CPU lowers
    the JAX package's small einsum contractions.  ``P64``/``Z64`` hold
    float32 values in float64, where each product is exact; the sum with
    the float32 accumulator is rounded once more to float32 (it differs
    from a true FMA only when the float64 sum is inexact and lands on a
    float32 rounding midpoint)."""
    prod = P64 * Z64.unsqueeze(-2)
    acc = prod[..., 0].float()
    for j in range(1, prod.shape[-1]):
        acc = (prod[..., j] + acc.double()).float()
    return acc


def _seq_sum(a):
    """Sum over the last axis in index order (XLA's CPU reduction order)."""
    s = a[..., 0]
    for j in range(1, a.shape[-1]):
        s = s + a[..., j]
    return s


def solve_matrix_games(M: torch.Tensor, iters: int = 100):
    """Approximately solve max_x min_y x^T M y for a batch of float32
    zero-sum 5x5 games M [..., 5, 5] by Regret Matching+ self-play with
    linear averaging, ``iters`` iterations; returns (value, x, y) as
    ``solve_matrix_games_plain`` does, bit for bit.

    On a CPU tensor this runs ``solve_matrix_games_plain``; on a CUDA
    tensor it launches kernel R1 (one thread a game, every iteration in
    the kernel), which takes float32 games of 5 actions only and raises
    ValueError for any other.  On the card the three outputs are views of
    one allocation."""
    if M.device.type == "cpu":
        return solve_matrix_games_plain(M, iters)
    return _launch_rmplus(M, iters)


def _launch_rmplus(M: torch.Tensor, iters: int):
    dev = M.device
    if dev.type != "cuda":
        raise ValueError(f"solve_matrix_games: no kernel for device {dev}")
    if M.dtype != torch.float32 or M.dim() < 2 or \
            tuple(M.shape[-2:]) != (N_ACTIONS, N_ACTIONS):
        raise ValueError("solve_matrix_games: the kernel takes float32 "
                         f"[..., {N_ACTIONS}, {N_ACTIONS}] games; got "
                         f"{M.dtype} {tuple(M.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    games = M.contiguous()
    batch = tuple(M.shape[:-2])
    G = games.numel() // (N_ACTIONS * N_ACTIONS)
    out = torch.empty((2 * N_ACTIONS + 1) * G, dtype=torch.float32,
                      device=dev)
    if G:
        lib = _library()
        rc = lib.gst_rmplus_solve(
            dev.index, games.data_ptr(), G, iters, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
        if rc:
            raise RuntimeError("solve_matrix_games: kernel launch failed: "
                               f"{lib.gst_error_string(rc).decode()} ({rc})")
        launch_counts["solve_matrix_games"] += 1
    x = out[G:(N_ACTIONS + 1) * G].view(*batch, N_ACTIONS)
    y = out[(N_ACTIONS + 1) * G:].view(*batch, N_ACTIONS)
    return out[:G].view(batch), x, y


@functools.lru_cache(maxsize=None)
def _library():
    """The built R1 library with its C signatures declared."""
    from ..ops import _build
    return declare(_build.load("rmplus_kernel"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``ops/csrc/rmplus_kernel.cu``."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # device, games, n_games, iters, out, stream
    lib.gst_rmplus_solve.argtypes = [i32, vp, i32, i32, vp, vp]
    lib.gst_rmplus_solve.restype = i32
    lib.gst_rmplus_block.argtypes = []
    lib.gst_rmplus_block.restype = i32
    lib.gst_error_string.argtypes = [i32]
    lib.gst_error_string.restype = ctypes.c_char_p
    return lib


def solve_matrix_games_plain(M: torch.Tensor, iters: int = 100):
    """Plain PyTorch version of ``solve_matrix_games``, on any device.

    Approximately solve max_x min_y x^T M y for a batch of float32
    zero-sum games M [..., nA, nA] by Regret Matching+ self-play with
    linear averaging, ``iters`` iterations.

    Returns (value, x, y): the game values [...] and the averaged mixed
    strategies of the row maximizer and the column minimizer [..., nA].

    RM+ amplifies rounding differences (one ulp grows to ~1e-3 in the
    strategies over a hundred iterations), so the arithmetic follows the
    JAX package's on the CPU operation for operation: contractions are
    FMA chains (``_fma_dot``), sums run in index order.  The row and
    column players are stacked on a leading axis of size 2, so that each
    iteration is one set of tensor operations for both (the loop is
    launch-bound on a GPU); every element sees the same arithmetic as in
    the unstacked form, since -(a - b) == b - a exactly.
    """
    nA = M.shape[-1]
    # P[0] = M (row payoffs M @ y), P[1] = M^T (column payoffs x @ M)
    P64 = torch.stack([M, M.transpose(-1, -2)]).double()
    uniform = torch.full((2,) + M.shape[:-1], 1.0 / nA, dtype=M.dtype,
                         device=M.device)
    sign = torch.tensor([1.0, -1.0], dtype=M.dtype, device=M.device).reshape(
        (2,) + (1,) * (M.dim() - 1))
    R = torch.zeros_like(uniform)   # cumulative regrets (rx, ry)
    S = torch.zeros_like(uniform)   # weighted strategy sums (sx, sy)

    for t in range(iters):
        s = _seq_sum(R).unsqueeze(-1)
        X = torch.where(s > 0, R / s.clamp_min(1e-30), uniform)   # (x, y)
        pay = _fma_dot(P64, X.flip(0).double())       # (M @ y, x @ M)
        vx = _seq_sum(X[0] * pay[0]).unsqueeze(-1)    # x . (M @ y)
        # RM+: rx += my - vx, ry += vx - xm, truncated at zero
        R = (R + (pay - vx) * sign).clamp_min(0.0)
        # linear averaging, S += (t + 1) * X as an FMA
        S = (X.double() * float(t + 1) + S.double()).float()
    X = S / _seq_sum(S).unsqueeze(-1)
    x, y = X[0], X[1]
    xm = _fma_dot(P64[1], x.double())
    value = _seq_sum(xm * y)
    return value, x, y


def altq_greedy_policy(cfg, q) -> torch.Tensor:
    """The mover's greedy policy per dense state of the alternating game:
    argmax at A-to-move states, argmin at B-to-move states (``q`` [nS, 5]
    is A-perspective), the lowest index on a tie; int32 [nS] on ``q``'s
    device."""
    from ..envs.soccer_alternating_env import build_alt_tables
    q = torch.as_tensor(q)
    turn = torch.as_tensor(build_alt_tables(cfg).turn, device=q.device)
    return torch.where(turn == 0, q.argmax(-1), q.argmin(-1)).to(torch.int32)
