"""Tabular self-play learners on the batched engines, and the batched
zero-sum matrix-game solver (CUDA kernel R1 and its plain version).

The port of gym_soccer_tpu/agents/learners.py:

* ``solve_matrix_games`` runs its plain version
  (``solve_matrix_games_plain``) on a CPU tensor and launches R1
  (``ops/csrc/rmplus_kernel.cu``) on a CUDA tensor; there is no fallback
  from one to the other.  The fused trainers in ops/learner_kernel.py, the
  evaluation tools and minimax-Q's re-solve use it.
* Independent Q-learning (``iql_*``), minimax-Q (``minimax_*``, Littman
  1994) and turn-based Q-learning on the alternating game (``altq_*``),
  each over the single-geometry engine (core/batch) and the first two over
  the mixed-geometry engine (core/multigrid, ``multigrid_*``): tables in
  device memory, one act/step/update a call over the whole lockstep batch,
  the updates as count-normalized scatter-adds in lane order (kernel A1
  on the card, ``index_add_`` on the CPU: ops/scatter_kernel).  Their
  draws come from the engines' per-instance threefry streams (kernel T1
  on the card; each engine's step, its draws included, is one kernel:
  S1 on the single-geometry engine, S2 on the mixed-geometry one and S3
  on the alternating one).  Given the JAX package's state
  (interop.learner_state_from_numpy) they step the same observations and
  actions on the CPU with the same tables, but for the last bit where
  minimax-Q's schedules take a float32 power (XLA's ``pow`` and the
  host's ``powf`` round differently); the card's states equal the CPU's
  bit for bit, and each step's mean |TD| but for its reduction's last
  bits.
* ``altq_greedy_policy``: the alternating game's greedy policy.

``psum_axis`` takes a data-parallel ``Mesh`` (parallel/mesh) where the
JAX package takes a mesh axis name: each step's table sums and counts are
all-reduced over the ranks before the count-normalised divide, so every
rank applies the whole batch's update (``parallel.mesh.sharded_*_train_fn``
average the TD summary over the ranks, JAX's ``pmean``).  On the card an
NCCL mesh's collectives are captured in the ``*_train`` replays; a gloo
mesh's cannot be, and ``dispatch.run`` refuses it there (ValueError)
before a capture.  The
trainers keep the step count on the host beside
``state.step`` (read once a ``*_train`` call), so the schedules and
minimax-Q's re-solve cadence need no device read a step.

A step is tens to hundreds of small launches: on the card a minimax-Q
step on the single-geometry engine is some 60 device operations (S1, one
T1 draw, the observation, the action sampling, and the updates with A1's
zero fill and two launches; chip_smoke.py phases 46 and 51 count them),
and the mixed-geometry and alternating engines step in one launch each
(S2, S3; phase 51).  So a loop of single steps is bound by the host.
The ``*_train`` functions therefore run ``GROUP_STEPS`` steps (rounded up
to whole re-solve periods) a replay of one CUDA graph (ops/dispatch, as
the fused trainers' grouped modes do; on the CPU the same bodies one after
another).  Minimax-Q's steps before the first re-solve boundary and after
the last whole period run one at a time, and its per-step lr and eps come
from a table the host computes as a single step does.  The result equals
a loop of ``*_step`` calls bit for bit, on the CPU and on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import EnvConfig
from ..core import batch, multigrid, tables
from ..ops import (dispatch, engine_kernel, mixed_alt_kernel, scatter_kernel,
                   threefry_kernel)

N_ACTIONS = 5

# Launches of the CUDA kernel R1 in this process, counted by the wrapper
# where it launches and nowhere else.
launch_counts = {"solve_matrix_games": 0}

# Steps a CUDA-graph replay of the ``*_train`` functions, rounded up to a
# whole number of minimax-Q's re-solve periods.
GROUP_STEPS = 64


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
    tensor it launches kernel R1 (a group of ten lanes of one warp a game,
    one player's action a lane, every iteration in the kernel), which
    takes float32 games of 5 actions only and raises ValueError for any
    other.  On the card the three outputs are views of
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
    # shape: int32 [3]: lanes a game, games a warp, warps a block
    lib.gst_rmplus_shape.argtypes = [vp]
    lib.gst_rmplus_shape.restype = None
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


# ----------------------------------------------------------------------
# Engine adapters: the learner math is the same over the single-geometry
# batch engine (core/batch) and the mixed-geometry engine (core/multigrid
# and its per-variant dense codec); only obs/uniforms/step wiring differs.
# ----------------------------------------------------------------------

class _Engine(NamedTuple):
    observe: object    # env -> int32 [B] learner state index
    uniforms: object   # (env, count, salt) -> [B, count] uniforms
    step: object       # (env, aa, ab) -> (env2, reward_a, done, trunc,
    #                                      final_obs)  [final_obs pre-reset]
    nS: int


def _batch_engine(cfg: EnvConfig) -> _Engine:
    def estep(env, aa, ab):
        env2, out = batch.step(cfg, env, aa, ab)
        return env2, out.reward_a, out.done, out.truncated, out.final_obs

    return _Engine(
        observe=lambda env: batch.observe(cfg, env),
        uniforms=lambda env, count, salt: batch.per_env_uniforms(
            env, count, salt=salt),
        step=estep,
        nS=tables.build_statespace(cfg).nS)


def _multigrid_engine(codec: multigrid.MultiGridCodec) -> _Engine:
    """Mixed-geometry engine: learner tables are concatenated over variants
    (index = codec.offsets[vid] + per-variant dense obs)."""
    def estep(env, aa, ab):
        env2, (r, goal, trunc), (_, final_obs) = multigrid.step_obs(
            codec, env, aa, ab)
        return env2, r, goal, trunc, final_obs

    return _Engine(
        observe=lambda env: multigrid.global_obs(codec, env),
        uniforms=lambda env, count, salt: multigrid.uniforms(
            env, count, salt=salt),
        step=estep,
        nS=codec.nS_total)


def _psum(mesh, *sums):
    """The tensors ``sums`` (float32, one shape) summed over the ranks of
    ``mesh`` (no collective where it is None), as one all-reduce."""
    if mesh is None:
        return sums
    return mesh.all_reduce_(torch.stack(sums)).unbind()


def _f32(x) -> float:
    """``x`` rounded to float32: a JAX weak-typed Python scalar meeting a
    float32 array is rounded this way before the operation."""
    return float(np.float32(x))


def _policy(frozen, device):
    return None if frozen is None else torch.as_tensor(
        np.asarray(frozen), device=device).to(torch.int64)


def _zero_step(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


# ----------------------------------------------------------------------
# Independent Q-learning
# ----------------------------------------------------------------------

class IQLState(NamedTuple):
    q_a: torch.Tensor      # [nS, 5] float32
    q_b: torch.Tensor      # [nS, 5] float32
    env: object            # batch.EnvState or multigrid.MultiGridState
    step: torch.Tensor     # int32 scalar


class IQLConfig(NamedTuple):
    lr: float = 0.1
    gamma: float = 0.99
    eps: float = 0.1


def _iql_state(nS: int, env) -> IQLState:
    dev = env.t.device
    zeros = lambda: torch.zeros((nS, N_ACTIONS), dtype=torch.float32,  # noqa
                                device=dev)
    return IQLState(q_a=zeros(), q_b=zeros(), env=env, step=_zero_step(dev))


def iql_init(cfg: EnvConfig, key, n_envs: int, device="cuda") -> IQLState:
    """Zero Q tables and ``batch.init(cfg, key, n_envs)`` on ``device``."""
    return _iql_state(tables.build_statespace(cfg).nS,
                      batch.init(cfg, key, n_envs, device))


def _eps_greedy(q_row: torch.Tensor, u_explore: torch.Tensor,
                u_action: torch.Tensor, eps: float) -> torch.Tensor:
    greedy = q_row.argmax(-1).to(torch.int32)   # the first index on a tie
    rand = (u_action * N_ACTIONS).to(torch.int32) % N_ACTIONS
    return torch.where(u_explore < _f32(eps), rand, greedy)


def _iql_step_engine(eng: _Engine, lcfg: IQLConfig, state: IQLState,
                     frozen_a=None, frozen_b=None, mesh=None):
    q_a, q_b = state.q_a, state.q_b
    obs = eng.observe(state.env).long()
    u = eng.uniforms(state.env, 4, 1).T
    aa = (frozen_a[obs] if frozen_a is not None
          else _eps_greedy(q_a[obs], u[0], u[1], lcfg.eps)).long()
    ab = (frozen_b[obs] if frozen_b is not None
          else _eps_greedy(q_b[obs], u[2], u[3], lcfg.eps)).long()

    env2, reward_a, done, truncated, final_obs = eng.step(state.env, aa, ab)
    cont = torch.where(done | truncated, 0.0, 1.0)
    fo = final_obs.long()
    gamma = _f32(lcfg.gamma)
    # TD targets; B sees the negated reward (zero-sum)
    tgt_a = reward_a + gamma * cont * q_a[fo].max(-1).values
    tgt_b = -reward_a + gamma * cont * q_b[fo].max(-1).values
    td_a = tgt_a - q_a[obs, aa]
    td_b = tgt_b - q_b[obs, ab]

    # Count-normalized scatter updates: the mean TD of the lanes that hit
    # a cell, at learning rate lr, the TDs summed in lane order as XLA's
    # CPU scatter sums them (A1 on the card); under a mesh the sums and
    # counts are all-reduced before the divide.
    n = q_a.numel()
    ia, ib = obs * N_ACTIONS + aa, obs * N_ACTIONS + ab
    lr = _f32(lcfg.lr)
    sum_a, cnt_a, sum_b, cnt_b = _psum(
        mesh, *scatter_kernel.scatter_add(ia, td_a, n),
        *scatter_kernel.scatter_add(ib, td_b, n))
    delta_a = (lr * sum_a / cnt_a.clamp_min(1.0)).view_as(q_a)
    delta_b = (lr * sum_b / cnt_b.clamp_min(1.0)).view_as(q_b)
    if frozen_a is not None:
        delta_a = torch.zeros_like(delta_a)
    if frozen_b is not None:
        delta_b = torch.zeros_like(delta_b)
    new = IQLState(q_a=q_a + delta_a, q_b=q_b + delta_b, env=env2,
                   step=state.step + 1)
    return new, (td_a.abs().mean() + td_b.abs().mean()) * 0.5


def iql_step(cfg: EnvConfig, lcfg: IQLConfig, state: IQLState,
             psum_axis=None, frozen_a=None, frozen_b=None):
    """One act/step/update for the whole batch.  Returns (state, mean
    |TD|, this rank's).  ``frozen_a``/``frozen_b``: an int policy [nS]
    fixing that player's actions (the reference's frozen-opponent mode,
    batched); the frozen side's table is left untouched.  ``psum_axis``: a
    ``parallel.mesh.Mesh`` over whose ranks the update's sums and counts
    are all-reduced, or None."""
    dev = state.q_a.device
    return _iql_step_engine(_batch_engine(cfg), lcfg, state,
                            _policy(frozen_a, dev), _policy(frozen_b, dev),
                            psum_axis)


def _tensors(tree) -> list:
    """The tensors of a NamedTuple tree (a learner state), depth first."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, tuple):
            out.extend(_tensors(x))
    return out


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in ``_tensors``' order."""
    it = iter(tensors)

    def go(t):
        return type(t)(*(next(it) if isinstance(x, torch.Tensor)
                         else go(x) if isinstance(x, tuple) else x
                         for x in t))
    return go(tree)


def _train(step, state, n_steps: int, period: int = 1, step0: int = 0,
           coeffs=None, mesh=None):
    """``n_steps`` of ``step(state, step_now, co) -> (state, td)``; returns
    (state, td per step).  ``step_now`` is the host's step count;  ``co``
    is None for a step run on its own (the step computes its own scalars
    from ``step_now``) and, in a group, the 0-d tensors of
    ``coeffs(step_now)`` read from a device table.  ``period``: the steps
    whose pattern repeats (minimax-Q's re-solve cadence); the whole periods
    run grouped, ``-(-GROUP_STEPS // period)`` periods a replay; ``mesh``,
    the data-parallel mesh the steps all-reduce over, goes to
    ``dispatch.run``, which refuses one its replays cannot capture."""
    tds, done = [], 0

    def single(state, n):
        nonlocal done
        for _ in range(n):
            state, td = step(state, step0 + done, None)
            tds.append(td.reshape(1))
            done += 1
        return state

    state = single(state, min(n_steps, -step0 % period))
    n_periods = (n_steps - done) // period
    if n_periods:
        state, td = _grouped(step, state, step0 + done, n_periods, period,
                             -(-GROUP_STEPS // period), coeffs, mesh)
        tds.append(td)
        done += n_periods * period
    state = single(state, n_steps - done)
    return state, (torch.cat(tds) if tds else torch.zeros(0))


def _grouped(step, state, first: int, n_periods: int, period: int, g: int,
             coeffs, mesh):
    """``n_periods`` x ``period`` steps from host step ``first`` (a multiple
    of ``period``) through ``dispatch.run``: the carry is a copy of the
    state's tensors, each body runs ``period`` steps and writes them back;
    S1's, S2's, S3's, T1's, A1's and R1's launch counts are kept as the
    fused trainers' are."""
    carry = [t.clone() for t in _tensors(state)]
    dev = carry[0].device
    tds = torch.zeros(n_periods * period, dtype=torch.float32, device=dev)
    k = torch.zeros(1, dtype=torch.int64, device=dev)
    table = None if coeffs is None else torch.tensor(np.array(
        [coeffs(first + i) for i in range(n_periods * period)],
        np.float32), device=dev)

    def body():
        cur = _rebuild(state, carry)
        for j in range(period):
            co = (None if table is None
                  else table.index_select(0, k)[0].unbind())
            cur, td = step(cur, first + j, co)
            tds.index_copy_(0, k, td.reshape(1))
            k.add_(1)
        for dst, src in zip(carry, _tensors(cur)):
            dst.copy_(src)

    dispatch.run(body, carry + [tds, k], n_periods, g,
                 counters=(engine_kernel.launch_counts,
                           mixed_alt_kernel.launch_counts,
                           threefry_kernel.launch_counts,
                           scatter_kernel.launch_counts, launch_counts),
                 mesh=mesh)
    return _rebuild(state, carry), tds


def iql_train(cfg: EnvConfig, lcfg: IQLConfig, state: IQLState,
              n_steps: int, psum_axis=None, frozen_a=None, frozen_b=None):
    """``n_steps`` of ``iql_step``.  Returns (state, mean |TD| per
    step)."""
    eng, dev = _batch_engine(cfg), state.q_a.device
    fa, fb = _policy(frozen_a, dev), _policy(frozen_b, dev)
    return _train(lambda s, i, co: _iql_step_engine(eng, lcfg, s, fa, fb,
                                                    psum_axis),
                  state, n_steps, mesh=psum_axis)


def multigrid_iql_init(cfgs, key, n_envs: int, device="cuda") -> IQLState:
    """IQL over a mixed-geometry batch: one Q-table pair concatenated over
    every variant's state space."""
    codec = multigrid.build_codec(tuple(cfgs))
    return _iql_state(codec.nS_total,
                      multigrid.init(tuple(cfgs), key, n_envs, device))


def multigrid_iql_train(cfgs, lcfg: IQLConfig, state: IQLState,
                        n_steps: int, psum_axis=None,
                        frozen_a=None, frozen_b=None):
    """IQL training over a mixed-geometry batch."""
    eng = _multigrid_engine(multigrid.build_codec(tuple(cfgs)))
    dev = state.q_a.device
    fa, fb = _policy(frozen_a, dev), _policy(frozen_b, dev)
    return _train(lambda s, i, co: _iql_step_engine(eng, lcfg, s, fa, fb,
                                                    psum_axis),
                  state, n_steps, mesh=psum_axis)


# ----------------------------------------------------------------------
# Minimax-Q (Littman 1994)
# ----------------------------------------------------------------------

class MinimaxQState(NamedTuple):
    q: torch.Tensor       # [nS, 5, 5] player-A payoff of joint actions
    v: torch.Tensor       # [nS] current game values
    pi_a: torch.Tensor    # [nS, 5] A's maximin mixed strategy
    pi_b: torch.Tensor    # [nS, 5] B's minimax mixed strategy
    env: object           # batch.EnvState or multigrid.MultiGridState
    step: torch.Tensor    # int32 scalar
    n: torch.Tensor       # [nS, 5, 5] lifetime visit counts


class MinimaxQConfig(NamedTuple):
    lr: float = 0.25
    gamma: float = 0.99
    eps: float = 0.3          # exploration mixed into the policies
    resolve_every: int = 32   # batched all-state game re-solve cadence
    solver_iters: int = 200
    lr_halflife: int = 0      # steps to halve lr (0 = constant)
    eps_halflife: int = 0
    # Per-cell Robbins-Monro schedule: lr_cell = lr * (1 + N(s,aa,ab) /
    # tau) ** -pow over lifetime visit counts N (0 disables).
    count_lr_tau: float = 0.0
    count_lr_pow: float = 0.85
    eps_min: float = 0.0      # exploration floor under eps_halflife


def _minimax_state(nS: int, env) -> MinimaxQState:
    dev = env.t.device
    f32 = dict(dtype=torch.float32, device=dev)
    uniform = torch.full((nS, N_ACTIONS), 1.0 / N_ACTIONS, **f32)
    return MinimaxQState(
        q=torch.zeros((nS, N_ACTIONS, N_ACTIONS), **f32),
        v=torch.zeros(nS, **f32), pi_a=uniform, pi_b=uniform.clone(),
        env=env, step=_zero_step(dev),
        n=torch.zeros((nS, N_ACTIONS, N_ACTIONS), **f32))


def minimax_init(cfg: EnvConfig, key, n_envs: int,
                 device="cuda") -> MinimaxQState:
    """Zero Q, V and counts, uniform policies and ``batch.init(cfg, key,
    n_envs)`` on ``device``."""
    return _minimax_state(tables.build_statespace(cfg).nS,
                          batch.init(cfg, key, n_envs, device))


def _sample_mixed(pi_rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Actions from per-env mixed strategies [B, nA] by first exceedance of
    ``u`` over their float32 cumulative sums."""
    cum = torch.cumsum(pi_rows, dim=-1)
    return (cum <= u[:, None]).sum(-1).clamp(max=N_ACTIONS - 1).to(
        torch.int32)


def _decay(halflife: int, fstep: np.float32) -> np.float32:
    """0.5 ** (step / halflife) in float32 (1 when halflife is 0)."""
    if halflife <= 0:
        return np.float32(1.0)
    return np.power(np.float32(0.5), fstep / np.float32(max(halflife, 1)))


def _minimax_coeffs(lcfg: MinimaxQConfig, step_now: int):
    """(lr, 1 - eps, eps / 5) of step ``step_now``, float32 as JAX's."""
    fstep = np.float32(step_now)
    eps = np.maximum(np.float32(lcfg.eps) * _decay(lcfg.eps_halflife, fstep),
                     np.float32(lcfg.eps_min))
    lr = np.float32(lcfg.lr) * _decay(lcfg.lr_halflife, fstep)
    return lr, np.float32(1.0) - eps, eps / np.float32(N_ACTIONS)


def _minimax_step_engine(eng: _Engine, lcfg: MinimaxQConfig,
                         state: MinimaxQState, step_now: int, co=None,
                         mesh=None):
    """One step; ``co``: (lr, keep, explore) as 0-d tensors, or None to
    take them from ``step_now`` as Python floats (the same float32
    values)."""
    obs = eng.observe(state.env).long()
    u = eng.uniforms(state.env, 2, 1).T
    lr, keep, explore = co if co is not None else (
        float(x) for x in _minimax_coeffs(lcfg, step_now))
    aa = _sample_mixed(state.pi_a[obs] * keep + explore, u[0]).long()
    ab = _sample_mixed(state.pi_b[obs] * keep + explore, u[1]).long()

    env2, reward_a, done, truncated, final_obs = eng.step(state.env, aa, ab)
    cont = torch.where(done | truncated, 0.0, 1.0)
    tgt = reward_a + _f32(lcfg.gamma) * cont * state.v[final_obs.long()]
    td = tgt - state.q[obs, aa, ab]

    # Count-normalized update (see iql_step): mean TD per visited cell.
    cells = (obs * N_ACTIONS + aa) * N_ACTIONS + ab
    shape = state.q.shape
    sum_td, cnt = (x.view(shape) for x in _psum(
        mesh, *scatter_kernel.scatter_add(cells, td, state.q.numel())))
    n = state.n + cnt
    if lcfg.count_lr_tau > 0:
        lr = lr * (1.0 + n / _f32(lcfg.count_lr_tau)) ** _f32(
            -lcfg.count_lr_pow)
    q = state.q + lr * sum_td / cnt.clamp_min(1.0)

    # Periodic batched re-solve of every state's game (R1 on the card).
    v, pi_a, pi_b = state.v, state.pi_a, state.pi_b
    if step_now % lcfg.resolve_every == lcfg.resolve_every - 1:
        v, pi_a, pi_b = solve_matrix_games(q, iters=lcfg.solver_iters)
    new = MinimaxQState(q=q, v=v, pi_a=pi_a, pi_b=pi_b, env=env2,
                        step=state.step + 1, n=n)
    return new, td.abs().mean()


def _minimax_train(eng: _Engine, lcfg: MinimaxQConfig,
                   state: MinimaxQState, n_steps: int, mesh=None):
    step0 = int(state.step)   # the host's step count, read once
    return _train(
        lambda s, i, co: _minimax_step_engine(eng, lcfg, s, i, co, mesh),
        state, n_steps, period=lcfg.resolve_every, step0=step0,
        coeffs=lambda i: _minimax_coeffs(lcfg, i), mesh=mesh)


def minimax_step(cfg: EnvConfig, lcfg: MinimaxQConfig, state: MinimaxQState,
                 psum_axis=None):
    """One act/step/update.  Returns (state, mean |TD|, this rank's);
    ``psum_axis`` as for ``iql_step``."""
    state, td = _minimax_train(_batch_engine(cfg), lcfg, state, 1,
                               psum_axis)
    return state, td[0]


def minimax_train(cfg: EnvConfig, lcfg: MinimaxQConfig,
                  state: MinimaxQState, n_steps: int, psum_axis=None):
    """``n_steps`` of minimax-Q.  Returns (state, mean |TD| per step)."""
    return _minimax_train(_batch_engine(cfg), lcfg, state, n_steps,
                          psum_axis)


def multigrid_minimax_init(cfgs, key, n_envs: int,
                           device="cuda") -> MinimaxQState:
    """Minimax-Q over a mixed-geometry batch: Q/V/pi concatenated over the
    variants, every variant's states re-solved together."""
    codec = multigrid.build_codec(tuple(cfgs))
    return _minimax_state(codec.nS_total,
                          multigrid.init(tuple(cfgs), key, n_envs, device))


def multigrid_minimax_train(cfgs, lcfg: MinimaxQConfig,
                            state: MinimaxQState, n_steps: int,
                            psum_axis=None):
    """Minimax-Q training over a mixed-geometry batch."""
    return _minimax_train(_multigrid_engine(multigrid.build_codec(
        tuple(cfgs))), lcfg, state, n_steps, psum_axis)


# ----------------------------------------------------------------------
# Alternating-turn Q-learning (turn-based minimax TD)
# ----------------------------------------------------------------------

class AltQState(NamedTuple):
    q: torch.Tensor     # [nS_alt, 5] A-perspective value of mover actions
    env: object         # envs.soccer_alternating_env.AltEnvState
    step: torch.Tensor  # int32 scalar


class AltQConfig(NamedTuple):
    lr: float = 0.2
    gamma: float = 0.99
    eps: float = 0.2


def altq_init(cfg: EnvConfig, key, n_envs: int, device="cuda") -> AltQState:
    """A zero table and ``alt_init(cfg, key, n_envs)`` on ``device``."""
    from ..envs import soccer_alternating_env as alt
    env = alt.alt_init(cfg, key, n_envs, device=device)
    return AltQState(q=torch.zeros((alt.build_alt_tables(cfg).nS, N_ACTIONS),
                                   dtype=torch.float32, device=env.t.device),
                     env=env, step=_zero_step(env.t.device))


@functools.lru_cache(maxsize=None)
def _alt_turns(cfg: EnvConfig, device: torch.device):
    from ..envs import soccer_alternating_env as alt
    return torch.as_tensor(alt.build_alt_tables(cfg).turn, device=device)


def _altq_step(cfg: EnvConfig, lcfg: AltQConfig, state: AltQState, fa, fb,
               mesh=None):
    from ..envs import soccer_alternating_env as alt
    st = state.env
    turn_of = _alt_turns(cfg, state.q.device)
    obs = alt.alt_observe(cfg, st).long()
    u = batch.per_env_uniforms(alt._env_view(st), 2, salt=1).T
    mover_is_a = st.turn == 0
    qrow = state.q[obs]
    greedy = torch.where(mover_is_a, qrow.argmax(-1), qrow.argmin(-1))
    rand = (u[1] * N_ACTIONS).to(torch.int64) % N_ACTIONS
    a = torch.where(u[0] < _f32(lcfg.eps), rand, greedy)
    if fa is not None:
        a = torch.where(mover_is_a, fa[obs], a)
    if fb is not None:
        a = torch.where(mover_is_a, a, fb[obs])

    env2, (reward_a, goal, trunc), (_, final_obs) = alt.alt_step_obs(
        cfg, st, a)
    final_obs = final_obs.long()
    term = goal | trunc
    cont = torch.where(term, 0.0, 1.0)
    next_is_a = turn_of[final_obs] == 0
    # Bootstrap: minimax (max at A-to-move, min at B-to-move), except a
    # frozen side, whose reply is known: V(s') = Q[s', frozen[s']].
    qn = state.q[final_obs]
    v_a = qn.max(-1).values if fa is None else state.q[final_obs,
                                                       fa[final_obs]]
    v_b = qn.min(-1).values if fb is None else state.q[final_obs,
                                                       fb[final_obs]]
    vnext = torch.where(next_is_a, v_a, v_b)
    tgt = reward_a + _f32(lcfg.gamma) * cont * vnext
    td = tgt - state.q[obs, a]

    cells = obs * N_ACTIONS + a
    n = state.q.numel()
    sum_td, cnt = _psum(mesh, *scatter_kernel.scatter_add(cells, td, n))
    q = state.q + (_f32(lcfg.lr) * sum_td / cnt.clamp_min(1.0)
                   ).view_as(state.q)
    return AltQState(q=q, env=env2, step=state.step + 1), td.abs().mean()


def altq_step(cfg: EnvConfig, lcfg: AltQConfig, state: AltQState,
              psum_axis=None, frozen_a=None, frozen_b=None):
    """One act/step/update on the alternating-turn game: Q-learning on the
    exact minimax Bellman operator of ``alt_value_iteration`` (bootstrap
    max at A-to-move states, min at B-to-move states), eps-greedy for the
    mover.  ``frozen_a``/``frozen_b`` clamp that side's moves to an int
    [nS] policy and bootstrap its next states with Q[s', frozen[s']].
    Returns (state, mean |TD|, this rank's); ``psum_axis`` as for
    ``iql_step``."""
    dev = state.q.device
    return _altq_step(cfg, lcfg, state, _policy(frozen_a, dev),
                      _policy(frozen_b, dev), psum_axis)


def altq_train(cfg: EnvConfig, lcfg: AltQConfig, state: AltQState,
               n_steps: int, psum_axis=None, frozen_a=None, frozen_b=None):
    """``n_steps`` of ``altq_step``.  Returns (state, mean |TD| per
    step)."""
    dev = state.q.device
    fa, fb = _policy(frozen_a, dev), _policy(frozen_b, dev)
    return _train(lambda s, i, co: _altq_step(cfg, lcfg, s, fa, fb,
                                              psum_axis),
                  state, n_steps, mesh=psum_axis)
