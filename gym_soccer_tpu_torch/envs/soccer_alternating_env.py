"""Alternating-turn soccer: tables, exact solvers, a policy rollout and the
single-env facade.

The port of gym_soccer_tpu/envs/soccer_alternating_env.py.  Players move
one at a time and ``turn`` (0 = A moves) is part of the state.  The mover's
displacement may slip orthogonally (prob ``slip_prob``, split 50/50);
moving into the opponent's cell bounces back and hands the opponent the
ball; carrying the ball into a goal cell ends the episode with the
A-perspective reward +-1.

* ``alt_transition``, ``build_alt_tables`` and ``alt_value_iteration`` are
  numpy, copied so that their arrays equal the JAX package's byte for
  byte; ``alt_value_iteration_torch`` is the twin of the JAX package's
  jitted ``alt_value_iteration_jax`` on tensors.
* ``AltEnvState``, ``alt_init``, ``alt_step`` and ``alt_reset_where``
  are the batched engine on per-instance threefry keys, equal to the JAX
  package's bit for bit.  On CUDA tensors ``alt_step`` (and
  ``alt_step_obs``, which also writes the learners' observations) is
  kernel S3 (ops/mixed_alt_kernel): the whole tick, its transition and
  reset draws included, in one launch; ``alt_step_plain`` is its plain
  version, which ``alt_step`` runs on CPU tensors.  ``alt_init`` and
  ``alt_reset_where`` draw through core/batch (kernel T1 on a CUDA
  tensor).
* ``alt_policy_rollout`` plays two policy arrays against each other
  through ``alt_step`` from ``key(seed)``, as the JAX version does: the
  same (wins, losses, truncations) bit for bit.
* ``SoccerAlternatingEnv`` is the single-env facade, stepping on numpy's
  ``RandomState`` exactly as the JAX package's does.

The fused random rollout of this game is ops/step_kernel ``alt_rollout``
(the counter PRNG) and its learner ops/altq_kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import spaces
from ..config import MOVES, N_ACTIONS, EnvConfig, orthogonal_moves
from ..core import batch as corebatch
from ..core import rules, threefry
from ..core.tables import (_move_variants, build_isd, build_statespace,
                           isd_fields)
from ..ops import mixed_alt_kernel


def alt_transition(xp, xa, ya, xb, yb, p, turn, action, mc, mr, cfg):
    """Pure single-move resolution (broadcastable).  ``turn`` 0 = A moves.

    Returns (nxa, nya, nxb, nyb, npz, nturn)."""
    mover_x = xp.where(turn == 0, xa, xb)
    mover_y = xp.where(turn == 0, ya, yb)
    opp_x = xp.where(turn == 0, xb, xa)
    opp_y = xp.where(turn == 0, yb, ya)
    has_ball = p == turn

    nx, ny = rules.next_cell(xp, mover_x, mover_y, mc, mr, has_ball, cfg)

    # Steal rule: stepping into the opponent bounces back and flips
    # possession to the opponent.
    collide = (nx == opp_x) & (ny == opp_y)
    nx = xp.where(collide, mover_x, nx)
    ny = xp.where(collide, mover_y, ny)
    npz = xp.where(collide, 1 - turn, p)

    nxa = xp.where(turn == 0, nx, xa)
    nya = xp.where(turn == 0, ny, ya)
    nxb = xp.where(turn == 0, xb, nx)
    nyb = xp.where(turn == 0, yb, ny)
    return nxa, nya, nxb, nyb, npz, 1 - turn


class AltEnvState(NamedTuple):
    """Batched alternating-turn state: int32 [B] fields, the mover
    ``turn`` (0 = A), int64 [B, 2] per-instance key words."""
    rows_a: torch.Tensor
    cols_a: torch.Tensor
    rows_b: torch.Tensor
    cols_b: torch.Tensor
    poss: torch.Tensor
    turn: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor
    key: torch.Tensor


def _env_view(state: AltEnvState) -> corebatch.EnvState:
    return corebatch.EnvState(state.rows_a, state.cols_a, state.rows_b,
                              state.cols_b, state.poss, state.t, state.n,
                              state.key)


def alt_init(cfg: EnvConfig, key: torch.Tensor, batch: int,
             first_mover: int = 0, device="cuda") -> AltEnvState:
    """``batch.init`` on ``device`` with every lane's turn ``first_mover``."""
    st = corebatch.init(cfg, key, batch, device)
    return AltEnvState(rows_a=st.rows_a, cols_a=st.cols_a, rows_b=st.rows_b,
                       cols_b=st.cols_b, poss=st.poss,
                       turn=torch.full_like(st.poss, first_mover),
                       t=st.t, n=st.n, key=st.key)


def alt_step(cfg: EnvConfig, state: AltEnvState, action: torch.Tensor,
             autoreset: bool = True):
    """Batched alternating-turn step for the current mover of each lane:
    ``alt_step_plain`` on CPU tensors; on CUDA tensors one launch of
    kernel S3, which computes the same outputs bit for bit and raises if
    it cannot launch.  Returns (state, (reward_a, goal, truncated))."""
    if state.key.device.type == "cpu":
        return alt_step_plain(cfg, state, action, autoreset)
    return _alt_step_on_card(cfg, state, action, autoreset)[:2]


def alt_step_obs(cfg: EnvConfig, state: AltEnvState, action: torch.Tensor,
                 autoreset: bool = True):
    """``alt_step`` that also observes: returns (state, (reward_a, goal,
    truncated), (obs, final_obs)), ``obs`` the ``alt_observe`` of the new
    state and ``final_obs`` that of the state before the reset.
    ``alt_step_obs_plain`` on CPU tensors; on CUDA tensors one launch of
    S3."""
    if state.key.device.type == "cpu":
        return alt_step_obs_plain(cfg, state, action, autoreset)
    return _alt_step_on_card(cfg, state, action, autoreset)


def alt_step_obs_plain(cfg: EnvConfig, state: AltEnvState,
                       action: torch.Tensor, autoreset: bool = True):
    """Plain version of ``alt_step_obs``, on any device: ``alt_step_plain``
    without reset, the observation, then ``alt_reset_where`` on the lanes
    that ended (the stream of ``alt_step_plain``'s autoreset)."""
    mid, out = alt_step_plain(cfg, state, action, autoreset=False)
    final_obs = alt_observe(cfg, mid)
    new = alt_reset_where(cfg, mid, out[1] | out[2]) if autoreset else mid
    return new, out, (alt_observe(cfg, new), final_obs)


@functools.lru_cache(maxsize=None)
def alt_device_maps(cfg: EnvConfig, device: torch.device) -> torch.Tensor:
    """The alternating tables' ``raw_to_dense`` (int32 [n_raw * 2]) on
    ``device``, cached."""
    return torch.as_tensor(build_alt_tables(cfg).raw_to_dense, device=device)


class AltResetTable(NamedTuple):
    """The board's ISD on the host, as S3 takes it in its launch's
    arguments: each entry's (ra, ca, rb, cb, p), the float32 cumulative
    thresholds ``batch.device_maps`` holds (``isd_cum``, as Python floats)
    and each entry's ``alt_observe`` at turn 0."""
    fields: tuple
    cum: tuple
    obs: tuple


@functools.lru_cache(maxsize=None)
def alt_reset_table(cfg: EnvConfig) -> AltResetTable:
    """The ISD of ``cfg``'s board with each entry's observation at turn 0,
    from the host's tables, cached: what S3's reset selects from, so that
    it reads no table on the card."""
    ss = build_statespace(cfg)
    fields = isd_fields(cfg)
    cum = np.cumsum(ss.isd_probs).astype(np.float32)
    r2d = build_alt_tables(cfg).raw_to_dense
    raw = alt_raw_encode(np, *fields.T.astype(np.int64), 0, cfg)
    raw = np.clip(np.where(raw < 0, raw + len(r2d), raw), 0, len(r2d) - 1)
    return AltResetTable(tuple(tuple(int(x) for x in f) for f in fields),
                         tuple(float(c) for c in cum),
                         tuple(int(r2d[r]) for r in raw))


def alt_observe(cfg: EnvConfig, state: AltEnvState) -> torch.Tensor:
    """Dense alternating-state index of each lane (int32 [B]; goal states
    0, unreachable -1).  A code off the table (a lane that walked on from a
    goal without autoreset) is read as JAX's gather reads it: a negative
    code counts from the end, then the code is clamped to the table."""
    r2d = alt_device_maps(cfg, state.key.device)
    raw = alt_raw_encode(torch, state.rows_a, state.cols_a, state.rows_b,
                         state.cols_b, state.poss, state.turn, cfg).long()
    raw = torch.where(raw < 0, raw + len(r2d), raw).clamp(0, len(r2d) - 1)
    return r2d[raw]


def _alt_step_on_card(cfg, state, action, autoreset):
    dev = state.key.device
    ints, reward, flags = mixed_alt_kernel.alt_step(
        cfg, state[:8], state.key, action, alt_device_maps(cfg, dev),
        alt_reset_table(cfg), autoreset)
    ra, ca, rb, cb, poss, turn, t, n, obs, final_obs = ints.unbind()
    return (AltEnvState(ra, ca, rb, cb, poss, turn, t, n, state.key),
            (reward, flags[0], flags[1]), (obs, final_obs))


def alt_step_plain(cfg: EnvConfig, state: AltEnvState, action: torch.Tensor,
                   autoreset: bool = True):
    """Plain PyTorch version of ``alt_step``, on any device."""
    u = corebatch.per_env_uniforms(_env_view(state), 2)
    action = action.to(torch.int32)
    variant = corebatch._slip_variant(cfg, u[:, 0])
    mc, mr = corebatch._slipped_move_arith(action, variant)

    nra, nca, nrb, ncb, npz, nturn = alt_transition(
        torch, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, state.turn, action, mc, mr, cfg)

    now_goal = rules.is_goal_state(torch, nra, nca, nrb, ncb, npz, cfg)
    ball_col = torch.where(npz == 0, nca, ncb)
    reward_a = torch.where(
        now_goal, torch.where(ball_col == cfg.W - 1, 1.0, -1.0), 0.0
    ).to(torch.float32)

    t = state.t + 1
    truncated = t >= cfg.max_steps
    mid = AltEnvState(nra, nca, nrb, ncb, npz, nturn, t, state.n + 1,
                      state.key)
    if autoreset:
        mid = alt_reset_where(cfg, mid, now_goal | truncated)
    return mid, (reward_a, now_goal, truncated)


def alt_reset_where(cfg: EnvConfig, state: AltEnvState,
                    mask: torch.Tensor) -> AltEnvState:
    """Re-sample masked lanes from the ISD (turn resets to first mover 0)."""
    env_new = corebatch._reset_where(cfg, _env_view(state), mask)
    return AltEnvState(env_new.rows_a, env_new.cols_a, env_new.rows_b,
                       env_new.cols_b, env_new.poss,
                       torch.where(mask, 0, state.turn),
                       env_new.t, env_new.n, state.key)


# Per (state, action) there are at most 3 outcomes: the intended move
# (prob 1-q) and the two orthogonal slips (q/2 each), in the facade
# step()'s sampling order.
ALT_MAX_TRANSITIONS = 3


@dataclasses.dataclass
class AltTables:
    """Dense tabular dynamics of the alternating-turn game.

    States are (xa, ya, xb, yb, p, turn); the mover of state ``s`` is
    ``turn[s]``.  Dense index 0 is the absorbing terminal (all goal states
    map there)."""
    cfg: EnvConfig
    nS: int
    raw_to_dense: np.ndarray   # [n_raw * 2] int32; -1 unreachable, 0 goal
    dense_to_raw: np.ndarray   # [nS] int32 (raw*2 + turn codes)
    fields: np.ndarray         # [nS, 6] int32 (xa, ya, xb, yb, p, turn)
    turn: np.ndarray           # [nS] int32 — mover of each dense state
    t_prob: np.ndarray         # [nS, nA, 3] float64
    t_next_dense: np.ndarray   # [nS, nA, 3] int32
    t_reward: np.ndarray       # [nS, nA, 3] float64 (A-perspective)
    t_done: np.ndarray         # [nS, nA, 3] bool


def alt_raw_encode(xp, xa, ya, xb, yb, p, turn, cfg: EnvConfig):
    """Mixed-radix code over (simultaneous raw code, turn)."""
    return rules.raw_encode(xp, xa, ya, xb, yb, p, cfg) * 2 + turn


@functools.lru_cache(maxsize=None)
def build_alt_tables(cfg: EnvConfig) -> AltTables:
    """Vectorised enumeration of the alternating-turn dynamics: the
    simultaneous game's reachability classification crossed with the two
    turn values."""
    n_raw2 = cfg.n_raw * 2
    code = np.arange(n_raw2, dtype=np.int64)
    xa, ya, xb, yb, p = rules.raw_decode(np, code >> 1, cfg)

    unreach = rules.is_unreachable(np, xa, ya, xb, yb, p, cfg)
    goal = ~unreach & rules.is_goal_state(np, xa, ya, xb, yb, p, cfg)
    reach = ~unreach & ~goal

    raw_to_dense = np.full(n_raw2, -1, dtype=np.int32)
    raw_to_dense[reach] = np.cumsum(reach)[reach].astype(np.int32)
    raw_to_dense[goal] = 0
    nS = int(reach.sum()) + 1

    dense_to_raw = np.zeros(nS, dtype=np.int32)
    dense_to_raw[raw_to_dense[reach]] = code[reach]
    dense_to_raw[0] = code[goal][-1]

    fxa, fya, fxb, fyb, fp = rules.raw_decode(np, dense_to_raw >> 1, cfg)
    fturn = (dense_to_raw & 1).astype(np.int32)
    fields = np.stack([fxa, fya, fxb, fyb, fp, fturn], axis=-1).astype(np.int32)

    # --- transition expansion: [nS, nA, 3] ---------------------------------
    mv = _move_variants()                       # [nA, 3, 2] (dcol, drow)
    mc = mv[None, :, :, 0]
    mr = mv[None, :, :, 1]
    sxa, sya = fxa[:, None, None], fya[:, None, None]
    sxb, syb = fxb[:, None, None], fyb[:, None, None]
    sp, st = fp[:, None, None], fturn[:, None, None]
    act = np.arange(N_ACTIONS, dtype=np.int32)[None, :, None]

    nxa, nya, nxb, nyb, npz, nturn = alt_transition(
        np, sxa, sya, sxb, syb, sp, st, act, mc, mr, cfg)
    nxt = alt_raw_encode(np, nxa, nya, nxb, nyb, npz,
                         np.broadcast_to(nturn, nxa.shape), cfg)
    done = rules.is_goal_state(np, nxa, nya, nxb, nyb, npz, cfg)
    reward = np.where(done, rules.goal_reward_a(np, nxa, nya, nxb, nyb,
                                                npz, cfg), 0.0)
    t_next_dense = raw_to_dense[nxt].astype(np.int32)
    t_next_dense = np.broadcast_to(t_next_dense,
                                   (nS, N_ACTIONS, ALT_MAX_TRANSITIONS)).copy()
    done = np.broadcast_to(done, t_next_dense.shape).copy()
    reward = np.broadcast_to(reward, t_next_dense.shape).copy()

    q = float(cfg.slip_prob)
    t_prob = np.broadcast_to(
        np.array([1.0 - q, q * 0.5, q * 0.5], dtype=np.float64),
        t_next_dense.shape).copy()

    # Dense 0 is the absorbing terminal: self-loop, reward 0, done.
    t_prob[0] = 0.0
    t_prob[0, :, 0] = 1.0
    t_next_dense[0] = 0
    t_reward = reward
    t_reward[0] = 0.0
    done[0] = True

    if (t_next_dense < 0).any():
        raise AssertionError("alternating step left the state space")
    return AltTables(cfg=cfg, nS=nS, raw_to_dense=raw_to_dense,
                     dense_to_raw=dense_to_raw, fields=fields, turn=fturn,
                     t_prob=t_prob, t_next_dense=t_next_dense,
                     t_reward=t_reward, t_done=done)


def alt_value_iteration(tb: AltTables, theta: float = 1e-10,
                        gamma: float = 0.99,
                        frozen_a: np.ndarray | None = None,
                        frozen_b: np.ndarray | None = None):
    """Turn-based minimax value iteration (A-perspective values, numpy).

    At A-to-move states V = max_a Q, at B-to-move states V = min_a Q: the
    exact solution of the zero-sum turn game.  ``frozen_a``/``frozen_b``
    (int [nS] policies) clamp that side's choice instead, which makes the
    sweep best-response planning against a frozen opponent.

    Returns (pi, V, Q, sweeps): ``pi[s]`` is the mover's action."""
    prob, ns = tb.t_prob, tb.t_next_dense
    rew, done = tb.t_reward, tb.t_done
    turn = tb.turn
    idx = np.arange(tb.nS)
    V = np.zeros(tb.nS, dtype=np.float64)
    cc = 0
    while True:
        cont = np.where(done, 0.0, V[ns])
        Q = np.einsum("sak,sak->sa", prob, rew + gamma * cont, optimize=True)
        va = Q.max(axis=1) if frozen_a is None else Q[idx, frozen_a]
        vb = Q.min(axis=1) if frozen_b is None else Q[idx, frozen_b]
        newV = np.where(turn == 0, va, vb)
        cc += 1
        if np.max(np.abs(V - newV)) < theta:
            break
        V = newV
    pa = Q.argmax(axis=1) if frozen_a is None else frozen_a
    pb = Q.argmin(axis=1) if frozen_b is None else frozen_b
    pi = np.where(turn == 0, pa, pb).astype(np.int32)
    return pi, newV, Q, cc


def alt_value_iteration_torch(t_prob, t_next_dense, t_reward, t_done, turn,
                              theta: float = 1e-6, gamma: float = 0.99,
                              max_sweeps: int = 20_000, device="cuda"):
    """Turn-based minimax value iteration on tensors: the twin of the JAX
    package's ``alt_value_iteration_jax`` (the same sweep and stop rule:
    sweep while the last sweep moved V by ``theta`` or more and fewer than
    ``max_sweeps`` sweeps ran).  The tables (tensors or arrays, as
    ``AltTables`` holds them) go to ``device``; the dtype follows
    ``t_prob``.

    Returns (pi, V, Q, sweeps) with ``pi[s]`` the mover's action (int32)
    and ``sweeps`` an int."""
    device = torch.device(device)
    prob = torch.as_tensor(t_prob, device=device)
    nxt = torch.as_tensor(t_next_dense, device=device).long()
    rew = torch.as_tensor(t_reward, device=device)
    done = torch.as_tensor(t_done, device=device)
    a_moves = torch.as_tensor(turn, device=device) == 0
    nS, nA = prob.shape[:2]
    V = torch.zeros(nS, dtype=prob.dtype, device=device)
    Q = torch.zeros((nS, nA), dtype=prob.dtype, device=device)
    cc, delta = 0, float("inf")
    while delta >= theta and cc < max_sweeps:
        cont = torch.where(done, 0.0, V[nxt])
        Q = (prob * (rew + gamma * cont)).sum(-1)
        newV = torch.where(a_moves, Q.max(1).values, Q.min(1).values)
        delta = float((V - newV).abs().max())   # one read a sweep
        V = newV
        cc += 1
    pi = torch.where(a_moves, Q.argmax(1), Q.argmin(1)).to(torch.int32)
    return pi, V, Q, cc


def alt_policy_rollout(cfg: EnvConfig, raw_to_dense, pol_a, pol_b,
                       batch: int = 512, steps: int = 400, seed: int = 0,
                       first_mover: int = 0, device="cuda"):
    """Batched closed-loop evaluation: both sides play their int [nS]
    policy arrays through ``alt_step`` (autoreset on) for ``steps`` ticks
    on ``batch`` lanes from ``alt_init(cfg, key(seed), batch,
    first_mover)`` on ``device``.

    Returns (wins_a, losses_a, truncations) summed over all lanes and
    steps, the JAX package's numbers bit for bit."""
    device = torch.device(device)
    r2d = torch.as_tensor(np.asarray(raw_to_dense), device=device).long()
    pa = torch.as_tensor(np.asarray(pol_a), device=device).to(torch.int32)
    pb = torch.as_tensor(np.asarray(pol_b), device=device).to(torch.int32)
    st = alt_init(cfg, threefry.key(seed), batch, first_mover, device)
    wins = torch.zeros((), dtype=torch.int64, device=device)
    losses, truncs = torch.zeros_like(wins), torch.zeros_like(wins)
    for _ in range(steps):
        s = r2d[alt_raw_encode(torch, st.rows_a, st.cols_a, st.rows_b,
                               st.cols_b, st.poss, st.turn, cfg).long()]
        a = torch.where(st.turn == 0, pa[s], pb[s])
        st, (rew, _, trunc) = alt_step(cfg, st, a)
        wins += (rew > 0).sum()
        losses += (rew < 0).sum()
        truncs += trunc.sum()
    return int(wins), int(losses), int(truncs)


class SoccerAlternatingEnv:
    """Single-env alternating-turn facade (dict API like the simultaneous
    facade; one agent acts per step, the one named by `current_player`)."""

    NOOP, NORTH, SOUTH, EAST, WEST = 0, 1, 2, 3, 4
    ACTION_STRING = ['NOOP', 'NORTH', 'SOUTH', 'EAST', 'WEST']
    TERMINAL_STATE = (-1, -1, -1, -1, -1, -1)

    def __init__(self, width=5, height=4, slip_prob=0.0, seed=0,
                 first_mover=0, max_steps=100):
        assert width >= 5, "Width must be at least 5 columns."
        assert height >= 4, "Height must be at least 4 rows."
        self.cfg = EnvConfig(width=width, height=height,
                             slip_prob=float(slip_prob),
                             max_steps=int(max_steps))
        self.width, self.height = self.cfg.W, self.cfg.H
        self.slip_prob = float(slip_prob)
        self.goal_rows, self.goal_cols = self.cfg.goal_rows, self.cfg.goal_cols
        self.np_random = np.random.RandomState(seed)
        self.first_mover = first_mover
        self.agents = ['player_a', 'player_b']
        obs_nvec = (self.height, self.width, self.height, self.width, 2)
        self.observation_space = spaces.Dict({
            a: spaces.MultiDiscrete(obs_nvec) for a in self.agents})
        self.action_space = spaces.Dict({
            a: spaces.Discrete(5) for a in self.agents})
        self._isd = self._make_isd()
        self.state = None            # (xa, ya, xb, yb, p, turn)
        self.needs_reset = True
        self.timestep = 0
        self.lastaction = None

    def _make_isd(self):
        probs, raws = build_isd(self.cfg)
        return [(float(p), rules.raw_decode(np, int(r), self.cfg))
                for p, r in zip(probs, raws)]

    @property
    def current_player(self):
        assert self.state is not None, "reset first"
        return 'player_a' if self.state[5] == 0 else 'player_b'

    @property
    def tables(self) -> AltTables:
        """Dense tabular dynamics (built lazily, cached per config)."""
        return build_alt_tables(self.cfg)

    @property
    def nS(self) -> int:
        return self.tables.nS

    @functools.cached_property
    def state_space(self):
        """(xa, ya, xb, yb, p, turn) tuple -> dense index, including the
        TERMINAL_STATE -> 0 entry; built once."""
        tb = self.tables
        out = {self.TERMINAL_STATE: 0}
        out.update({tuple(int(v) for v in tb.fields[s]): s
                    for s in range(1, tb.nS)})
        return out

    @functools.cached_property
    def P(self):
        """Transition dict view: P[s][a] -> ordered [(prob, next_dense,
        reward_a, done)], zero-probability slip slots dropped; built
        once."""
        tb = self.tables
        out = {}
        for s in range(tb.nS):
            row = {}
            for a in range(N_ACTIONS):
                row[a] = [
                    (float(tb.t_prob[s, a, k]), int(tb.t_next_dense[s, a, k]),
                     float(tb.t_reward[s, a, k]), bool(tb.t_done[s, a, k]))
                    for k in range(ALT_MAX_TRANSITIONS)
                    if tb.t_prob[s, a, k] > 0.0]
            out[s] = row
        return out

    def _obs(self):
        xa, ya, xb, yb, p, turn = self.state
        # Egocentric tuples: own position first, own-possession bit.
        return {
            'player_a': (xa, ya, xb, yb, 1 if p == 0 else 0),
            'player_b': (xb, yb, xa, ya, 1 if p == 1 else 0),
        }

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.np_random.seed(seed)
        u = self.np_random.random()
        cum = np.cumsum([p for p, _ in self._isd])
        i = int(np.argmax(cum > u))
        _, st = self._isd[i]
        self.state = (*st, self.first_mover)
        self.needs_reset = False
        self.timestep = 0
        self.lastaction = None
        return self._obs(), {a: {} for a in self.agents}

    def step(self, action: int):
        """`action` is the CURRENT mover's action (int)."""
        assert not self.needs_reset, "reset the environment first"
        xa, ya, xb, yb, p, turn = self.state
        mc, mr = MOVES[action]
        u = self.np_random.random()
        if u >= 1.0 - self.slip_prob:
            o0, o1 = orthogonal_moves((mc, mr))
            mc, mr = o0 if u < 1.0 - self.slip_prob * 0.5 else o1
        nxa, nya, nxb, nyb, npz, nturn = alt_transition(
            np, xa, ya, xb, yb, p, turn, action, mc, mr, self.cfg)
        state = tuple(int(v) for v in (nxa, nya, nxb, nyb, npz, nturn))
        self.state = state
        self.lastaction = action
        self.timestep += 1
        done = bool(rules.is_goal_state(np, *state[:5], self.cfg))
        ball_col = state[1] if state[4] == 0 else state[3]
        reward_a = (0.0 if not done
                    else 1.0 if ball_col == self.cfg.W - 1 else -1.0)
        truncated = self.timestep >= self.cfg.max_steps
        self.needs_reset = done or truncated
        rewards = {'player_a': reward_a, 'player_b': -reward_a}
        dones = {a: done for a in self.agents}
        truncs = {a: truncated for a in self.agents}
        return self._obs(), rewards, dones, truncs, {a: {} for a in self.agents}
