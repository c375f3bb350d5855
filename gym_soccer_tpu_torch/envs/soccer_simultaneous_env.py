"""Reference-compatible single-environment facade (a copy of
gym_soccer_tpu/envs/soccer_simultaneous_env.py, on the port's ``spaces``,
``config``, ``core/rules`` and ``core/tables``; host numpy, as there).

Drop-in replacement for the reference ``SoccerSimultaneousEnv``
(gym_soccer/envs/soccer_simultaneous_env.py): identical
constructor contract, attributes (``P``/``P_readable``/``Pmat``/``Rmat``/
``nS``/``nA``/``isd``/``state_space``/spaces/action constants), ``step``/
``reset``/``render`` behavior, state-injection support, and — bit-for-bit —
the same MT19937 + float64-cumsum sampling stream.

Engineering differences from the reference:
  * dynamics come from the vectorized table build (core/tables.py), ~5-30x
    faster than the reference's Python loops;
  * ``step`` samples from dense padded arrays (a row gather + cumsum
    compare) instead of Python transition lists — same math, same stream;
  * the big dict-of-lists views (``P``, ``P_readable``, ``Pmat``, ``Rmat``)
    are materialized lazily on first attribute access, so construction cost
    is paid only by consumers that need them (planners, schema tests).
"""
from __future__ import annotations

import bisect

import numpy as np

from .. import spaces
from ..config import MOVES, ACTION_STRING as _ACTION_STRING, EnvConfig
from ..core import rules
from ..core.tables import GameTables, build_tables, collapse_single_agent

# Table build results are pure functions of the config; cache across env
# instances (test suites construct many envs of the same geometry).
_TABLE_CACHE: dict[EnvConfig, GameTables] = {}


def get_tables(cfg: EnvConfig) -> GameTables:
    tb = _TABLE_CACHE.get(cfg)
    if tb is None:
        tb = _TABLE_CACHE[cfg] = build_tables(cfg)
    return tb


def _first_exceedance(cum: np.ndarray, u: float) -> int:
    """gym 0.26 categorical_sample semantics: float64 cumulative sums,
    first index whose cumsum exceeds the uniform draw (argmax of the
    boolean vector, hence 0 when no entry exceeds)."""
    return int(np.argmax(cum > u))


class SoccerSimultaneousEnv:
    # Action encoding (reference :8-31)
    NOOP = 0
    NORTH = 1
    SOUTH = 2
    EAST = 3
    WEST = 4
    ACTION_STRING = list(_ACTION_STRING)
    ACTION_STRING_TO_INT = {k: v for v, k in enumerate(_ACTION_STRING)}
    ACTION_STRING_TO_MOVE = {_ACTION_STRING[a]: MOVES[a] for a in range(5)}
    MOVE_TO_ACTION_STRING = {MOVES[a]: _ACTION_STRING[a] for a in range(5)}
    ACTION_INT_TO_MOVE = {a: MOVES[a] for a in range(5)}
    MOVE_TO_ACTION_INT = {MOVES[a]: a for a in range(5)}
    TERMINAL_STATE = (-1, -1, -1, -1, -1)

    def __init__(self, width=5, height=4, slip_prob=0.0,
                 player_a_policy=None, player_b_policy=None, seed=0,
                 max_steps=100):
        # Constructor contract (reference :35-58).  ``max_steps`` realizes
        # the intended registration's max_episode_steps (the reference
        # hardcodes 100 at :404 and passes 100 in its commented-out
        # register() call, gym_soccer/__init__.py:5-12).
        assert not (player_a_policy is not None and player_b_policy is not None), \
            "Both players cannot have a policy. At least one must be None."
        assert width >= 5, "Width must be at least 5 columns."
        assert height >= 4, "Height must be at least 4 rows."

        self.cfg = EnvConfig(width=width, height=height,
                             slip_prob=float(slip_prob),
                             max_steps=int(max_steps))
        self.width = self.cfg.W  # internal width incl. goal columns (:48)
        self.height = self.cfg.H
        self.slip_prob = float(slip_prob)
        self.seed = seed
        self.player_a_policy = player_a_policy
        self.player_b_policy = player_b_policy
        self.multiagent = player_a_policy is None and player_b_policy is None
        self.return_agent = (["player_a", "player_b"] if self.multiagent
                             else ["player_a"] if player_a_policy is None
                             else ["player_b"])
        self.np_random = np.random.RandomState()
        self.np_random.seed(self.seed)

        self.goal_rows = self.cfg.goal_rows
        self.goal_cols = self.cfg.goal_cols

        tb = get_tables(self.cfg)
        self._tb = tb
        self.nS = tb.nS
        self.nA = 5

        # Reference-shaped state classification views (:63-109)
        reach_tuples = [tuple(t) for t in tb.fields[1:].tolist()]
        self.state_space = {self.TERMINAL_STATE: 0}
        self.state_space.update(
            {st: i for i, st in enumerate(reach_tuples, start=1)})
        self._reverse_state_space = {v: k for k, v in self.state_space.items()}
        self.unreachable_states = [
            rules.raw_decode(np, int(r), self.cfg)
            for r in tb.unreachable_raw.tolist()]
        goal_tuples = [rules.raw_decode(np, int(r), self.cfg)
                       for r in tb.goal_raw.tolist()]
        goal_rewards = tb.goal_reward_raw[tb.goal_raw].tolist()
        self.goal_states = dict(zip(goal_tuples, goal_rewards))

        self.observation_space = spaces.Dict(
            {a: spaces.Discrete(self.nS) for a in self.return_agent})
        self.action_space = spaces.Dict(
            {a: spaces.Discrete(self.nA) for a in self.return_agent})

        self.isd = [(float(p), rules.raw_decode(np, int(r), self.cfg))
                    for p, r in zip(tb.isd_probs, tb.isd_raw)]

        # Runtime sampling arrays: multiagent keeps the joint tensors;
        # single-agent collapses the frozen player's axis at build time
        # (reference :187-188, :242-244).
        if self.multiagent:
            self._arr = {
                "t_prob": tb.t_prob, "t_cum": tb.t_cum,
                "t_next_raw": tb.t_next_raw, "t_next_dense": tb.t_next_dense,
                "t_reward": tb.t_reward, "t_done": tb.t_done,
                "t_mask": tb.t_mask, "t_first": tb.t_first,
            }
        else:
            frozen = "player_a" if player_a_policy is not None else "player_b"
            pol_dict = player_a_policy if frozen == "player_a" else player_b_policy
            pol = np.asarray([pol_dict[s] for s in range(self.nS)],
                             dtype=np.int32)
            self._frozen_policy_arr = pol
            self._arr = collapse_single_agent(tb, frozen, pol)

        self._isd_cum = np.cumsum(tb.isd_probs)

        # Lazily-materialized dict/matrix views
        self._P = None
        self._P_readable = None
        self._Pmat = None
        self._Rmat = None
        # Per-(state,action) sampling rows converted to Python lists on
        # first use: single-env stepping is host-bound, and bisect over a
        # cached float list beats numpy scalar indexing ~4x.
        self._row_cache = {}
        # Hot-path state index: tuple -> dense (goals -> 0), replacing a
        # raw encode + numpy scalar read per step with one dict hash.
        self._dense_index = dict(self.state_space)
        self._dense_index.update((g, 0) for g in self.goal_states)
        self._max_steps = self.cfg.max_steps
        self._solo_agent = self.return_agent[0]

        self.needs_reset = True
        self.state = None
        self.observations = None
        self.lastaction = None
        self.timestep = 0

    # ------------------------------------------------------------------
    # Observation codecs (reference :487-497)
    # ------------------------------------------------------------------
    def _state_to_observation(self, state):
        state = self.TERMINAL_STATE if state in self.goal_states else tuple(state)
        return self.state_space[state]

    def _observation_to_state(self, observation):
        return self._reverse_state_space[observation]

    def _state_raw(self, state) -> int:
        xa, ya, xb, yb, p = state
        return int(rules.raw_encode(np, xa, ya, xb, yb, p, self.cfg))

    # ------------------------------------------------------------------
    # Runtime API (reference :375-424)
    # ------------------------------------------------------------------
    def reset(self, seed=None, options=None):
        if seed is not None:
            self.np_random.seed(seed)

        i = _first_exceedance(self._isd_cum, self.np_random.random())
        p, self.state = self.isd[i]
        self.observations = {a: self._state_to_observation(self.state)
                             for a in self.return_agent}
        infos = {a: {"p": np.round(p, 2)} for a in self.return_agent}
        self.lastaction = None
        self.needs_reset = False
        self.timestep = 0
        return self.observations, infos

    def step(self, action):
        assert not self.needs_reset, \
            "Please reset the environment before taking a step"
        assert isinstance(action, dict), "Action must be a dictionary"
        assert len(action) in (1, 2), \
            "Action must be a dictionary of length 1 or 2"
        only_agent = None
        if self.multiagent:
            assert len(action) == 2, \
                "Action must be a dictionary of length 2 for multiagent case"
            assert 'player_a' in action and 'player_b' in action, \
                "Action must contain both 'player_a' and 'player_b'"
        else:
            assert len(action) == 1, \
                "Action must be a dictionary of length 1 for single agent case"
            assert 'player_a' in action or 'player_b' in action, \
                "Action must contain either 'player_a' or 'player_b'"
            only_agent = ('player_a' if self.player_a_policy is None
                          else 'player_b')
            assert only_agent in action, \
                f"An action for {only_agent} must be provided"

        cur = tuple(self.state)
        s = self._dense_index.get(cur, -1)
        assert s >= 0, f"Cannot step from unreachable state {cur}"
        if self.multiagent:
            row = int(action['player_a']) * 5 + int(action['player_b'])
        else:
            row = int(action[only_agent])

        entry = self._row_cache.get((s, row))
        if entry is None:
            arr = self._arr
            cum = arr["t_cum"][s, row].tolist()
            # cache the np.round(prob, 2) the info dict needs (:405) and
            # the next state's observation index (goal states -> 0)
            outs = []
            for p, nr, r, d in zip(arr["t_prob"][s, row],
                                   arr["t_next_raw"][s, row],
                                   arr["t_reward"][s, row],
                                   arr["t_done"][s, row]):
                ns = rules.raw_decode(np, int(nr), self.cfg)
                # zero-probability padding slots may carry unreachable
                # states; they are never selected (cum is flat there, and
                # bisect_right skips past ties), so 0 is a safe placeholder
                outs.append((float(p), ns, float(r), bool(d),
                             np.round(p, 2), self._dense_index.get(ns, 0)))
            entry = self._row_cache[(s, row)] = (
                cum, outs, int(arr["t_first"][s, row]))

        cum, outs, first = entry
        u = self.np_random.random()
        # bisect_right == first index with cum > u (gym categorical_sample
        # semantics); past-the-end falls back to the list head like the
        # reference's argmax-over-all-False.
        i = bisect.bisect_right(cum, u)
        if i >= len(cum):
            i = first

        prob, ns_tuple, reward, done, prob_rounded, ns_obs = outs[i]
        if s == 0:
            # Absorbing goal state: the dense row's outcome points at the
            # class representative; the actual state self-loops (:300-301).
            ns_tuple = cur
        self.state = ns_tuple
        self.lastaction = action
        self.timestep = ts = self.timestep + 1
        trunc = ts >= self._max_steps
        self.needs_reset = done or trunc

        if self.multiagent:
            observations = {'player_a': ns_obs, 'player_b': ns_obs}
            rewards = {'player_a': reward, 'player_b': reward * -1}
            dones = {'player_a': done, 'player_b': done}
            truncateds = {'player_a': trunc, 'player_b': trunc}
            infos = {'player_a': {"p": prob_rounded},
                     'player_b': {"p": prob_rounded}}
        else:
            a0 = self._solo_agent
            observations = {a0: ns_obs}
            rewards = {a0: reward}
            dones = {a0: done}
            truncateds = {a0: trunc}
            infos = {a0: {"p": prob_rounded}}
        self.observations = observations

        return observations, rewards, dones, truncateds, infos

    # ------------------------------------------------------------------
    # Rendering (reference :426-485; format preserved)
    # ------------------------------------------------------------------
    def render(self):
        print(self.state)
        xa, ya, xb, yb, p = self.state

        print(f"Player A position: x={xa}, y={ya}, possession={p == 0}")
        print(f"Player B position: x={xb}, y={yb}, possession={p == 1}")

        pitch = [[' ' for _ in range(self.width)] for _ in range(self.height)]
        pitch[xa][ya] = 'A' + ('*' if p == 0 else ' ')
        pitch[xb][yb] = 'B' + ('*' if p == 1 else ' ')

        lines = ['  ' + '-' * (self.width * 2 - 4)]
        for ri, r in enumerate(pitch):
            if ri in self.goal_rows:
                if '*' in r[0]:
                    lines.append(''.join(f'{c:<2}' for c in r[0:-1]) + '||')
                elif '*' in r[-1]:
                    lines.append('||' + ''.join(f'{c:<2}' for c in r[1:]))
                else:
                    lines.append('||' + ''.join(f'{c:<2}' for c in r[1:-1]) + '||')
            else:
                lines.append(' |' + ''.join(f'{c:<2}' for c in r[1:-1]) + '| ')
        lines.append('  ' + '-' * (self.width * 2 - 4))
        for line in lines:
            print(line)

        print(f"Ball possession: {'A' if p == 0 else 'B'}")
        if self.lastaction and self.multiagent:
            action_a, action_b = self.lastaction.values()
            print(f"Last actions: A: {self.ACTION_STRING[action_a]}, "
                  f"B: {self.ACTION_STRING[action_b]}")
        elif self.lastaction and not self.multiagent:
            agent = 'player_a' if self.player_a_policy is None else 'player_b'
            tag = 'A' if agent == 'player_a' else 'B'
            print(f"Last action: {tag}: "
                  f"{self.ACTION_STRING[self.lastaction[agent]]}")

        if p == 0:
            if ya == 0 and xa in self.goal_rows:
                print("OWN GOAL! Player A scored in their own goal!")
            elif ya == self.width - 1 and xa in self.goal_rows:
                print("GOAL! Player A scored!")
        else:
            if yb == 0 and xb in self.goal_rows:
                print("GOAL! Player B scored!")
            elif yb == self.width - 1 and xb in self.goal_rows:
                print("OWN GOAL! Player B scored in their own goal!")

    # ------------------------------------------------------------------
    # Lazy table views (reference eagerly builds these in __init__,
    # :137; we materialize on first access)
    # ------------------------------------------------------------------
    @property
    def P(self):
        if self._P is None:
            self._P = self._build_P(readable=False)
        return self._P

    @P.setter
    def P(self, value):
        self._P = value

    @property
    def P_readable(self):
        if self._P_readable is None:
            self._P_readable = self._build_P(readable=True)
        return self._P_readable

    @P_readable.setter
    def P_readable(self, value):
        self._P_readable = value

    @property
    def Pmat(self):
        if self._Pmat is None:
            self._build_mats()
        return self._Pmat

    @Pmat.setter
    def Pmat(self, value):
        self._Pmat = value

    @property
    def Rmat(self):
        if self._Rmat is None:
            self._build_mats()
        return self._Rmat

    @Rmat.setter
    def Rmat(self, value):
        self._Rmat = value

    def _action_keys(self, readable: bool):
        if self.multiagent:
            if readable:
                return [(self.ACTION_STRING[a], self.ACTION_STRING[b])
                        for a in range(5) for b in range(5)]
            return [(a, b) for a in range(5) for b in range(5)]
        if readable:
            return [self.ACTION_STRING[a] for a in range(5)]
        return list(range(5))

    def _build_P(self, readable: bool):
        """Materialize the reference's dict-of-lists transition views from
        the dense arrays (compacted exactly like reference :199-287)."""
        arr = self._arr
        keys = self._action_keys(readable)
        n_rows = len(keys)
        probs = arr["t_prob"]
        mask = arr["t_mask"]
        nsd = arr["t_next_dense"]
        nsr = arr["t_next_raw"]
        rew = arr["t_reward"]
        done = arr["t_done"]

        P = {}
        if readable:
            # goal tuples self-loop in readable space; template row = s0
            s0_mask = mask[0]
            goal_entries_tpl = {}
            for k in range(n_rows):
                sel = np.flatnonzero(s0_mask[k])
                # note: in single-agent-B mode the build-time reward flip
                # (-1 * r) turns these 0.0 rewards into -0.0 (:242-244)
                goal_entries_tpl[keys[k]] = [
                    (float(probs[0, k, j]), None, float(rew[0, k, j]), True)
                    for j in sel]
            for gt in self.goal_states:
                P[gt] = {ak: [(pr, gt, r, d) for pr, _, r, d in lst]
                         for ak, lst in goal_entries_tpl.items()}
        else:
            s0_mask = mask[0]
            P[0] = {}
            for k in range(n_rows):
                sel = np.flatnonzero(s0_mask[k])
                P[0][keys[k]] = [
                    (float(probs[0, k, j]), 0, float(rew[0, k, j]), True)
                    for j in sel]

        raw_tuple_cache = {}

        def raw_tuple(r):
            t = raw_tuple_cache.get(r)
            if t is None:
                t = raw_tuple_cache[r] = rules.raw_decode(np, r, self.cfg)
            return t

        for s in range(1, self.nS):
            st_key = self._reverse_state_space[s] if readable else s
            entry = {}
            for k in range(n_rows):
                sel = np.flatnonzero(mask[s, k])
                if readable:
                    lst = [(float(probs[s, k, j]), raw_tuple(int(nsr[s, k, j])),
                            float(rew[s, k, j]), bool(done[s, k, j]))
                           for j in sel]
                else:
                    lst = [(float(probs[s, k, j]), int(nsd[s, k, j]),
                            float(rew[s, k, j]), bool(done[s, k, j]))
                           for j in sel]
                entry[keys[k]] = lst
            P[st_key] = entry
        return P

    def _build_mats(self):
        """Materialize dense Pmat/Rmat with the reference's exact sequential
        accumulation (:258-279), including the quirk that Pmat[0, 0] keeps
        accumulating across every goal state's rebuild while Rmat is
        re-zeroed (so Pmat[0, 0, .] == n_goal, not 1)."""
        arr = self._arr
        nS, nA = self.nS, self.nA
        if self.multiagent:
            pshape, rshape = (nS, nS, nA, nA), (nS, nA, nA)
        else:
            pshape, rshape = (nS, nS, nA), (nS, nA)
        Pmat = np.zeros(pshape, dtype=np.float64)
        Rmat = np.zeros(rshape, dtype=np.float64)

        probs = arr["t_prob"]      # [nS, n_rows, 36]
        mask = arr["t_mask"]
        nsd = arr["t_next_dense"]
        rew = arr["t_reward"]
        n_rows = probs.shape[1]

        # Reachable rows: flatten in (s, row, slot) order == reference's
        # per-cell sequential add order; np.add.at applies in order.
        sel = mask[1:].ravel()
        s_idx = np.repeat(np.arange(1, nS, dtype=np.int64),
                          n_rows * probs.shape[2])[sel]
        row_idx = np.tile(
            np.repeat(np.arange(n_rows, dtype=np.int64), probs.shape[2]),
            nS - 1)[sel]
        ns_idx = nsd[1:].ravel()[sel].astype(np.int64)
        pr = probs[1:].ravel()[sel]
        prw = pr * rew[1:].ravel()[sel]

        if self.multiagent:
            aa_idx, ab_idx = row_idx // nA, row_idx % nA
            np.add.at(Pmat, (s_idx, ns_idx, aa_idx, ab_idx), pr)
            np.add.at(Rmat, (s_idx, aa_idx, ab_idx), prw)
        else:
            np.add.at(Pmat, (s_idx, ns_idx, row_idx), pr)
            np.add.at(Rmat, (s_idx, row_idx), prw)

        # Goal rows: every goal state rebuilds P[0]; Pmat[0, 0] accumulates
        # sequentially over n_goal repetitions of the compact combo probs.
        n_goal = self._tb.n_goal
        for k in range(n_rows):
            mp = probs[0, k][mask[0, k]]
            acc = np.cumsum(np.tile(mp, n_goal))[-1] if mp.size else 0.0
            if self.multiagent:
                Pmat[0, 0, k // nA, k % nA] = acc
            else:
                Pmat[0, 0, k] = acc
        self._Pmat, self._Rmat = Pmat, Rmat
