"""Vectorized environment facade: gym.vector-style API over the batched
engine, the port of gym_soccer_tpu/envs/vector_env.py.

The reference is a single-instance env (soccer_simultaneous_env.py:375-424,
one dict step at a time); its ecosystem's standard scale-out surface is
``gym.vector``: batched reset/step over numpy arrays with autoreset and
``final_observation`` reporting.  This facade provides that surface on top
of core/batch.py: one lockstep transition a call on the device (``cuda``
unless the caller passes another), numpy in and numpy out.  Its draws are
the engine's threefry streams (kernel T1 on the card), so from the same
seed it returns the JAX package's arrays bit for bit.

Operating modes mirror the reference ctor contract (:35-58):

* **multiagent** (no frozen policies): actions are a dict
  ``{"player_a": int array [N], "player_b": int array [N]}``; rewards,
  terminations, truncations and infos are dicts keyed the same way, with
  ``player_b`` rewards the negation of ``player_a`` (zero-sum, :400-402).
* **single-agent** (exactly one frozen opponent policy, a dict or array
  mapping dense state -> action): actions are a bare int array [N] for the
  learning agent; the opponent's action is looked up on the device from
  its policy table; rewards are sign-flipped when the learner is player B
  (:242-244).

Autoreset follows gym.vector semantics: instances that terminate or
truncate return the NEXT episode's first observation, and the pre-reset
terminal observation is reported in ``infos["final_observation"]`` with
the standard ``infos["_final_observation"]`` mask.  Every step also reports
``infos["p"]``, the sampled transition's probability rounded to 2 decimals
per lane (the reference's per-agent info dict, :405).

For throughput keep rollouts on the device instead (core/batch.rollout or
ops/step_kernel); this facade pays one host round trip a call by design.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import spaces
from ..config import EnvConfig, N_ACTIONS
from ..core import batch, tables, threefry
from ..utils.metrics import EpisodeStats, chunk_stats


class SoccerVectorEnv:
    """Batched Littman-soccer environment with a gym.vector-style API."""

    metadata = {"render_modes": []}

    def __init__(self, num_envs: int, width: int = 5, height: int = 4,
                 slip_prob: float = 0.0, player_a_policy=None,
                 player_b_policy=None, seed: int = 0, max_steps: int = 100,
                 device="cuda"):
        if player_a_policy is not None and player_b_policy is not None:
            raise ValueError(
                "Cannot freeze both players (reference ctor assert :38).")
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        self.cfg = EnvConfig(width=width, height=height,
                             slip_prob=float(slip_prob),
                             max_steps=int(max_steps))
        self.nS = tables.build_statespace(self.cfg).nS
        self.nA = N_ACTIONS

        self._frozen = ("player_a" if player_a_policy is not None else
                        "player_b" if player_b_policy is not None else None)
        self.agents = (["player_a", "player_b"] if self._frozen is None else
                       ["player_b" if self._frozen == "player_a" else
                        "player_a"])
        pol = player_a_policy if player_a_policy is not None \
            else player_b_policy
        self._policy = None if pol is None else torch.as_tensor(
            _policy_array(pol, self.nS), device=self.device).long()

        self.single_observation_space = spaces.Discrete(self.nS)
        self.single_action_space = spaces.Discrete(self.nA)
        self.observation_space = spaces.Dict(
            {a: spaces.MultiDiscrete([self.nS] * self.num_envs)
             for a in self.agents})
        self.action_space = spaces.Dict(
            {a: spaces.MultiDiscrete([self.nA] * self.num_envs)
             for a in self.agents})

        self._seed = int(seed)
        self._seed_list = None      # per-env seeds from reset(seed=[...])
        self._reset_count = 0
        self._state = None  # device EnvState; set by reset()
        self._stats = EpisodeStats.zero()

        # reset info "p": the ISD is uniform over its entries (reference
        # _generate_isd :146-165), so every lane's sampled entry has the
        # same probability 1/nI.
        n_isd = tables.isd_fields(self.cfg).shape[0]
        self._isd_p = float(np.round(1.0 / n_isd, 2))

    # -- gym.vector surface ------------------------------------------------

    def reset(self, seed=None):
        """Reset ALL instances.  Returns (obs, infos).

        Gym semantics: an explicit ``seed`` reseeds the env (identical
        trajectories thereafter); a bare ``reset()`` continues the seeded
        stream (each call starts fresh, distinct episodes).  ``seed`` may
        be a single int or a per-env sequence of ``num_envs`` ints
        (gym.vector's per-env seed list)."""
        if seed is not None:
            if np.ndim(seed) == 0:
                self._seed = int(seed)
                self._seed_list = None
            else:
                seeds = np.asarray(seed, np.uint32).ravel()
                if seeds.shape[0] != self.num_envs:
                    raise ValueError(
                        f"seed list must have num_envs={self.num_envs} "
                        f"entries, got {seeds.shape[0]}")
                self._seed_list = seeds
            self._reset_count = 0
        if self._seed_list is not None:
            keys = threefry.key(self._seed_list, self.device)
            if self._reset_count:
                keys = threefry.fold_in(keys, self._reset_count)
            self._state = batch.init_from_keys(self.cfg, keys, self.device)
        else:
            key = threefry.key(self._seed, self.device)
            if self._reset_count:
                key = threefry.fold_in(key, self._reset_count)
            self._state = batch.init(self.cfg, key, self.num_envs,
                                     self.device)
        self._reset_count += 1
        self._stats = EpisodeStats.zero()
        obs = batch.observe(self.cfg, self._state).cpu().numpy()
        infos = {"p": np.full(self.num_envs, self._isd_p)}
        return self._keyed(obs), infos

    def step(self, actions):
        """Lockstep transition of the whole batch (numpy in / numpy out)."""
        if self._state is None:
            raise RuntimeError("reset() must be called before step()")
        aa, ab = self._coerce_actions(actions)
        self._state, out = batch.step(self.cfg, self._state, aa, ab)
        # One transfer of the int fields and one of the float ones.
        ints = torch.stack([out.obs, out.final_obs, out.done.to(torch.int32),
                            out.truncated.to(torch.int32)]).cpu().numpy()
        floats = torch.stack([out.reward_a, out.prob]).cpu().numpy()
        obs, final_obs = ints[0], ints[1]
        done, trunc = ints[2].astype(bool), ints[3].astype(bool)
        reward_a, prob = floats[0], floats[1]

        infos: dict = {"p": np.round(prob.astype(np.float64), 2)}
        ended = done | trunc
        if ended.any():
            infos["final_observation"] = np.where(ended, final_obs, 0)
            infos["_final_observation"] = ended
        self._stats = self._stats.merge(chunk_stats(SimpleNamespace(
            done=done, truncated=trunc, reward_a=reward_a)))

        ra = reward_a.astype(np.float64)
        # player_b's reward is the negation (zero-sum, :400-402); this also
        # realizes the single-agent-as-B sign flip (:242-244).
        rewards = {"player_a": ra, "player_b": -ra}
        return (self._keyed(obs),
                {a: rewards[a] for a in self.agents},
                {a: done.copy() for a in self.agents},
                {a: trunc.copy() for a in self.agents},
                infos)

    def close(self):
        self._state = None

    # -- metrics -------------------------------------------------------------

    @property
    def episode_stats(self) -> EpisodeStats:
        """Aggregated episode statistics since the last reset() (the
        reference main()'s episode accounting, soccer_simultaneous_env.py
        :598-613, batched)."""
        return self._stats

    # -- helpers -----------------------------------------------------------

    def _keyed(self, arr: np.ndarray):
        """Multiagent mode returns per-agent dicts (both agents see the same
        full-state index, like the reference's obs dicts :397); single-agent
        mode returns the bare array."""
        if self._frozen is None:
            return {a: arr.copy() for a in self.agents}
        return arr

    def _coerce_actions(self, actions):
        N = self.num_envs

        def valid(arr, who):
            arr = np.asarray(arr, np.int32).reshape(N)
            if ((arr < 0) | (arr >= self.nA)).any():
                bad = arr[(arr < 0) | (arr >= self.nA)][0]
                raise ValueError(
                    f"invalid action {bad} for {who}: actions must be in "
                    f"[0, {self.nA}) (reference action encoding :8-13)")
            return torch.as_tensor(arr, device=self.device)

        if self._frozen is None:
            if not (isinstance(actions, dict)
                    and set(actions) == {"player_a", "player_b"}):
                raise ValueError(
                    "multiagent mode takes {'player_a': [N], "
                    "'player_b': [N]}")
            return (valid(actions["player_a"], "player_a"),
                    valid(actions["player_b"], "player_b"))
        learner = valid(actions, self.agents[0])
        frozen_act = self._policy[batch.observe(self.cfg,
                                                self._state).long()]
        if self._frozen == "player_a":
            return frozen_act, learner
        return learner, frozen_act

    @property
    def device_state(self) -> batch.EnvState:
        """The underlying device EnvState, for staying on the device (e.g.
        handing off to core/batch.rollout)."""
        return self._state


def _policy_array(policy, nS: int) -> np.ndarray:
    """Accept the reference's dict[state->action] or an int array [nS].

    A dict must cover every dense state: the reference raises KeyError for
    uncovered states at table-build time (soccer_simultaneous_env.py:188);
    silently defaulting them to NOOP would corrupt results."""
    if isinstance(policy, dict):
        missing = [s for s in range(nS) if s not in policy]
        if missing:
            raise KeyError(
                f"frozen policy missing {len(missing)} of {nS} states "
                f"(first: {missing[:5]})")
        arr = np.array([int(policy[s]) for s in range(nS)], np.int32)
        return arr
    arr = np.asarray(policy, np.int32)
    if arr.shape != (nS,):
        raise ValueError(f"policy must have shape ({nS},), got {arr.shape}")
    return arr
