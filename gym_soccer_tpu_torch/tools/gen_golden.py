"""Regenerate the golden parity fixtures (tests/golden/reference_golden.json)
by executing the upstream reference under the gym stub ``refstub`` (whose
``gym.spaces`` re-exports the port's spaces): the twin of the JAX
package's tools/gen_golden.py.

The fixtures are behavioural ground truth: trajectories under fixed seeds,
content digests of the transition tables, the reference main()'s
closed-loop evaluations and the first MT19937 uniforms of a few seeds.
``build`` makes them from any env class with the reference's constructor
and planner; ``main`` hands it the reference's own, so that the port is
never checked against fixtures it made itself.

The reference checkout is named by the REFERENCE_PATH environment
variable, as for ``run_reference_tests``; nothing else is searched.  While
it is unset, or names no directory holding the reference, this exits 2.

    REFERENCE_PATH=/path/to/reference \\
        python -m gym_soccer_tpu_torch.tools.gen_golden
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

from .check_parity import GOLDEN, digest_tables as _digests, f64_hex

HERE = Path(__file__).resolve().parent
BOTH = ["player_a", "player_b"]
# (fixture suffix, constructor kwargs, trajectories as (seed, script
# length, script seed)); the single-agent envs' frozen sides are added in
# ``env_fixtures``.
MULTI = [
    ("5x4_slip02_multi", dict(width=5, height=4, slip_prob=0.2),
     [(123, 400, 7), (0, 250, 11)]),
    ("5x4_slip00_multi", dict(width=5, height=4, slip_prob=0.0),
     [(5, 300, 3)]),
    ("7x5_slip03_multi", dict(width=7, height=5, slip_prob=0.3),
     [(42, 300, 13)]),
    ("6x4_slip01_multi", dict(width=6, height=4, slip_prob=0.1),
     [(77, 300, 23)]),
    ("9x6_slip025_multi", dict(width=9, height=6, slip_prob=0.25),
     [(31, 300, 29)]),
]
STREAM_SEEDS = [0, 1, 5, 9, 21, 42, 123]


def digest_tables(env) -> dict:
    """Canonical sha256 digests of P / P_readable / Pmat / Rmat, the ISD's
    bits and the first eight entries of ``state_space``."""
    return {**_digests(env), "state_space_sample": {
        repr(k): v for k, v in list(env.state_space.items())[:8]}}


def run_trajectory(env, seed, action_script, agents) -> dict:
    """Seeded episodic run with a reset where an episode ended; records
    every step's state, observation, reward and probability bits and
    flags."""
    rec = {"seed": seed, "steps": []}
    obs, infos = env.reset(seed=seed)
    rec["reset"] = {
        "state": list(env.state),
        "obs": {a: int(obs[a]) for a in agents},
        "info_p": {a: float(infos[a]["p"]) for a in agents},
    }
    for t, act in enumerate(action_script):
        if env.needs_reset:
            obs, infos = env.reset()
            rec["steps"].append({
                "t": t, "reset": True,
                "state": list(env.state),
                "obs": {a: int(obs[a]) for a in agents},
            })
        action = {k: int(v) for k, v in act.items()}
        obs, rew, dones, truncs, infos = env.step(action)
        rec["steps"].append({
            "t": t,
            "action": action,
            "state": list(env.state),
            "obs": {a: int(obs[a]) for a in agents},
            "reward": {a: f64_hex(rew[a]) for a in agents},
            "done": {a: bool(dones[a]) for a in agents},
            "trunc": {a: bool(truncs[a]) for a in agents},
            "info_p": {a: f64_hex(infos[a]["p"]) for a in agents},
        })
    return rec


def _eval(env, act, agent, reset_seed, n_episodes) -> dict:
    """``n_episodes`` episodes of ``act(obs)`` on one env whose MT19937
    stream continues across resets (reference main(), :569-613): each
    episode's reward and length and a digest of every step's (obs, reward
    float32 bits, done, trunc) of ``agent``."""
    h = hashlib.sha256()
    rewards, lengths = [], []
    seed = reset_seed
    for _ in range(n_episodes):
        obs, _ = env.reset(seed=seed)
        seed = None   # later resets continue the stream (reference :578)
        total, steps, all_done = np.float64(0.0), 0, False
        while not all_done:
            obs, rs, ds, ts, _ = env.step(act(obs))
            total += rs[agent]
            steps += 1
            all_done = any(ds.values()) or any(ts.values())
            h.update(int(obs[agent]).to_bytes(4, "little"))
            h.update(np.float32(rs[agent]).tobytes())
            h.update(b"\x01" if ds[agent] else b"\x00")
            h.update(b"\x01" if ts[agent] else b"\x00")
        rewards.append(total)
        lengths.append(steps)
    return {"episode_rewards": [f64_hex(r) for r in rewards],
            "episode_lengths": lengths,
            "total_steps": int(sum(lengths)),
            "step_stream_digest": h.hexdigest(),
            "avg_reward": float(np.mean(rewards)),
            "avg_steps": float(np.mean(lengths))}


def run_policy_eval(env, policy, reset_seed, n_episodes,
                    agent="player_a") -> dict:
    """The reference main()'s closed-loop evaluation: ``agent`` plays
    ``policy[obs]``."""
    rec = _eval(env, lambda obs: {agent: int(policy[obs[agent]])}, agent,
                reset_seed, n_episodes)
    return {"reset_seed": reset_seed, "n_episodes": n_episodes,
            "policy": [int(policy[s]) for s in range(env.nS)], **rec}


def run_policy_eval_joint(env, policy_a, policy_b, reset_seed,
                          n_episodes) -> dict:
    """Closed loop on a multi-agent env: both players play their
    deterministic policies off the shared observation."""
    rec = _eval(env, lambda obs: {"player_a": int(policy_a[obs["player_a"]]),
                                  "player_b": int(policy_b[obs["player_b"]])},
                "player_a", reset_seed, n_episodes)
    return {"reset_seed": reset_seed, "n_episodes": n_episodes,
            "policy_a": [int(policy_a[s]) for s in range(env.nS)],
            "policy_b": [int(policy_b[s]) for s in range(env.nS)], **rec}


def multiagent_script(n, seed):
    rng = np.random.RandomState(seed)
    return [{"player_a": rng.randint(0, 5), "player_b": rng.randint(0, 5)}
            for _ in range(n)]


def single_script(agent, n, seed):
    rng = np.random.RandomState(seed)
    return [{agent: rng.randint(0, 5)} for _ in range(n)]


def random_policy(n_states, n_actions, seed):
    rng = np.random.RandomState(seed)
    return {s: int(rng.randint(0, n_actions)) for s in range(n_states)}


def env_fixtures(env_cls) -> dict:
    """``tables_*`` and ``traj_*``: the multi-agent boards, then 5x4 slip
    0.2 against a frozen random B and against a frozen random A."""
    out = {}
    for suffix, kwargs, runs in MULTI:
        env = env_cls(**kwargs)
        out[f"tables_{suffix}"] = digest_tables(env)
        for seed, n, script_seed in runs:
            out[f"traj_{suffix}_seed{seed}"] = run_trajectory(
                env, seed, multiagent_script(n, seed=script_seed), BOTH)
    env = env_cls(width=5, height=4, slip_prob=0.2,
                  player_b_policy=random_policy(761, 5, seed=0))
    out["tables_5x4_slip02_singleA"] = digest_tables(env)
    out["traj_5x4_slip02_singleA_seed9"] = run_trajectory(
        env, 9, single_script("player_a", 300, seed=17), ["player_a"])
    env = env_cls(width=5, height=4, slip_prob=0.2,
                  player_a_policy=random_policy(761, 5, seed=1))
    out["tables_5x4_slip02_singleB"] = digest_tables(env)
    out["traj_5x4_slip02_singleB_seed21"] = run_trajectory(
        env, 21, single_script("player_b", 300, seed=19), ["player_b"])
    return out


def best_response(env_cls, value_iteration):
    """The 5x4 slip 0.2 env against a frozen random B and value
    iteration's best response on it (theta 1e-10, gamma 0.99)."""
    env = env_cls(width=5, height=4, slip_prob=0.2,
                  player_b_policy=random_policy(761, 5, seed=0))
    pi, _, _, _ = value_iteration(env, theta=1e-10, discount_factor=0.99)
    return env, pi


def joint_fixture(env_cls, vi_pi) -> dict:
    """``policy_eval_5x4_slip02_joint``: value iteration's A policy
    against a deterministic random B, both off the shared observation,
    200 episodes."""
    env = env_cls(width=5, height=4, slip_prob=0.2)
    return run_policy_eval_joint(env, vi_pi, random_policy(761, 5, seed=4),
                                 reset_seed=55, n_episodes=200)


def stream_fixture() -> dict:
    """``mt19937_streams``: the first 64 uniforms of ``RandomState(seed)``
    for each of ``STREAM_SEEDS``."""
    streams = {}
    for seed in STREAM_SEEDS:
        rs = np.random.RandomState(seed)
        streams[str(seed)] = [f64_hex(rs.random_sample()) for _ in range(64)]
    return streams


def build(env_cls, value_iteration) -> dict:
    """Every fixture, in the committed file's order, from ``env_cls`` and
    ``value_iteration(env, theta, discount_factor)``."""
    out = env_fixtures(env_cls)
    env, pi = best_response(env_cls, value_iteration)
    out["policy_eval_5x4_slip02_vi_vs_randomB"] = run_policy_eval(
        env, pi, reset_seed=101, n_episodes=1000)
    out["policy_eval_5x4_slip02_joint"] = joint_fixture(env_cls, pi)
    out["mt19937_streams"] = stream_fixture()
    return out


def write(out, path=GOLDEN) -> Path:
    """Write fixtures as the committed file is written (json, indent 1)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return path


def reference_root() -> Path | None:
    """The reference checkout under REFERENCE_PATH, or None where the
    variable is unset or names no directory holding ``gym_soccer``."""
    root = os.environ.get("REFERENCE_PATH")
    if not root or not (Path(root) / "gym_soccer").is_dir():
        return None
    return Path(root)


def import_reference(root: Path):
    """Put the gym stub and ``root`` first on the path (the reference's
    ``gym_soccer``, not the port's compat shim of that name)."""
    for p in (str(HERE / "refstub"), str(root)):
        sys.path.insert(0, p)


def main() -> int:
    root = reference_root()
    if root is None:
        print("gen_golden: set REFERENCE_PATH to a checkout of the upstream "
              "reference (a directory holding gym_soccer/); the fixtures "
              "are made only by executing it", file=sys.stderr)
        return 2
    import_reference(root)
    from gym_soccer.envs.soccer_simultaneous_env import SoccerSimultaneousEnv
    from gym_soccer.utils.planners import value_iteration
    path = write(build(SoccerSimultaneousEnv, value_iteration))
    print("wrote", path, path.stat().st_size, "bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
