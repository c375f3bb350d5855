"""Check the port's facade and planners against the golden fixtures
generated from the executed reference (tests/golden/reference_golden.json,
written by the JAX package's tools/gen_golden.py).  The twin of the JAX
package's tools/check_parity.py, on the host:

* ``tables_*``: the facade's ``P``/``P_readable``/``Pmat``/``Rmat``
  digests, counts, goal rows and columns, ISD bits;
* ``traj_*``: every scripted step's state, observation, reward bits,
  flags and info probability bits, resets included;
* ``policy_eval_*``: the reference main()'s closed-loop evaluations
  (value iteration's best response to a frozen random B, 1000 episodes on
  one stream; and the joint 200-episode evaluation), played through the
  facade with the port's ``value_iteration``: the policy, the per-step
  stream digest, the episode lengths and the rewards' bits;
* ``mt19937_streams``: ``core/parity.gen_streams`` (the native generator
  where it builds) against the reference's first 64 uniforms per seed.

    python -m gym_soccer_tpu_torch.tools.check_parity

Prints one line per check and ``FAILURES: n``; exits 1 on any mismatch.
"""
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

from gym_soccer_tpu_torch.agents.planners import value_iteration
from gym_soccer_tpu_torch.core import parity
from gym_soccer_tpu_torch.envs import SoccerSimultaneousEnv
from gym_soccer_tpu_torch.utils.policies import get_random_policy

GOLDEN = (Path(__file__).resolve().parents[2] / "tests" / "golden"
          / "reference_golden.json")
BOTH = ["player_a", "player_b"]


def f64_hex(x):
    return np.float64(x).tobytes().hex()


def envs():
    """(fixture suffix, constructor kwargs, the agents it returns) of each
    facade the fixtures were recorded on."""
    return [
        ("5x4_slip02_multi", dict(width=5, height=4, slip_prob=0.2), BOTH),
        ("5x4_slip00_multi", dict(width=5, height=4, slip_prob=0.0), BOTH),
        ("7x5_slip03_multi", dict(width=7, height=5, slip_prob=0.3), BOTH),
        ("6x4_slip01_multi", dict(width=6, height=4, slip_prob=0.1), BOTH),
        ("9x6_slip025_multi", dict(width=9, height=6, slip_prob=0.25), BOTH),
        ("5x4_slip02_singleA",
         dict(width=5, height=4, slip_prob=0.2,
              player_b_policy=get_random_policy(761, 5, 0)), ["player_a"]),
        ("5x4_slip02_singleB",
         dict(width=5, height=4, slip_prob=0.2,
              player_a_policy=get_random_policy(761, 5, 1)), ["player_b"]),
    ]


class Checker:
    def __init__(self, gold):
        self.gold = gold
        self.failures = 0

    def check(self, name, ok, detail=""):
        if ok:
            print(f"ok   {name}")
        else:
            self.failures += 1
            print(f"FAIL {name}: {detail}")

    def tables(self, name, env):
        got = digest_tables(env)
        want = self.gold[name]
        for k in got:
            self.check(f"{name}.{k}", got[k] == want[k],
                       f"{got[k]!r} != {want[k]!r}")

    def trajectory(self, name, env, agents):
        want = self.gold[name]
        obs, _ = env.reset(seed=want["seed"])
        wr = want["reset"]
        self.check(f"{name}.reset.state", list(env.state) == wr["state"],
                   f"{env.state} != {wr['state']}")
        self.check(f"{name}.reset.obs",
                   {a: int(obs[a]) for a in agents} == wr["obs"], f"{obs}")
        bad = 0
        for rec in want["steps"]:
            if rec.get("reset"):
                env.reset()
                bad += list(env.state) != rec["state"]
                continue
            obs, rew, dones, truncs, infos = env.step(rec["action"])
            ok = (list(env.state) == rec["state"]
                  and {a: int(obs[a]) for a in agents} == rec["obs"]
                  and {a: f64_hex(rew[a]) for a in agents} == rec["reward"]
                  and {a: bool(dones[a]) for a in agents} == rec["done"]
                  and {a: bool(truncs[a]) for a in agents} == rec["trunc"]
                  and {a: f64_hex(infos[a]["p"]) for a in agents}
                  == rec["info_p"])
            bad += not ok
        self.check(f"{name}.steps({len(want['steps'])})", bad == 0,
                   f"{bad} mismatching steps")

    def policy_eval(self, name, env, act):
        """Replay the reference main()'s closed loop through the facade:
        ``act(obs)`` gives the step's action dict."""
        fx = self.gold[name]
        h = hashlib.sha256()
        rewards, lengths = [], []
        seed = fx["reset_seed"]
        for _ in range(fx["n_episodes"]):
            obs, _ = env.reset(seed=seed)
            seed = None   # later resets continue the stream
            total, steps, ended = np.float64(0.0), 0, False
            while not ended:
                obs, rs, ds, ts, _ = env.step(act(obs))
                a = env.return_agent[0]
                total += rs[a]
                steps += 1
                ended = any(ds.values()) or any(ts.values())
                h.update(int(obs[a]).to_bytes(4, "little"))
                h.update(np.float32(rs[a]).tobytes())
                h.update(b"\x01" if ds[a] else b"\x00")
                h.update(b"\x01" if ts[a] else b"\x00")
            rewards.append(f64_hex(total))
            lengths.append(steps)
        self.check(f"{name}.step_stream_digest({sum(lengths)} steps, "
                   f"{fx['n_episodes']} episodes)",
                   h.hexdigest() == fx["step_stream_digest"])
        self.check(f"{name}.episode_lengths",
                   lengths == fx["episode_lengths"])
        self.check(f"{name}.episode_rewards",
                   rewards == fx["episode_rewards"])

    def streams(self):
        want = self.gold["mt19937_streams"]
        seeds = [int(s) for s in want]
        hi, lo = parity.gen_streams(seeds, 64, "cpu")
        bits = (hi << 32) | lo
        got = bits.numpy().view(np.float64)
        for i, s in enumerate(want):
            self.check(f"mt19937_streams[{s}]",
                       [f64_hex(x) for x in got[i]] == want[s])


def digest_tables(env):
    h = hashlib.sha256()
    for s in sorted(env.P.keys()):
        for a in sorted(env.P[s].keys(),
                        key=lambda k: (k,) if isinstance(k, int) else k):
            h.update(repr((s, a)).encode())
            for prob, ns, r, d in env.P[s][a]:
                h.update(np.float64(prob).tobytes())
                h.update(int(ns).to_bytes(4, "little"))
                h.update(np.float64(r).tobytes())
                h.update(b"\x01" if d else b"\x00")
    p_digest = h.hexdigest()

    h = hashlib.sha256()
    for st in sorted(env.P_readable.keys()):
        for a in sorted(env.P_readable[st].keys()):
            h.update(repr((st, a)).encode())
            for prob, ns, r, d in env.P_readable[st][a]:
                h.update(np.float64(prob).tobytes())
                h.update(repr(tuple(ns)).encode())
                h.update(np.float64(r).tobytes())
                h.update(b"\x01" if d else b"\x00")
    pr_digest = h.hexdigest()

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(
            a, dtype=np.float64).tobytes()).hexdigest()

    return {
        "nS": env.nS, "nA": env.nA,
        "n_unreachable": len(env.unreachable_states),
        "n_goal_states": len(env.goal_states),
        "goal_rows": list(env.goal_rows), "goal_cols": list(env.goal_cols),
        "P_digest": p_digest, "P_readable_digest": pr_digest,
        "Pmat_digest": digest(env.Pmat), "Rmat_digest": digest(env.Rmat),
        "Pmat_shape": list(env.Pmat.shape),
        "isd": [[f64_hex(p), list(st)] for p, st in env.isd],
    }


def check_env(c: Checker, suffix: str, kwargs: dict, agents) -> None:
    """The ``tables_<suffix>`` fixture and every ``traj_<suffix>_seed*``
    one, on one facade."""
    env = SoccerSimultaneousEnv(**kwargs)
    c.tables(f"tables_{suffix}", env)
    for name in sorted(k for k in c.gold
                       if k.startswith(f"traj_{suffix}_seed")):
        c.trajectory(name, env, agents)


def check_policy_evals(c: Checker) -> None:
    """Value iteration's best response to the frozen random B (reference
    main(), :553-613), then the joint loop against a deterministic B."""
    env = SoccerSimultaneousEnv(width=5, height=4, slip_prob=0.2,
                                player_b_policy=get_random_policy(761, 5, 0))
    pi, _, _, _ = value_iteration(env, theta=1e-10, discount_factor=0.99)
    name = "policy_eval_5x4_slip02_vi_vs_randomB"
    c.check(f"{name}.policy", [int(a) for a in pi] == c.gold[name]["policy"])
    c.policy_eval(name, env,
                  lambda obs: {"player_a": int(pi[obs["player_a"]])})
    name = "policy_eval_5x4_slip02_joint"
    pol_b = c.gold[name]["policy_b"]
    c.check(f"{name}.policies",
            [int(a) for a in pi] == c.gold[name]["policy_a"]
            and pol_b == list(get_random_policy(761, 5, 4).values()))
    env = SoccerSimultaneousEnv(width=5, height=4, slip_prob=0.2)
    c.policy_eval(name, env, lambda obs: {
        "player_a": int(pi[obs["player_a"]]),
        "player_b": int(pol_b[obs["player_b"]])})


def run(gold) -> int:
    """Every check against the fixtures ``gold``; returns the failures."""
    c = Checker(gold)
    for suffix, kwargs, agents in envs():
        check_env(c, suffix, kwargs, agents)
    check_policy_evals(c)
    c.streams()
    return c.failures


def main() -> int:
    with open(GOLDEN) as f:
        failures = run(json.load(f))
    print("FAILURES:", failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
