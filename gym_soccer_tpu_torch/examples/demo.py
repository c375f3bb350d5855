"""End-to-end demo, mirroring the reference's main()
(soccer_simultaneous_env.py:499-613): build the 5x4 slip-0.2 env with a
frozen random player B, solve it with VI / PI / MPI (k=1 and k=10^7),
assert all four agree, then play 1000 episodes with the VI policy and
report average reward / steps, with the build and solve timings.  The
port's twin of examples/demo.py (host numpy: the facade and planners).

Run: python -m gym_soccer_tpu_torch.examples.demo
"""
import numpy as np

from ..agents.planners import (
    modified_policy_iteration, policy_iteration, value_iteration)
from ..envs import SoccerSimultaneousEnv
from ..utils.policies import get_random_policy
from ..utils.profiling import phase, phase_report, log_json


def main():
    n_states, n_actions = 761, 5
    player_b_policy = get_random_policy(n_states, n_actions, seed=0)

    with phase("env_build", sync=False):
        env = SoccerSimultaneousEnv(
            width=5, height=4, slip_prob=0.2,
            player_a_policy=None, player_b_policy=player_b_policy)

    theta, gamma = 1e-10, 0.99
    with phase("value_iteration", sync=False):
        vi_pi, vi_V, vi_Q, vi_cc = value_iteration(env, theta, gamma)
    with phase("policy_iteration", sync=False):
        pi_pi, pi_V, pi_Q, pi_cc = policy_iteration(env, theta, gamma)
    with phase("mpi_k1", sync=False):
        m1_pi, m1_V, m1_Q, m1_cc = modified_policy_iteration(
            env, 1, theta, gamma)
    with phase("mpi_kinf", sync=False):
        m2_pi, m2_V, m2_Q, m2_cc = modified_policy_iteration(
            env, 10_000_000, theta, gamma)

    assert np.all(vi_pi == pi_pi) and np.all(vi_pi == m1_pi) \
        and np.all(vi_pi == m2_pi), "planners must agree on the policy"
    assert np.allclose(vi_V, pi_V) and np.allclose(vi_V, m1_V) \
        and np.allclose(vi_V, m2_V), "planners must agree on V"
    assert np.allclose(vi_Q, pi_Q) and np.allclose(vi_Q, m1_Q) \
        and np.allclose(vi_Q, m2_Q), "planners must agree on Q"
    print(f"All planners agree (VI {vi_cc} sweeps, PI {pi_cc} iters, "
          f"MPI {m1_cc}/{m2_cc} iters).")

    n_episodes = 1000
    rewards, steps = [], []
    with phase("eval_1000_episodes", sync=False):
        for i in range(n_episodes):
            obs, _ = env.reset()
            rewards.append(0.0)
            steps.append(0)
            done = False
            while not done:
                if i == n_episodes - 1:
                    env.render()
                action = vi_pi[obs['player_a']]
                obs, rs, ds, ts, _ = env.step({'player_a': int(action)})
                rewards[-1] += rs['player_a']
                done = ds['player_a'] or ts['player_a']
                steps[-1] += 1
        if i == n_episodes - 1:
            env.render()

    print(f"All {n_episodes} episodes finished with average reward "
          f"{np.mean(rewards)} and average steps {np.mean(steps)}.")
    for rec in phase_report():
        log_json(**rec)


if __name__ == "__main__":
    main()
