"""Tabular dynamic-programming planners.

The port of gym_soccer_tpu/agents/planners.py.  Reference counterpart:
gym_soccer/utils/planners.py (87 LoC of per-state Python loops).  Here
every sweep is one vectorized contraction over the padded transition
tensors [nS, nA, K]:

    Q[s,a] = sum_k  p[s,a,k] * (r[s,a,k] + gamma * V[ns[s,a,k]] * !done)

which is the same Bellman backup the reference computes entry-by-entry
(planners.py:9-12).  Two implementations share the signature contract:

* numpy/float64 host versions, copied from the JAX package's — match the
  reference's float64 semantics and its convergence thresholds
  (theta=1e-10 workloads);
* ``value_iteration_torch``, the twin of the JAX package's
  ``value_iteration_jax``: the same fixpoint on tensors, where they lie,
  in their dtype (float32 on the card; float64 for tight thetas).

All planners operate on *single-agent* tables (frozen opponent), exactly
like the reference's (int action keys; planners.py:9-10).  The
reference-compatible wrappers accept the env object and read its collapsed
arrays directly — never the Python dict views.
"""
from __future__ import annotations

import numpy as np
import torch


# ----------------------------------------------------------------------
# Array-native core (numpy, float64)
# ----------------------------------------------------------------------

def _env_arrays(env):
    """Pull the collapsed single-agent padded tensors off a facade env."""
    assert not env.multiagent, (
        "Planners require single-agent tables (frozen opponent), like the "
        "reference's (planners.py operates on int action keys)")
    a = env._arr
    return (a["t_prob"], a["t_next_dense"], a["t_reward"], a["t_done"])


def backup_q(prob, ns, rew, done, V, gamma):
    """One synchronous Bellman backup: Q[s,a] (float64)."""
    cont = np.where(done, 0.0, V[ns])
    return np.einsum("sak,sak->sa", prob, rew + gamma * cont, optimize=True)


def value_iteration_arrays(prob, ns, rew, done, theta, gamma):
    """VI on padded arrays; returns (pi, V, Q, sweep_count) like the
    reference's value_iteration (planners.py:4-18), including its
    convergence test max|V - max_a Q| < theta checked BEFORE updating V."""
    nS = prob.shape[0]
    V = np.zeros(nS, dtype=np.float64)
    cc = 0
    while True:
        Q = backup_q(prob, ns, rew, done, V, gamma)
        cc += 1
        newV = Q.max(axis=1)
        if np.max(np.abs(V - newV)) < theta:
            break
        V = newV
    return Q.argmax(axis=1), V, Q, cc


def policy_evaluation_arrays(pi, prob, ns, rew, done, theta, gamma):
    """Iterative policy evaluation (reference planners.py:20-31)."""
    nS = prob.shape[0]
    idx = np.arange(nS)
    p_pi, ns_pi = prob[idx, pi], ns[idx, pi]
    r_pi, d_pi = rew[idx, pi], done[idx, pi]
    prev_V = np.zeros(nS, dtype=np.float64)
    while True:
        cont = np.where(d_pi, 0.0, prev_V[ns_pi])
        V = np.einsum("sk,sk->s", p_pi, r_pi + gamma * cont, optimize=True)
        if np.max(np.abs(prev_V - V)) < theta:
            break
        prev_V = V
    return V


def policy_iteration_arrays(prob, ns, rew, done, theta, gamma, rng=None):
    """PI with random init (reference planners.py:43-53 seeds from the
    GLOBAL numpy RNG; pass `rng` for reproducibility)."""
    nS, nA = prob.shape[:2]
    rng = np.random if rng is None else rng
    pi = rng.choice(nA, nS)
    cc = 0
    while True:
        old_pi = pi.copy()
        V = policy_evaluation_arrays(pi, prob, ns, rew, done, theta, gamma)
        Q = backup_q(prob, ns, rew, done, V, gamma)
        pi = Q.argmax(axis=1)
        cc += 1
        if np.all(old_pi == pi):
            break
    return pi, V, Q, cc


def modified_policy_iteration_arrays(prob, ns, rew, done, k, theta, gamma):
    """MPI (reference planners.py:73-88): greedy step + k-truncated policy
    evaluation, threshold theta*(1-gamma)/(2*gamma)."""
    nS, nA = prob.shape[:2]
    v = np.zeros(nS, dtype=np.float64)
    threshold = (theta * (1 - gamma)) / (2 * gamma)
    counter = 0
    idx = np.arange(nS)
    while True:
        q = backup_q(prob, ns, rew, done, v, gamma)
        greedy_v = q.max(axis=1)
        best = q.argmax(axis=1)
        if np.max(np.abs(v - greedy_v)) <= threshold:
            return best, greedy_v, q, counter
        # k sweeps of evaluation of the greedy policy, init at greedy_v
        p_pi, ns_pi = prob[idx, best], ns[idx, best]
        r_pi, d_pi = rew[idx, best], done[idx, best]
        v = greedy_v
        for _ in range(k):
            cont = np.where(d_pi, 0.0, v[ns_pi])
            nv = np.einsum("sk,sk->s", p_pi, r_pi + gamma * cont,
                           optimize=True)
            delta = np.max(np.abs(nv - v))
            v = nv
            if delta < theta:
                break
        counter += 1


# ----------------------------------------------------------------------
# Reference-signature wrappers (take the env object; planners.py:4,43,73)
# ----------------------------------------------------------------------

def value_iteration(env, theta, discount_factor):
    return value_iteration_arrays(*_env_arrays(env), theta, discount_factor)


def policy_evaluation(pi, env, theta, discount_factor):
    return policy_evaluation_arrays(
        np.asarray(pi), *_env_arrays(env), theta, discount_factor)


def policy_improvement(V, env, discount_factor):
    prob, ns, rew, done = _env_arrays(env)
    Q = backup_q(prob, ns, rew, done, np.asarray(V), discount_factor)
    return Q.argmax(axis=1), Q


def policy_iteration(env, theta, discount_factor):
    return policy_iteration_arrays(*_env_arrays(env), theta, discount_factor)


def modified_policy_iteration(env, k, theta, discount_factor):
    return modified_policy_iteration_arrays(
        *_env_arrays(env), k, theta, discount_factor)


def policy_eval(env, policy, theta, discount_factor, k=10000000, init=None):
    """Matrix-form evaluation of a STOCHASTIC policy [nS, nA] (reference
    planners.py:55-70, which consumes Pmat/Rmat)."""
    prob, ns, rew, done = _env_arrays(env)
    policy = np.asarray(policy, dtype=np.float64)
    nS = prob.shape[0]
    v = np.zeros(nS) if init is None else np.asarray(init, dtype=np.float64)
    cc = 0
    for _ in range(k):
        cont = np.where(done, 0.0, v[ns])
        q = np.einsum("sak,sak->sa", prob, rew + discount_factor * cont,
                      optimize=True)
        value_fc = np.einsum("sa,sa->s", policy, q)
        delta = np.max(np.abs(value_fc - v))
        v = value_fc
        cc += 1
        if delta < theta:
            break
    return v, cc


# ----------------------------------------------------------------------
# On-device planners (torch)
# ----------------------------------------------------------------------

def _backup_q_torch(prob, ns, rew, done, V, gamma):
    """The JAX package's ``_backup_q_jax``: the sum over the last axis."""
    cont = torch.where(done, 0.0, V[ns])
    return torch.sum(prob * (rew + gamma * cont), dim=-1)


def value_iteration_torch(prob, ns, rew, done, theta, gamma,
                          max_sweeps: int = 10_000):
    """VI fixpoint on tensors [nS, nA, K] on one device, where it runs;
    the dtype follows ``prob`` (float32 on the card; float64 for tight
    thetas).  The twin of the JAX package's ``value_iteration_jax``.

    Return contract matches the reference's value_iteration (ref
    planners.py:14-17) and the numpy twin `value_iteration_arrays`:
    (argmax Q, V, Q, sweep count), where V is the PRE-update V the final
    Q was backed up from (the one satisfying max|V - max_a Q| < theta),
    not max_a Q itself — the two differ by at most theta at convergence.
    Convergence is tested before V is updated, one host read of the
    sweep's residual a sweep, so the sweep count is the JAX package's;
    ``theta`` is compared in ``prob``'s dtype, as JAX's weakly typed
    scalar is."""
    dt = prob.dtype
    ns = ns.long()
    thr = torch.tensor(theta, dtype=dt).item()
    V = torch.zeros(prob.shape[0], dtype=dt, device=prob.device)
    prevV = V
    Q = torch.zeros(prob.shape[:2], dtype=dt, device=prob.device)
    cc = 0
    delta = float("inf")
    while delta >= thr and cc < max_sweeps:
        Q = _backup_q_torch(prob, ns, rew, done, V, gamma)
        newV = Q.max(dim=1).values
        delta = torch.max(torch.abs(V - newV)).item()
        prevV, V = V, newV
        cc += 1
    return Q.argmax(dim=1), prevV, Q, cc
