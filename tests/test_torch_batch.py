"""The port's batched engine (gym_soccer_tpu_torch.core.batch) against the
JAX package's with ``rng="counter"``, from the same state: the JAX state is
carried over by ``interop`` and actions come from numpy.  Tolerance: zero,
for every field including the float32 rewards and transition
probabilities (the counter RNG and every threshold are exact)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import batch as jbatch
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import batch

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B = 1024
BOARDS = [(5, 4, 0.2), (11, 7, 0.2), (6, 5, 0.1)]


def _cfgs(w, h, q):
    return JaxConfig(width=w, height=h, slip_prob=q), \
        EnvConfig(width=w, height=h, slip_prob=q)


def _jax_state(jcfg, seed, batch=B):
    return jax.jit(lambda k: jbatch.init(jcfg, k, batch))(jax.random.key(seed))


def _port_state(jst):
    return interop.env_state_from_numpy(
        [np.asarray(x) for x in jst[:7]],
        np.asarray(jax.random.key_data(jst.key)), "cpu")


def _assert_state_equal(st, jst):
    fields, key = interop.env_state_to_numpy(st)
    for name, a, b in zip(jbatch.EnvState._fields, fields, jst[:7]):
        assert np.array_equal(a, np.asarray(b)), name
    assert np.array_equal(key, np.asarray(jax.random.key_data(jst.key)))


def _assert_out_equal(out, jout):
    for name in jbatch.StepOut._fields:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(jout, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def test_interop_carries_env_state():
    jcfg, _ = _cfgs(5, 4, 0.2)
    jst = _jax_state(jcfg, 3)
    st = _port_state(jst)
    assert st.key.dtype == torch.int64 and tuple(st.key.shape) == (B, 2)
    assert all(f.dtype == torch.int32 for f in st[:7])
    _assert_state_equal(st, jst)


@pytest.mark.parametrize("w,h,q", BOARDS)
def test_step_counter_bit_equal(w, h, q):
    """N steps under numpy-given actions: state and every StepOut field
    bit-equal, through goals, truncations and autoresets."""
    jcfg, cfg = _cfgs(w, h, q)
    jst = _jax_state(jcfg, 11)
    st = _port_state(jst)
    jstep = jax.jit(lambda s, a, b: jbatch.step(jcfg, s, a, b, rng="counter"))
    rng = np.random.default_rng(5)
    n_goal = n_trunc = 0
    for _ in range(120):  # > max_steps: truncations happen too
        aa = rng.integers(0, 5, B).astype(np.int32)
        ab = rng.integers(0, 5, B).astype(np.int32)
        jst, jout = jstep(jst, jnp.asarray(aa), jnp.asarray(ab))
        st, out = batch.step(cfg, st, torch.as_tensor(aa),
                             torch.as_tensor(ab), rng="counter")
        _assert_out_equal(out, jout)
        n_goal += int(out.done.sum())
        n_trunc += int(out.truncated.sum())
    _assert_state_equal(st, jst)
    assert n_goal > 0 and n_trunc > 0


def test_step_without_autoreset_bit_equal():
    jcfg, cfg = _cfgs(5, 4, 0.2)
    jst = _jax_state(jcfg, 4)
    st = _port_state(jst)
    jstep = jax.jit(lambda s, a, b: jbatch.step(jcfg, s, a, b,
                                                autoreset=False,
                                                rng="counter"))
    rng = np.random.default_rng(6)
    for _ in range(30):
        aa = rng.integers(0, 5, B).astype(np.int32)
        ab = rng.integers(0, 5, B).astype(np.int32)
        jst, jout = jstep(jst, jnp.asarray(aa), jnp.asarray(ab))
        st, out = batch.step(cfg, st, torch.as_tensor(aa),
                             torch.as_tensor(ab), autoreset=False,
                             rng="counter")
        _assert_out_equal(out, jout)
    _assert_state_equal(st, jst)


@pytest.mark.parametrize("w,h,q", BOARDS)
def test_init_from_keys_equals_counter_reset(w, h, q):
    """The port's init_from_keys is JAX's _reset_where(rng="counter") of a
    zero state holding the same keys."""
    jcfg, cfg = _cfgs(w, h, q)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(8), jnp.arange(B, dtype=jnp.uint32))
    z = jnp.zeros(B, jnp.int32)
    jst = jbatch.EnvState(z, z, z, z, z, t=z, n=z, key=keys)
    jst = jbatch._reset_where(jcfg, jst, jnp.ones(B, bool), rng="counter")
    st = batch.init_from_keys(cfg, np.asarray(jax.random.key_data(keys)),
                              "cpu", rng="counter")
    _assert_state_equal(st, jst)


def test_reset_where_masked_bit_equal():
    jcfg, cfg = _cfgs(11, 7, 0.2)
    jst = _jax_state(jcfg, 9)
    mask = np.random.default_rng(7).integers(0, 2, B).astype(bool)
    jout = jbatch._reset_where(jcfg, jst, jnp.asarray(mask), rng="counter")
    out = batch._reset_where(cfg, _port_state(jst), torch.as_tensor(mask),
                             rng="counter")
    _assert_state_equal(out, jout)


def test_per_env_uniforms_bit_equal():
    jcfg, _ = _cfgs(5, 4, 0.2)
    jst = _jax_state(jcfg, 1)
    jst = jst._replace(n=jnp.asarray(
        np.random.default_rng(2).integers(0, 2**31 - 1, B, dtype=np.int64)
        .astype(np.int32)))
    st = _port_state(jst)
    for salt in (0, 9):
        ju = jbatch.per_env_uniforms(jst, 4, salt=salt, rng="counter")
        u = batch.per_env_uniforms(st, 4, salt=salt, rng="counter")
        assert u.dtype == torch.float32
        assert np.array_equal(u.numpy(), np.asarray(ju))


@pytest.mark.parametrize("q", [0.2, 0.1, 1 / 3, 0.0])
def test_slip_thresholds_round_like_jax(q):
    """``u < 1.0 - q`` compares against the float32 rounding of 1 - q, as
    JAX's weak-typed scalar does; pinned at and beside the thresholds."""
    jcfg, cfg = _cfgs(5, 4, q)
    edges = [np.float32(1.0 - q), np.float32(1.0 - q * 0.5)]
    u = np.array([e + d for e in edges for d in (-2**-24, 0.0, 2**-24)]
                 + [0.0, 0.5, 1 - 2**-24], np.float32)
    want = np.asarray(jbatch._slip_variant(jcfg, jnp.asarray(u)))
    got = batch._slip_variant(cfg, torch.as_tensor(u)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w,h,q", BOARDS[:2])
def test_random_rollout_stats_bit_equal(w, h, q):
    jcfg, cfg = _cfgs(w, h, q)
    jst = _jax_state(jcfg, 12)
    st = _port_state(jst)
    jst, jacc = jax.jit(lambda s: jbatch.random_rollout_stats(
        jcfg, s, 110, rng="counter"))(jst)
    st, acc = batch.random_rollout_stats(cfg, st, 110, rng="counter")
    _assert_state_equal(st, jst)
    for a, b in zip(acc, jacc):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert a.numpy() == np.asarray(b)


def test_rollout_and_rollout_stats_bit_equal():
    """A numpy action table as the policy: stacked trajectories and the
    stats-only rollout equal the JAX package's."""
    jcfg, cfg = _cfgs(5, 4, 0.2)
    T = 24
    acts = np.random.default_rng(4).integers(0, 5, (T, 2, B)).astype(np.int32)
    jacts = jnp.asarray(acts)
    tacts = torch.as_tensor(acts)
    jpol = lambda obs, i: (jacts[i, 0], jacts[i, 1])  # noqa: E731
    pol = lambda obs, i: (tacts[i, 0], tacts[i, 1])  # noqa: E731
    jst0 = _jax_state(jcfg, 2)

    jst, jtraj = jax.jit(lambda s: jbatch.rollout(
        jcfg, s, jpol, T, rng="counter"))(jst0)
    st, traj = batch.rollout(cfg, _port_state(jst0), pol, T, rng="counter")
    _assert_out_equal(traj, jtraj)
    _assert_state_equal(st, jst)

    jst, jacc = jax.jit(lambda s: jbatch.rollout_stats(
        jcfg, s, jpol, T, rng="counter"))(jst0)
    st, acc = batch.rollout_stats(cfg, _port_state(jst0), pol, T,
                                  rng="counter")
    _assert_state_equal(st, jst)
    assert [a.item() for a in acc] == [np.asarray(b).item() for b in jacc]


def test_observe_matches_jax():
    jcfg, cfg = _cfgs(11, 7, 0.2)
    jst = _jax_state(jcfg, 5)
    assert np.array_equal(batch.observe(cfg, _port_state(jst)).numpy(),
                          np.asarray(jbatch.observe(jcfg, jst)))
