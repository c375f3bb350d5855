"""The threefry half of the port's engines against the JAX package's, on
the CPU, all exact (every int field and every float32 bit):

* core/batch: ``init``, ``init_from_keys`` (now resetting with threefry,
  as JAX's does), ``step``, ``rollout``, ``rollout_stats``,
  ``random_rollout_stats`` and ``random_policy_fn`` over 64 steps at B =
  256 on 5x4 at slip 0 and 0.2, on 6x5 and on 11x7;
* core/multigrid: ``init``, ``step`` (with and without autoreset),
  ``reset_where`` and ``rollout`` on a three-board mixture;
* the alternating engine: ``alt_init``, ``alt_step``, ``alt_reset_where``
  and ``alt_policy_rollout``, now a bit twin of JAX's;
* tests/test_env_slip.py's statistical suite re-run against the port's
  engine (its ``inject_and_step`` rebound for this module), with its own
  thresholds, and the port's ``inject_and_step`` equal to JAX's."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_env_slip as jslip
from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import batch as jbatch
from gym_soccer_tpu.core import multigrid as jmg
from gym_soccer_tpu.envs import soccer_alternating_env as jalt
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import batch, multigrid as mg, threefry
from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
# The JAX package's slip suite, run below against the port's engine.
from test_env_slip import (  # noqa: F401
    test_bounce_off_goal_walls, test_bounce_off_horizontal_edges,
    test_collision_through_slip, test_kernel_matches_exact_table_distribution,
    test_no_slip_on_stand, test_scoring_ratio, test_slip_into_goal)

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, T = 256, 64
BOARDS = {"5x4-slip0": (5, 4, 0.0), "5x4-slip0.2": (5, 4, 0.2),
          "6x5": (6, 5, 0.2), "11x7": (11, 7, 0.2)}


def _cfgs(w, h, q):
    return JaxConfig(width=w, height=h, slip_prob=q), \
        EnvConfig(width=w, height=h, slip_prob=q)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _assert_state(st, jst):
    for name, a, b in zip(type(jst)._fields, st, jst):
        if name == "key":
            b = _words(b)
        elif name == "geo":
            continue
        a = a.numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _assert_tree(got, want):
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("board", BOARDS.values(), ids=BOARDS.keys())
def test_init_rollout_and_policy_bit_equal(board):
    jcfg, cfg = _cfgs(*board)
    jst = jax.jit(lambda k: jbatch.init(jcfg, k, B))(jax.random.key(3))
    st = batch.init(cfg, threefry.key(3), B, "cpu")
    _assert_state(st, jst)
    jpol = jbatch.random_policy_fn(jcfg, jax.random.key(1), B)
    pol = batch.random_policy_fn(cfg, threefry.key(1), B)
    jend, jtraj = jax.jit(lambda s: jbatch.rollout(jcfg, s, jpol, T))(jst)
    end, traj = batch.rollout(cfg, st, pol, T)
    _assert_tree(traj, jtraj)
    _assert_state(end, jend)
    assert int(traj.done.sum()) > 0 or board[2] == 0.0
    jend, jacc = jax.jit(lambda s: jbatch.rollout_stats(jcfg, s, jpol, T))(
        jst)
    end, acc = batch.rollout_stats(cfg, st, pol, T)
    _assert_tree(acc, jacc)
    _assert_state(end, jend)


@pytest.mark.parametrize("board", BOARDS.values(), ids=BOARDS.keys())
def test_random_rollout_stats_bit_equal(board):
    jcfg, cfg = _cfgs(*board)
    jst = jax.jit(lambda k: jbatch.init(jcfg, k, B))(jax.random.key(8))
    st = batch.init(cfg, threefry.key(8), B, "cpu")
    jend, jacc = jax.jit(lambda s: jbatch.random_rollout_stats(jcfg, s, T))(
        jst)
    end, acc = batch.random_rollout_stats(cfg, st, T)
    _assert_tree(acc, jacc)
    _assert_state(end, jend)


def test_step_under_numpy_actions_without_autoreset():
    jcfg, cfg = _cfgs(5, 4, 0.2)
    jst = jax.jit(lambda k: jbatch.init(jcfg, k, B))(jax.random.key(4))
    st = batch.init(cfg, threefry.key(4), B, "cpu")
    rng = np.random.default_rng(6)
    jstep = jax.jit(lambda s, a, b: jbatch.step(jcfg, s, a, b,
                                                autoreset=False))
    for _ in range(T):
        aa, ab = (rng.integers(0, 5, B).astype(np.int32) for _ in range(2))
        jst, jout = jstep(jst, jnp.asarray(aa), jnp.asarray(ab))
        st, out = batch.step(cfg, st, torch.as_tensor(aa),
                             torch.as_tensor(ab), autoreset=False)
        _assert_tree(out, jout)
    _assert_state(st, jst)


@pytest.mark.parametrize("board", [(5, 4, 0.2), (11, 7, 0.2)])
def test_init_from_keys_resets_with_threefry(board):
    """The repaired init_from_keys: JAX's batch.init_from_keys on the same
    per-instance keys (a per-env seed list through key)."""
    jcfg, cfg = _cfgs(*board)
    seeds = np.random.default_rng(2).integers(0, 2 ** 32, B,
                                              dtype=np.uint64)
    seeds = seeds.astype(np.uint32)
    jkeys = jax.vmap(jax.random.key)(jnp.asarray(seeds))
    jst = jax.jit(lambda k: jbatch.init_from_keys(jcfg, k))(jkeys)
    _assert_state(batch.init_from_keys(cfg, threefry.key(seeds), "cpu"),
                  jst)
    _assert_state(batch.init_from_keys(cfg, _words(jkeys), "cpu"), jst)


MIX = ((5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3))


def _mix():
    return (tuple(JaxConfig(*c) for c in MIX),
            tuple(EnvConfig(width=c[0], height=c[1], slip_prob=c[2])
                  for c in MIX))


def test_multigrid_engine_bit_equal():
    jcfgs, cfgs = _mix()
    jst = jmg.init(list(jcfgs), jax.random.key(5), B)
    st = mg.init(cfgs, threefry.key(5), B, "cpu")
    _assert_state(st, jst)
    rng = np.random.default_rng(1)
    jstep = jax.jit(lambda s, a, b: jmg.step(s, a, b))
    for _ in range(T):
        aa, ab = (rng.integers(0, 5, B).astype(np.int32) for _ in range(2))
        jst, jout = jstep(jst, jnp.asarray(aa), jnp.asarray(ab))
        st, out = mg.step(st, torch.as_tensor(aa), torch.as_tensor(ab))
        _assert_tree(out, jout)
    _assert_state(st, jst)
    # without autoreset, then the public reset of the ended lanes
    jmid, (_, jg, jt) = jmg.step(jst, jnp.zeros(B, jnp.int32),
                                 jnp.full(B, 3, jnp.int32), autoreset=False)
    mid, (_, g, t) = mg.step(st, torch.zeros(B, dtype=torch.int32),
                             torch.full((B,), 3, dtype=torch.int32),
                             autoreset=False)
    _assert_state(mid, jmid)
    _assert_state(mg.reset_where(mid, g | t), jmg.reset_where(jmid, jg | jt))
    codec, jcodec = mg.build_codec(cfgs), jmg.build_codec(jcfgs)
    assert np.array_equal(mg.global_obs(codec, st).numpy(),
                          np.asarray(jmg.global_obs(jcodec, jst)))


def test_multigrid_rollout_with_a_state_policy():
    jcfgs, cfgs = _mix()
    jst = jmg.init(list(jcfgs), jax.random.key(7), B)
    st = mg.init(cfgs, threefry.key(7), B, "cpu")

    def jpol(s, i):
        u = jmg.uniforms(s, 2, salt=3)
        return ((u[:, 0] * 5).astype(jnp.int32),
                (u[:, 1] * 5).astype(jnp.int32))

    def pol(s, i):
        u = mg.uniforms(s, 2, salt=3)
        return (u[:, 0] * 5).to(torch.int32), (u[:, 1] * 5).to(torch.int32)

    jend, jout = jax.jit(lambda s: jmg.rollout(s, jpol, 40))(jst)
    end, out = mg.rollout(st, pol, 40)
    _assert_tree(out, jout)
    _assert_state(end, jend)


def test_alternating_engine_bit_equal():
    jcfg, cfg = _cfgs(5, 4, 0.2)
    jst = jalt.alt_init(jcfg, jax.random.key(2), B, first_mover=1)
    st = alt.alt_init(cfg, threefry.key(2), B, first_mover=1, device="cpu")
    _assert_state(st, jst)
    rng = np.random.default_rng(3)
    jstep = jax.jit(lambda s, a: jalt.alt_step(jcfg, s, a))
    for _ in range(T):
        a = rng.integers(0, 5, B).astype(np.int32)
        jst, jout = jstep(jst, jnp.asarray(a))
        st, out = alt.alt_step(cfg, st, torch.as_tensor(a))
        _assert_tree(out, jout)
    _assert_state(st, jst)
    mask = rng.integers(0, 2, B).astype(bool)
    _assert_state(alt.alt_reset_where(cfg, st, torch.as_tensor(mask)),
                  jalt.alt_reset_where(jcfg, jst, jnp.asarray(mask)))


@pytest.mark.parametrize("first_mover,seed", [(0, 6), (1, 3)])
def test_alt_policy_rollout_is_a_bit_twin(first_mover, seed):
    """(wins, losses, truncations) equal JAX's on the same seed."""
    jcfg, cfg = _cfgs(5, 4, 0.2)
    tb = alt.build_alt_tables(cfg)
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    pi = alt.alt_value_iteration(tb, frozen_b=randpol)[0]
    for pa, pb in ((pi, randpol), (randpol, randpol)):
        got = alt.alt_policy_rollout(cfg, tb.raw_to_dense, pa, pb,
                                     batch=128, steps=150, seed=seed,
                                     first_mover=first_mover, device="cpu")
        want = jalt.alt_policy_rollout(jcfg, tb.raw_to_dense, pa, pb,
                                       batch=128, steps=150, seed=seed,
                                       first_mover=first_mover)
        assert got == want and sum(got) > 0


# ---- tests/test_env_slip.py against the port ---------------------------

def inject_and_step(state_tuple, aa, ab, seed=0, cfg=jslip.CFG, n=jslip.N):
    """The slip suite's helper on the port's engine: every lane set to
    ``state_tuple``, one step without autoreset; numpy fields and
    StepOut."""
    pcfg = EnvConfig(width=cfg.width, height=cfg.height,
                     slip_prob=cfg.slip_prob, max_steps=cfg.max_steps)
    st = batch.init(pcfg, threefry.key(seed), n, "cpu")
    full = lambda v: torch.full((n,), v, dtype=torch.int32)  # noqa: E731
    st = st._replace(rows_a=full(state_tuple[0]), cols_a=full(state_tuple[1]),
                     rows_b=full(state_tuple[2]), cols_b=full(state_tuple[3]),
                     poss=full(state_tuple[4]), t=full(0))
    new, out = batch.step(pcfg, st, full(aa), full(ab), autoreset=False)
    as_np = lambda tup: type(tup)(*(x.numpy() for x in tup))  # noqa: E731
    return as_np(new._replace(key=torch.zeros(0))), as_np(out)


@pytest.fixture(scope="module", autouse=True)
def _the_ports_engine():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jslip, "inject_and_step", inject_and_step)
        yield


def test_the_slip_suite_runs_against_the_port():
    assert jslip.inject_and_step is inject_and_step


def test_inject_and_step_equals_jax():
    """The rebound helper is the JAX helper's twin, bit for bit."""
    state = (2, 3, 1, 2, 1)
    jnew, jout = _jax_inject_and_step(state, 4, 3, n=4096)
    new, out = inject_and_step(state, 4, 3, n=4096)
    for f in ("rows_a", "cols_a", "rows_b", "cols_b", "poss", "t", "n"):
        assert np.array_equal(getattr(new, f), getattr(jnew, f)), f
    for f in jout._fields:
        assert np.array_equal(getattr(out, f), getattr(jout, f)), f


_jax_inject_and_step = jslip.inject_and_step
