"""The port's alternating-turn game (gym_soccer_tpu_torch.envs, K4's plain
version in ops/step_kernel) on the CPU, against the JAX package's
envs/soccer_alternating_env and ``pallas_alt_rollout(interpret=True)``.

Tolerances:

* tables, the numpy value iteration, the facade, ``alt_transition_core``
  and the rollout: exact (integer or the same float64 numpy arithmetic);
* ``alt_value_iteration_torch`` in float64: V and the chosen actions' Q
  within 1e-6 of JAX's ``alt_value_iteration_jax`` (x64) and of the numpy
  sweep at theta 1e-8 (sums may be taken in another order);
* the win-rate gates: the JAX package's own thresholds.  The port's
  ``alt_policy_rollout`` steps the threefry ``alt_step`` as JAX's does
  (tests/test_torch_batch_threefry.py holds it bit-equal to JAX's).

K4 is held against ``alt_rollout_plain`` on the card by chip_smoke.py and
tests/test_torch_cuda.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.agents import learners as jlearners
from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.envs import soccer_alternating_env as jalt
from gym_soccer_tpu.ops import step_kernel as jsk
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.agents import learners
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core.tables import build_isd
from gym_soccer_tpu_torch.envs import SoccerAlternatingEnv
from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
from gym_soccer_tpu_torch.ops import step_kernel as sk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TABLE_FIELDS = ("raw_to_dense", "dense_to_raw", "fields", "turn", "t_prob",
                "t_next_dense", "t_reward", "t_done")


def _cfgs(board, slip=0.2):
    return JaxConfig(*board, slip), EnvConfig(*board, slip)


def _assert_planes_equal(fields, jfields):
    for a, b in zip(interop.planes_to_tiles(fields), jfields):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("board,slip", [((5, 4), 0.0), ((5, 4), 0.2),
                                        ((6, 5), 0.2)])
def test_build_alt_tables_byte_equal(board, slip):
    jcfg, cfg = _cfgs(board, slip)
    tb, jtb = alt.build_alt_tables(cfg), jalt.build_alt_tables(jcfg)
    assert tb.nS == jtb.nS
    for name in TABLE_FIELDS:
        a, b = getattr(tb, name), getattr(jtb, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("frozen", [None, "b"])
@pytest.mark.parametrize("board", [(5, 4), (6, 5)])
def test_alt_value_iteration_equal(board, frozen):
    jcfg, cfg = _cfgs(board)
    tb, jtb = alt.build_alt_tables(cfg), jalt.build_alt_tables(jcfg)
    kw = {}
    if frozen:
        kw["frozen_b"] = np.random.RandomState(0).randint(
            0, 5, tb.nS).astype(np.int32)
    got = alt.alt_value_iteration(tb, **kw)
    want = jalt.alt_value_iteration(jtb, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3]


def test_alt_value_iteration_torch_matches_jax_and_numpy():
    """The torch sweep in float64 against JAX's jitted sweep (x64) and the
    numpy sweep, as tests/test_env_alternating.py's
    test_alt_vi_jax_matches_numpy holds JAX's."""
    tb = alt.build_alt_tables(EnvConfig(5, 4, 0.2))
    pi, V, Q, cc = alt.alt_value_iteration(tb, theta=1e-8)
    with jax.enable_x64(True):
        pj, Vj, Qj, ccj = jalt.alt_value_iteration_jax_jit(
            jnp.asarray(tb.t_prob), jnp.asarray(tb.t_next_dense),
            jnp.asarray(tb.t_reward), jnp.asarray(tb.t_done),
            jnp.asarray(tb.turn), theta=1e-8)
        pj, Vj, Qj = (np.asarray(x) for x in (pj, Vj, Qj))
    pt, Vt, Qt, cct = alt.alt_value_iteration_torch(
        tb.t_prob, tb.t_next_dense, tb.t_reward, tb.t_done, tb.turn,
        theta=1e-8, device="cpu")
    assert Vt.dtype == Qt.dtype == torch.float64 and pt.dtype == torch.int32
    assert cct == int(ccj)
    idx = np.arange(tb.nS)
    for v_ref, q_ref in ((Vj, Qj[idx, pj]), (V, Q[idx, pi])):
        np.testing.assert_allclose(Vt.numpy(), v_ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(Qt.numpy()[idx, pt.numpy()], q_ref,
                                   rtol=0, atol=1e-6)
    # float32 tables give a float32 sweep; max_sweeps stops it
    p32, V32, Q32, c32 = alt.alt_value_iteration_torch(
        torch.tensor(tb.t_prob, dtype=torch.float32), tb.t_next_dense,
        torch.tensor(tb.t_reward, dtype=torch.float32), tb.t_done, tb.turn,
        max_sweeps=7, device="cpu")
    assert V32.dtype == torch.float32 and c32 == 7


def test_facade_steps_like_jax():
    """Same seed, same actions (500 steps over several resets, slip 0.2):
    identical observations, rewards, flags and states."""
    kw = dict(width=5, height=4, slip_prob=0.2, seed=5)
    env, jenv = SoccerAlternatingEnv(**kw), jalt.SoccerAlternatingEnv(**kw)
    actions = np.random.RandomState(1).randint(0, 5, 500)
    assert env.reset() == jenv.reset()
    resets = 0
    for a in actions:
        got, want = env.step(int(a)), jenv.step(int(a))
        assert got == want and env.state == jenv.state
        assert env.current_player == jenv.current_player
        if env.needs_reset:
            resets += 1
            assert env.reset() == jenv.reset() and env.state == jenv.state
    assert resets >= 3
    assert env.reset(seed=9) == jenv.reset(seed=9)
    assert env.P == jenv.P and env.state_space == jenv.state_space
    assert env.nS == jenv.nS
    for space, jspace in ((env.observation_space, jenv.observation_space),
                          (env.action_space, jenv.action_space)):
        assert repr(space) == repr(jspace)
        assert type(space["player_a"]).__name__ == \
            type(jspace["player_a"]).__name__


def _valid_fields(tb, n, rng):
    """n random reachable alternating states' fields (dense 0 excluded)."""
    f = tb.fields[rng.randint(1, tb.nS, n)]
    return [f[:, k].astype(np.int32) for k in range(6)]


@pytest.mark.parametrize("board", [(5, 4), (6, 5)])
def test_alt_transition_core_equals_jax(board):
    jcfg, cfg = _cfgs(board)
    rng = np.random.RandomState(board[0])
    fields = _valid_fields(alt.build_alt_tables(cfg), 4096, rng)
    a = rng.randint(0, 5, 4096).astype(np.int32)
    bits1 = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64)
    q_int = int(round(0.2 * 65536))
    want = jsk.alt_transition_core(
        *(jnp.asarray(f) for f in fields), jnp.asarray(a),
        jnp.asarray(bits1.astype(np.uint32)), jcfg, q_int)
    got = sk.alt_transition_core(
        *(torch.tensor(f) for f in fields), torch.tensor(a),
        torch.tensor(bits1.astype(np.int64)), cfg, q_int)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[5].sum()) > 0   # some goals among them


@pytest.mark.parametrize("board", [(5, 4), (11, 7)])
def test_alt_rollout_plain_equals_pallas(board):
    """1024 lanes x 32 ticks: fields and stats bit-equal to
    ``pallas_alt_rollout(interpret=True)``; a run split by step_offset
    equals one run."""
    jcfg, cfg = _cfgs(board)
    jf, js = jsk.pallas_alt_rollout(jcfg, 7, 1024, 32, interpret=True)
    f, s = sk.alt_rollout(cfg, 7, 1024, 32, "cpu")
    assert len(f) == 7 and all(x.dtype == torch.int32 for x in f)
    _assert_planes_equal(f, jf)
    assert [int(x) for x in s] == [int(x) for x in js]
    assert int(s[1]) > 0
    fa, sa = sk.alt_rollout(cfg, 7, 1024, 12, "cpu")
    fb, sb = sk.alt_rollout_plain(cfg, 7, 1024, 20, "cpu", init_fields=fa,
                                  step_offset=12)
    assert all(torch.equal(a, b) for a, b in zip(fb, f))
    assert [int(x + y) for x, y in zip(sa, sb)] == [int(x) for x in s]
    assert set(f[5].unique().tolist()) <= {0, 1}


def test_alt_rollout_checks_its_arguments():
    cfg = EnvConfig(5, 4, 0.2)
    with pytest.raises(ValueError, match="multiple of 1024"):
        sk.alt_rollout(cfg, 0, 1000, 4, "cpu")
    six = sk.fused_rollout(cfg, 0, 1024, 1, "cpu")[0]
    with pytest.raises(ValueError, match="7 tensors"):
        sk.alt_rollout(cfg, 0, 1024, 4, "cpu", init_fields=six)
    seven = sk.init_alt_fields(cfg, 1024, "cpu")
    with pytest.raises(ValueError, match="int32"):
        sk.alt_rollout(cfg, 0, 1024, 4, "cpu",
                       init_fields=[x.long() for x in seven])


def test_altq_greedy_policy_equals_jax():
    """argmax at A-to-move states, argmin at B-to-move states, the lowest
    index on a tie (q rounded to quarters, so ties are common)."""
    cfg, jcfg = EnvConfig(5, 4, 0.2), JaxConfig(5, 4, 0.2)
    nS = alt.build_alt_tables(cfg).nS
    q = np.round(np.random.RandomState(3).uniform(-1, 1, (nS, 5)) * 4) / 4
    q = q.astype(np.float32)
    got = learners.altq_greedy_policy(cfg, torch.tensor(q))
    want = np.asarray(jlearners.altq_greedy_policy(jcfg, jnp.asarray(q)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_alt_best_response_beats_random_opponent():
    """The JAX package's win-rate contract on the port's rollout: the VI
    best response to a frozen random policy never loses and wins over 95 %
    of episodes (256 lanes x 400 ticks, slip 0.2)."""
    cfg = EnvConfig(5, 4, 0.2)
    tb = alt.build_alt_tables(cfg)
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    pi, V, Q, cc = alt.alt_value_iteration(tb, frozen_b=randpol)
    w, l, tr = alt.alt_policy_rollout(cfg, tb.raw_to_dense, pi, randpol,
                                      batch=256, steps=400, seed=3,
                                      device="cpu")
    assert l == 0
    assert w / (w + l + tr) > 0.95


def test_alt_minimax_vi_slip0_is_a_draw():
    """At slip 0 the minimax values of the initial states are 0, and
    minimax self-play scores no goal: every episode truncates."""
    cfg = EnvConfig(5, 4, 0.0)
    tb = alt.build_alt_tables(cfg)
    pi, V, Q, cc = alt.alt_value_iteration(tb)
    for r in build_isd(cfg)[1]:
        assert abs(V[tb.raw_to_dense[int(r) * 2]]) < 1e-9
    w, l, tr = alt.alt_policy_rollout(cfg, tb.raw_to_dense, pi, pi,
                                      batch=128, steps=300, seed=1,
                                      device="cpu")
    assert w == 0 and l == 0 and tr > 0
