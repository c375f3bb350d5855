"""The port's HBM-table learners (agents/learners: IQL, minimax-Q, their
mixed-geometry forms and turn-based Q) against the JAX package's on the
CPU.  Each starts from the JAX learner's own initial state, carried across
by interop (``learner_state_from_numpy``), and runs 32 steps:

* the env state (hence every observation and action) equal after every
  step, exactly;
* Q, V, pi and the visit counts within ``1e-6 * (1 + |x|)``: the tables
  are float32, and the JAX package's ``0.5 ** x`` and ``x ** -pow``
  schedules are XLA's own float32 pow, which differs from the host's in
  the last bit (without schedules the tables are bit-equal);
* frozen sides untouched; minimax-Q re-solves (``solve_matrix_games``)
  at step 15 and 31 with ``resolve_every=16``;
* the mean |TD| per step within the same tolerance (a float32 mean).
Also the learning checks' small relatives and the unported ``psum_axis``.
"""
import os

import jax
import numpy as np
import pytest
import torch

from gym_soccer_tpu.agents import learners as jl
from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.agents import learners
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import multigrid, threefry
from gym_soccer_tpu_torch.utils.policies import get_random_policy_array

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, STEPS = 256, 32
CFG, JCFG = EnvConfig(width=5, height=4, slip_prob=0.2), JaxConfig(5, 4, 0.2)
MIX = ((5, 4, 0.2), (6, 5, 0.2))
TOL = 1e-6


def _np(x):
    return np.asarray(jax.random.key_data(x)) if jax.dtypes.issubdtype(
        x.dtype, jax.dtypes.prng_key) else np.asarray(x)


def _env(jenv, kind, cfgs=None):
    if kind == "alt":
        return interop.alt_env_state_from_numpy(
            [_np(f) for f in jenv[:8]], _np(jenv.key), "cpu")
    if kind == "mg":
        return interop.multigrid_state_from_numpy(
            cfgs, [_np(f) for f in jenv[:7]], _np(jenv.key), "cpu")
    return interop.env_state_from_numpy([_np(f) for f in jenv[:7]],
                                        _np(jenv.key), "cpu")


def _carry(cls, jstate, kind, cfgs=None):
    arrays = {f: _np(getattr(jstate, f)) for f in cls._fields if f != "env"}
    return interop.learner_state_from_numpy(
        cls, _env(jstate.env, kind, cfgs), "cpu", **arrays)


def _assert_env(env, jenv):
    for i, name in enumerate(type(jenv)._fields):
        if name in ("key", "geo"):
            continue
        assert np.array_equal(env[i].numpy(), np.asarray(jenv[i])), name


def _close(a, b, name):
    a, b = a.numpy().astype(np.float64), np.asarray(b).astype(np.float64)
    assert a.shape == b.shape, name
    err = np.abs(a - b)
    assert (err <= TOL * (1 + np.abs(b))).all(), (name, err.max())


def _run(step, jstep, state, jstate, fields):
    tds, jtds = [], []
    for _ in range(STEPS):
        state, td = step(state)
        jstate, jtd = jstep(jstate)
        _assert_env(state.env, jstate.env)
        tds.append(float(td))
        jtds.append(float(jtd))
    for f in fields:
        _close(getattr(state, f), getattr(jstate, f), f)
    assert int(state.step) == int(jstate.step) == STEPS
    _close(torch.tensor(tds), np.asarray(jtds), "td")
    return state, jstate


@pytest.mark.parametrize("frozen", [None, "a", "b"])
def test_iql_equals_jax(frozen):
    jcfg = jl.IQLConfig(lr=0.5, eps=0.25)
    pcfg = learners.IQLConfig(*jcfg)
    pol = get_random_policy_array(761, 5, seed=42)
    kw = {} if frozen is None else {f"frozen_{frozen}": pol}
    jst = jax.jit(lambda k: jl.iql_init(JCFG, k, B))(jax.random.key(0))
    st = _carry(learners.IQLState, jst, "batch")
    jstep = jax.jit(lambda s: jl.iql_step(JCFG, jcfg, s, **kw))
    st, jst = _run(lambda s: learners.iql_step(CFG, pcfg, s, **kw), jstep,
                   st, jst, ("q_a", "q_b"))
    if frozen is not None:
        assert float(getattr(st, f"q_{frozen}").abs().max()) == 0.0
    assert float(st.q_a.abs().max()) > 0 or frozen == "a"


def test_iql_init_equals_jax_and_train_stacks_td():
    jst = jax.jit(lambda k: jl.iql_init(JCFG, k, 64))(jax.random.key(5))
    st = learners.iql_init(CFG, threefry.key(5), 64, "cpu")
    _assert_env(st.env, jst.env)
    assert st.q_a.shape == (761, 5) and int(st.step) == 0
    st2, td = learners.iql_train(CFG, learners.IQLConfig(), st, 5)
    assert td.shape == (5,) and int(st2.step) == 5


MINIMAX = {
    "constant": dict(lr=0.2, resolve_every=16),
    "schedules": dict(lr=0.3, eps=0.3, resolve_every=16, lr_halflife=40,
                      eps_halflife=24, eps_min=0.05),
    "count-lr": dict(lr=0.5, resolve_every=16, count_lr_tau=3.0,
                     solver_iters=50),
}


@pytest.mark.parametrize("kw", MINIMAX.values(), ids=MINIMAX.keys())
def test_minimax_equals_jax(kw):
    jcfg = jl.MinimaxQConfig(**kw)
    pcfg = learners.MinimaxQConfig(**kw)
    jst = jax.jit(lambda k: jl.minimax_init(JCFG, k, B))(jax.random.key(1))
    st = _carry(learners.MinimaxQState, jst, "batch")
    jstep = jax.jit(lambda s: jl.minimax_step(JCFG, jcfg, s))
    st, jst = _run(lambda s: learners.minimax_step(CFG, pcfg, s), jstep,
                   st, jst, ("q", "v", "pi_a", "pi_b", "n"))
    assert float(st.v.abs().max()) > 0, "no re-solve ran"


def test_minimax_train_from_a_later_step():
    """The host step count starts from state.step: a run resumed at step
    10 re-solves at JAX's steps."""
    kw = MINIMAX["schedules"]
    jcfg, pcfg = jl.MinimaxQConfig(**kw), learners.MinimaxQConfig(**kw)
    jst = jax.jit(lambda k: jl.minimax_init(JCFG, k, B))(jax.random.key(2))
    jst, _ = jax.jit(lambda s: jl.minimax_train(JCFG, jcfg, s, 10))(jst)
    st = _carry(learners.MinimaxQState, jst, "batch")
    jend, jtd = jax.jit(lambda s: jl.minimax_train(JCFG, jcfg, s, 22))(jst)
    end, td = learners.minimax_train(CFG, pcfg, st, 22)
    _assert_env(end.env, jend.env)
    for f in ("q", "v", "pi_a", "pi_b", "n"):
        _close(getattr(end, f), getattr(jend, f), f)
    _close(td, jtd, "td")


def _mix():
    return (tuple(JaxConfig(*c) for c in MIX),
            tuple(EnvConfig(width=c[0], height=c[1], slip_prob=c[2])
                  for c in MIX))


def test_multigrid_iql_equals_jax():
    jcfgs, cfgs = _mix()
    lc = jl.IQLConfig(lr=0.4, eps=0.3)
    jst = jl.multigrid_iql_init(jcfgs, jax.random.key(3), B)
    st = _carry(learners.IQLState, jst, "mg", cfgs)
    jend, jtd = jax.jit(lambda s: jl.multigrid_iql_train(jcfgs, lc, s,
                                                         STEPS))(jst)
    end, td = learners.multigrid_iql_train(cfgs, learners.IQLConfig(*lc),
                                           st, STEPS)
    _assert_env(end.env, jend.env)
    for f in ("q_a", "q_b"):
        _close(getattr(end, f), getattr(jend, f), f)
    _close(td, jtd, "td")
    ours = learners.multigrid_iql_init(cfgs, threefry.key(3), B, "cpu")
    _assert_env(ours.env, jst.env)


def test_multigrid_minimax_equals_jax():
    jcfgs, cfgs = _mix()
    kw = dict(lr=0.3, resolve_every=16, solver_iters=100)
    jst = jl.multigrid_minimax_init(jcfgs, jax.random.key(4), B)
    st = _carry(learners.MinimaxQState, jst, "mg", cfgs)
    jend, jtd = jax.jit(lambda s: jl.multigrid_minimax_train(
        jcfgs, jl.MinimaxQConfig(**kw), s, STEPS))(jst)
    end, td = learners.multigrid_minimax_train(
        cfgs, learners.MinimaxQConfig(**kw), st, STEPS)
    _assert_env(end.env, jend.env)
    for f in ("q", "v", "pi_a", "pi_b", "n"):
        _close(getattr(end, f), getattr(jend, f), f)
    _close(td, jtd, "td")
    ours = learners.multigrid_minimax_init(cfgs, threefry.key(4), B, "cpu")
    _assert_env(ours.env, jst.env)


@pytest.mark.parametrize("frozen", [None, "a", "b"])
def test_altq_equals_jax(frozen):
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    tb = alt.build_alt_tables(CFG)
    pol = np.random.RandomState(7).randint(0, 5, tb.nS).astype(np.int32)
    kw = {} if frozen is None else {f"frozen_{frozen}": pol}
    lc = jl.AltQConfig(lr=0.25, eps=0.3)
    jst = jax.jit(lambda k: jl.altq_init(JCFG, k, B))(jax.random.key(2))
    st = _carry(learners.AltQState, jst, "alt")
    jstep = jax.jit(lambda s: jl.altq_step(JCFG, lc, s, **kw))
    _run(lambda s: learners.altq_step(CFG, learners.AltQConfig(*lc), s,
                                      **kw), jstep, st, jst, ("q",))
    ours = learners.altq_init(CFG, threefry.key(2), B, "cpu")
    _assert_env(ours.env, jst.env)


def test_psum_axis_waits_for_the_mesh_port(monkeypatch):
    """The mesh is ported: ``psum_axis`` takes a parallel/mesh ``Mesh``; at
    one rank it equals no mesh bit for bit, and a gloo mesh's collectives
    on the card are refused where a CUDA graph would capture them: the
    ``*_train`` replays hand their mesh to ``dispatch.run``'s check, and
    fewer steps than a replay run as they are."""
    from gym_soccer_tpu_torch.ops import dispatch
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    one = pmesh.env_mesh(device="cpu")
    st = learners.iql_init(CFG, threefry.key(0), 8, "cpu")
    a = learners.iql_train(CFG, learners.IQLConfig(), st, 3)
    b = learners.iql_train(CFG, learners.IQLConfig(), st, 3, psum_axis=one)
    assert torch.equal(a[0].q_a, b[0].q_a) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="gloo"):
        dispatch.check_capture(
            pmesh.Mesh(0, 1, torch.device("cuda", 0), "gloo"))
    seen, check = [], dispatch.check_capture
    monkeypatch.setattr(dispatch, "check_capture",
                        lambda m: (seen.append(m), check(m)))
    lc = learners.MinimaxQConfig(resolve_every=2)
    mst = learners.minimax_init(CFG, threefry.key(0), 8, "cpu")
    learners.minimax_train(CFG, lc, mst, 12, psum_axis=one)
    assert seen == []   # 6 periods: fewer than a replay's 32
    learners.iql_train(CFG, learners.IQLConfig(), st,
                       learners.GROUP_STEPS, psum_axis=one)
    assert seen == [one]


def test_initialisers_default_to_cuda():
    import inspect
    for fn in (learners.iql_init, learners.minimax_init, learners.altq_init,
               learners.multigrid_iql_init, learners.multigrid_minimax_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _same(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(learners._tensors(a), learners._tensors(b)))


def _loop(step, state, n):
    """``n`` single steps: (state, every step's |TD|)."""
    tds = []
    for _ in range(n):
        state, td = step(state)
        tds.append(td.reshape(1))
    return state, torch.cat(tds)


@pytest.mark.parametrize("period", [4, 16])
def test_grouped_mode_equals_the_eager_loop(period):
    """The ``*_train`` functions run their steps as groups of step bodies
    (on the CPU one after another; on the card as CUDA-graph replays):
    every leaf and every step's |TD| bit-equal to a loop of single
    ``*_step`` calls, across minimax-Q's unaligned start, whole periods of
    ``resolve_every`` = ``period``, remainder and per-step schedules, and
    the input untouched."""
    lcfg = learners.IQLConfig()
    st = learners.iql_init(CFG, threefry.key(0), 64, "cpu")
    before = [t.clone() for t in learners._tensors(st)]
    a, ta = _loop(lambda s: learners.iql_step(CFG, lcfg, s), st, 37)
    b, tb = learners.iql_train(CFG, lcfg, st, 37)
    assert _same(a, b) and torch.equal(ta, tb) and tb.shape == (37,)
    assert all(torch.equal(x, y) for x, y in
               zip(before, learners._tensors(st)))
    kw = dict(lr=0.3, resolve_every=period, lr_halflife=20, eps_halflife=13,
              eps_min=0.05, count_lr_tau=3.0, solver_iters=30)
    mc = learners.MinimaxQConfig(**kw)
    mm = learners.minimax_init(CFG, threefry.key(1), 64, "cpu")
    mm, _ = learners.minimax_train(CFG, mc, mm, 5)
    a, ta = _loop(lambda s: learners.minimax_step(CFG, mc, s), mm, 45)
    b, tb = learners.minimax_train(CFG, mc, mm, 45)
    assert _same(a, b) and torch.equal(ta, tb) and int(b.step) == 50
    ac, fb = learners.AltQConfig(), np.zeros(1521, np.int32)
    al = learners.altq_init(CFG, threefry.key(2), 64, "cpu")
    a, ta = _loop(lambda s: learners.altq_step(CFG, ac, s, frozen_b=fb),
                  al, 21)
    b, tb = learners.altq_train(CFG, ac, al, 21, frozen_b=fb)
    assert _same(a, b) and torch.equal(ta, tb)
    jcfgs, cfgs = _mix()
    eng = learners._multigrid_engine(multigrid.build_codec(cfgs))
    ms = learners.multigrid_iql_init(cfgs, threefry.key(3), 64, "cpu")
    free = learners._policy(None, torch.device("cpu"))
    a, _ = _loop(lambda s: learners._iql_step_engine(eng, lcfg, s, free,
                                                     free), ms, 9)
    b, _ = learners.multigrid_iql_train(cfgs, lcfg, ms, 9)
    assert _same(a, b) and b.env.geo.max_steps == 100


@pytest.mark.parametrize("resolve_every,periods", [(16, 4), (48, 2),
                                                   (100, 1)])
def test_grouped_mode_needs_a_multiple_of_the_resolve_cadence(
        monkeypatch, resolve_every, periods):
    """A replay holds whole re-solve periods: GROUP_STEPS rounded up to a
    multiple of ``resolve_every``; IQL, with no period, GROUP_STEPS
    steps.  The steps before the first re-solve boundary and after the
    last whole period run on their own."""
    seen, run = [], learners.dispatch.run
    monkeypatch.setattr(learners.dispatch, "run", lambda body, carry, n, g,
                        **kw: seen.append((n, g)) or run(body, carry, n, g,
                                                          **kw))
    mc = learners.MinimaxQConfig(resolve_every=resolve_every, solver_iters=5)
    mm = learners.minimax_init(CFG, threefry.key(1), 8, "cpu")
    mm, _ = learners.minimax_train(CFG, mc, mm, 3)
    mm, td = learners.minimax_train(CFG, mc, mm, 3 * resolve_every)
    assert seen == [(2, periods)] and td.shape == (3 * resolve_every,)
    assert int(mm.step) == 3 + 3 * resolve_every
    seen.clear()
    learners.iql_train(CFG, learners.IQLConfig(), learners.iql_init(
        CFG, threefry.key(0), 8, "cpu"), 5)
    assert seen == [(5, learners.GROUP_STEPS)]
