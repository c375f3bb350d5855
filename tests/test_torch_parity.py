"""The port's parity backend (core/parity.py) against the JAX package's and
against the golden fixtures generated by executing the reference.

Tolerance 0 throughout: thresholds, draws and outputs are integers or
float64/float32 bit patterns, compared for equality.
"""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxEnvConfig
from gym_soccer_tpu.core import parity as jparity
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import mt19937, parity, rules, tables

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

with open(os.path.join(os.path.dirname(__file__), "golden",
                       "reference_golden.json")) as f:
    GOLD = json.load(f)

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)
CPU = torch.device("cpu")
TABLE_FIELDS = ("nS", "n_rows", "raw_to_dense", "cum_pair", "meta",
                "isd_cum_hi", "isd_cum_lo", "isd_raw")


def _jcfg(cfg):
    return JaxEnvConfig(cfg.width, cfg.height, cfg.slip_prob, cfg.max_steps)


def hex_to_f64(h):
    return np.frombuffer(bytes.fromhex(h), dtype=np.float64)[0]


def random_policy_array(n_states, n_actions, seed):
    return np.random.RandomState(seed).randint(
        0, n_actions, size=n_states).astype(np.int32)


def _np(tree):
    return [np.asarray(x) for x in tree]


# ----------------------------------------------------------------------
# Tables
# ----------------------------------------------------------------------

@pytest.mark.parametrize("frozen,seed", [(None, None), ("player_b", 0),
                                         ("player_a", 1)])
def test_parity_tables_byte_equal(frozen, seed):
    pol = None if seed is None else random_policy_array(761, 5, seed)
    got = parity.parity_tables(CFG, frozen, pol)
    want = jparity.parity_tables(_jcfg(CFG), frozen, pol)
    for name in TABLE_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.tobytes() == w.tobytes(), name
        else:
            assert g == w, name


def test_collapse_single_agent_byte_equal():
    from gym_soccer_tpu.core import tables as jtables
    pol = random_policy_array(761, 5, 3)
    got = tables.collapse_single_agent(tables.build_tables(CFG), "player_a",
                                       pol)
    want = jtables.collapse_single_agent(
        jtables.build_tables(_jcfg(CFG)), "player_a", pol)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


# ----------------------------------------------------------------------
# Stepping, against the JAX package on the same streams
# ----------------------------------------------------------------------

STEP_CASES = [EnvConfig(5, 4, 0.2), EnvConfig(5, 4, 0.0),
              EnvConfig(7, 5, 0.3)]
B = 64


def _cfg_id(cfg):
    return f"{cfg.width}x{cfg.height}-slip{cfg.slip_prob}"


def _case(cfg, T):
    """Seeds, policies and a [T, B] joint-row script made with numpy."""
    nS = tables.build_statespace(cfg).nS
    rng = np.random.RandomState(cfg.width * 10 + int(cfg.slip_prob * 10))
    seeds = rng.randint(0, 2**31, B).astype(np.uint32)
    pol_a, pol_b = rng.randint(0, 5, (2, nS)).astype(np.int32)
    rows = (rng.randint(0, 5, (T, B)) * 5
            + rng.randint(0, 5, (T, B))).astype(np.int32)
    return seeds, pol_a, pol_b, rows


def _streams(seeds, n):
    hi, lo = jparity.gen_streams(seeds, n)
    return (hi, lo), parity.gen_streams(seeds, n, CPU)


def _assert_state_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _assert_out_equal(got, want):
    for name, g, w in zip(type(got)._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("cfg", STEP_CASES, ids=_cfg_id)
def test_gen_streams_equal(cfg):
    seeds = _case(cfg, 1)[0]
    (jh, jl), (h, l) = _streams(seeds, 300)
    assert np.array_equal(h.numpy(), jh) and np.array_equal(l.numpy(), jl)


@pytest.mark.parametrize("cfg", STEP_CASES, ids=_cfg_id)
def test_parity_step_equals_jax(cfg):
    """Single steps, scripted and closed loop, from a mid-episode state."""
    seeds, pol_a, pol_b, rows = _case(cfg, 40)
    (jh, jl), (h, l) = _streams(seeds, 90)
    jcfg = _jcfg(cfg)
    jpt, pt = jparity.parity_tables(jcfg), parity.parity_tables(cfg)
    jst, st = jparity.parity_init(jcfg, B), parity.parity_init(cfg, B, CPU)
    jrows = jparity.policy_rows(jpt, pol_a, pol_b)
    prow = parity.policy_rows(pt, pol_a, pol_b, device=CPU)
    assert np.array_equal(prow.numpy(), np.asarray(jrows))
    jstep = jax.jit(lambda s, r, pr: jparity.parity_step(
        jcfg, jpt, s, r, jnp.asarray(jh), jnp.asarray(jl), pol_rows=pr))
    jstep_s = jax.jit(lambda s, r: jparity.parity_step(
        jcfg, jpt, s, r, jnp.asarray(jh), jnp.asarray(jl)))
    for t in range(40):
        if t % 2:
            jst, jout = jstep(jst, rows[t], jrows)
            st, out = parity.parity_step(cfg, pt, st, None, h, l,
                                         pol_rows=prow.long())
        else:
            jst, jout = jstep_s(jst, rows[t])
            st, out = parity.parity_step(cfg, pt, st,
                                         torch.as_tensor(rows[t]), h, l)
        _assert_state_equal(st, jst)
        _assert_out_equal(out, jout)


@pytest.mark.parametrize("cfg", STEP_CASES, ids=_cfg_id)
def test_parity_rollout_equals_jax(cfg):
    T = 150
    seeds, _, _, rows = _case(cfg, T)
    (jh, jl), (h, l) = _streams(seeds, 2 * T + 2)
    jcfg = _jcfg(cfg)
    jpt, pt = jparity.parity_tables(jcfg), parity.parity_tables(cfg)
    jfin, jout = jax.jit(lambda s: jparity.parity_rollout(
        jcfg, jpt, s, jnp.asarray(rows), jnp.asarray(jh),
        jnp.asarray(jl)))(jparity.parity_init(jcfg, B))
    fin, out = parity.parity_rollout(cfg, pt, parity.parity_init(cfg, B, CPU),
                                     torch.as_tensor(rows), h, l)
    _assert_state_equal(fin, jfin)
    _assert_out_equal(out, jout)
    assert out.was_reset[1:].any(), "the script must cross episode ends"


@pytest.mark.parametrize("cfg", STEP_CASES, ids=_cfg_id)
def test_parity_policy_events_equals_jax(cfg):
    E = 330  # crosses a twist boundary of the device streams at 312
    seeds, pol_a, pol_b, _ = _case(cfg, 1)
    (jh, jl), (h, l) = _streams(seeds, E)
    jcfg = _jcfg(cfg)
    jpt, pt = jparity.parity_tables(jcfg), parity.parity_tables(cfg)
    jrows = jparity.policy_rows(jpt, pol_a, pol_b)
    jfin, jev = jax.jit(lambda s: jparity.parity_policy_events(
        jcfg, jpt, s, jrows, E, jnp.asarray(jh), jnp.asarray(jl)))(
        jparity.parity_init(jcfg, B))
    fin, ev = parity.parity_policy_events(
        cfg, pt, parity.parity_init(cfg, B, CPU),
        parity.policy_rows(pt, pol_a, pol_b, device=CPU), E, h, l)
    _assert_state_equal(fin, jfin)
    _assert_out_equal(ev, jev)


def test_device_rollouts_equal_host_stream_rollouts():
    """parity_rollout_device / parity_policy_rollout_device (tensor
    MT19937) equal the same rollouts on numpy RandomState streams."""
    T = 120
    seeds, pol_a, pol_b, rows = _case(CFG, T)
    pt = parity.parity_tables(CFG)
    h, l = parity.gen_streams(seeds, 2 * T + 2, CPU)
    st0 = parity.parity_init(CFG, B, CPU)
    rows_t = torch.as_tensor(rows)
    want = parity.parity_rollout(CFG, pt, st0, rows_t, h, l)
    got = parity.parity_rollout_device(CFG, pt, seeds, rows_t, CPU)
    _assert_state_equal(got[0], want[0])
    _assert_out_equal(got[1], [x.numpy() for x in want[1]])
    prow = parity.policy_rows(pt, pol_a, pol_b, device=CPU)
    want = parity.parity_policy_rollout(CFG, pt, st0, prow, T, h, l)
    got = parity.parity_policy_rollout_device(CFG, pt, seeds, prow, T, CPU)
    _assert_state_equal(got[0], want[0])
    _assert_out_equal(got[1], [x.numpy() for x in want[1]])


# ----------------------------------------------------------------------
# The all-thresholds-exceeded fallback
# ----------------------------------------------------------------------

def test_fallback_slot_equals_jax_oracle():
    """A draw at or above a row's last threshold takes the first in-list
    slot (the count of zero thresholds), like the reference's argmax over
    an all-False array and JAX's oracle `_pick_first_exceedance`.  Slip
    0.3 rows end at 0.9999999999999998, below the two largest draws."""
    rows = []
    for cfg in (EnvConfig(5, 4, 0.3), EnvConfig(5, 4, 0.2),
                EnvConfig(5, 4, 0.0)):
        cum = tables.build_tables(cfg).t_cum.reshape(-1, 36)
        idx = np.random.RandomState(0).choice(len(cum), 40, replace=False)
        rows.append(cum[idx])
    cum = np.concatenate(rows)                              # [120, 36]
    last = cum[:, -1]
    cands = [last, np.nextafter(last, 2.0), np.full_like(last, 1 - 2**-52),
             np.full_like(last, 1 - 2**-53), np.zeros_like(last),
             np.nextafter(last, 0.0)]
    assert (cum[:, -1] < 1 - 2**-53).any(), "no row reaches the fallback"
    for u in cands:
        ch, cl = parity.f64_bits(cum)
        uh, ul = parity.f64_bits(u)
        want = np.asarray(jparity._pick_first_exceedance(
            jnp.asarray(ch), jnp.asarray(cl), jnp.asarray(uh),
            jnp.asarray(ul)))
        got = parity._pick_first_exceedance(torch.as_tensor(cum),
                                            torch.as_tensor(u))
        assert np.array_equal(got.numpy(), want)
    # the fallback really is taken somewhere, and lands on a live slot
    u = np.full_like(last, 1 - 2**-53)
    got = parity._pick_first_exceedance(torch.as_tensor(cum),
                                        torch.as_tensor(u)).numpy()
    hit = cum[:, -1] <= u
    assert hit.any()
    assert np.array_equal(got[hit], (cum[hit] == 0).sum(-1))


# ----------------------------------------------------------------------
# Golden fixtures of the executed reference
# ----------------------------------------------------------------------

FIXTURES = {
    "traj_5x4_slip02_multi_seed123": (EnvConfig(5, 4, 0.2), None, None),
    "traj_5x4_slip02_multi_seed0": (EnvConfig(5, 4, 0.2), None, None),
    "traj_5x4_slip00_multi_seed5": (EnvConfig(5, 4, 0.0), None, None),
    "traj_7x5_slip03_multi_seed42": (EnvConfig(7, 5, 0.3), None, None),
    "traj_6x4_slip01_multi_seed77": (EnvConfig(6, 4, 0.1), None, None),
    "traj_9x6_slip025_multi_seed31": (EnvConfig(9, 6, 0.25), None, None),
    "traj_5x4_slip02_singleA_seed9": (EnvConfig(5, 4, 0.2), "player_b", 0),
    "traj_5x4_slip02_singleB_seed21": (EnvConfig(5, 4, 0.2), "player_a", 1),
}


def test_every_trajectory_fixture_is_covered():
    assert sorted(FIXTURES) == sorted(k for k in GOLD if k.startswith("traj_"))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_trajectory_fixture(name):
    """Every step of the fixture through the scripted twin on tensor
    MT19937 streams: state, observation, reward bit pattern (as float32),
    done and truncated; single-agent fixtures through collapsed tables."""
    cfg, frozen, pol_seed = FIXTURES[name]
    pol = None if frozen is None else random_policy_array(761, 5, pol_seed)
    pt = parity.parity_tables(cfg, frozen, pol)
    rec = GOLD[name]
    learner = {None: "player_a", "player_b": "player_a",
               "player_a": "player_b"}[frozen]
    steps = [r for r in rec["steps"] if not r.get("reset")]
    rows = [r["action"]["player_a"] * 5 + r["action"]["player_b"]
            if frozen is None else r["action"][learner] for r in steps]
    rows = torch.as_tensor(np.asarray(rows, np.int32)[:, None])
    T = len(steps)
    h, l = mt19937.device_streams([rec["seed"]], 2 * T + 2, CPU)
    st = parity.parity_init(cfg, 1, CPU)
    n_resets = 0
    for t, r in enumerate(steps):
        st, out = parity.parity_step(cfg, pt, st, rows[t], h, l)
        assert list(rules.raw_decode(np, int(st.raw[0]), cfg)) == \
            r["state"], (name, t)
        assert int(out.obs[0]) == r["obs"][learner], (name, t)
        want_r = np.float32(hex_to_f64(r["reward"][learner]))
        assert out.reward_a.numpy().tobytes() == want_r.tobytes(), (name, t)
        assert bool(out.done[0]) == r["done"][learner], (name, t)
        assert bool(out.truncated[0]) == r["trunc"][learner], (name, t)
        n_resets += int(out.was_reset[0])
    assert n_resets == 1 + sum(1 for r in rec["steps"] if r.get("reset"))
    # the scripted rollout on the same streams ends in the same state
    fin, _ = parity.parity_rollout_device(cfg, pt, [rec["seed"]], rows, CPU)
    assert torch.equal(fin.raw, st.raw)


def _check_policy_eval(out, fx):
    obs, rew = out.obs[:, 0].numpy(), out.reward_a[:, 0].numpy()
    done, trunc = out.done[:, 0].numpy(), out.truncated[:, 0].numpy()
    h = hashlib.sha256()
    for t in range(len(obs)):
        h.update(int(obs[t]).to_bytes(4, "little"))
        h.update(np.float32(rew[t]).tobytes())
        h.update(b"\x01" if done[t] else b"\x00")
        h.update(b"\x01" if trunc[t] else b"\x00")
    assert h.hexdigest() == fx["step_stream_digest"]
    ends = np.flatnonzero(done | trunc)
    assert len(ends) == fx["n_episodes"]
    assert np.diff(np.concatenate([[-1], ends])).tolist() == \
        fx["episode_lengths"]
    start = 0
    for i, e in enumerate(ends):
        total = np.float64(0.0)
        for t in range(start, e + 1):
            total += np.float64(rew[t])
        assert total == hex_to_f64(fx["episode_rewards"][i]), i
        start = e + 1


@pytest.mark.parametrize("name", ["policy_eval_5x4_slip02_vi_vs_randomB",
                                  "policy_eval_5x4_slip02_joint"])
def test_policy_eval_fixture_in_full(name):
    """The reference main()'s closed-loop evaluations in full (1000 and 200
    episodes on one continuing stream) through parity_policy_rollout, on
    two lanes of the same seed."""
    fx = GOLD[name]
    if "policy" in fx:  # VI best response vs frozen random B
        pt = parity.parity_tables(CFG, "player_b",
                                  random_policy_array(761, 5, 0))
        prow = parity.policy_rows(pt, policy_a=fx["policy"], device=CPU)
    else:
        pt = parity.parity_tables(CFG)
        prow = parity.policy_rows(pt, fx["policy_a"], fx["policy_b"],
                                  device=CPU)
    T = fx["total_steps"]
    h, l = parity.gen_streams([fx["reset_seed"]] * 2, 2 * T + 2, CPU)
    _, out = parity.parity_policy_rollout(
        CFG, pt, parity.parity_init(CFG, 2, CPU), prow, T, h, l)
    assert torch.equal(out.obs[:, 0], out.obs[:, 1])
    _check_policy_eval(out, fx)


def test_policy_rows_validation():
    pt = parity.parity_tables(CFG)
    pol = np.zeros(761, np.int32)
    joint = parity.policy_rows(pt, pol, pol + 3, device=CPU)
    assert pt.n_rows == 25 and int(joint.min()) == int(joint.max()) == 3
    pt1 = parity.parity_tables(CFG, "player_b", pol)
    assert pt1.n_rows == 5
    assert np.array_equal(parity.policy_rows(pt1, policy_a=pol + 2,
                                             device=CPU).numpy(),
                          pol + 2)
    with pytest.raises(ValueError):
        parity.policy_rows(pt, pol, device=CPU)
    with pytest.raises(ValueError):
        parity.policy_rows(pt1, device=CPU)


def test_policy_rows_default_to_the_card():
    """Like every function of the port that makes its own tensors,
    policy_rows makes them on the card unless the caller asks for the CPU
    (without a card it raises rather than falling back)."""
    import inspect
    default = inspect.signature(parity.policy_rows).parameters["device"]
    assert default.default == "cuda"
    if not torch.cuda.is_available():
        pol = np.zeros(761, np.int32)
        with pytest.raises((RuntimeError, AssertionError)):
            parity.policy_rows(parity.parity_tables(CFG), pol, pol)


def test_state_handed_between_packages():
    """A JAX run's ParityState, carried into the port through interop,
    continues exactly as the JAX run does; and a JAX MT19937 state twists
    in the port to JAX's next state."""
    from gym_soccer_tpu.core import mt19937 as jmt
    from gym_soccer_tpu_torch import interop
    cfg, T = CFG, 60
    seeds, _, _, rows = _case(cfg, 2 * T)
    (jh, jl), (h, l) = _streams(seeds, 4 * T + 2)
    jcfg = _jcfg(cfg)
    jpt, pt = jparity.parity_tables(jcfg), parity.parity_tables(cfg)
    roll = jax.jit(lambda s, r: jparity.parity_rollout(
        jcfg, jpt, s, r, jnp.asarray(jh), jnp.asarray(jl)))
    jmid, _ = roll(jparity.parity_init(jcfg, B), jnp.asarray(rows[:T]))
    jfin, jout = roll(jmid, jnp.asarray(rows[T:]))
    mid = interop.parity_state_from_numpy(_np(jmid), CPU)
    fin, out = parity.parity_rollout(cfg, pt, mid, torch.as_tensor(rows[T:]),
                                     h, l)
    _assert_state_equal(fin, jfin)
    _assert_out_equal(out, jout)
    back = interop.parity_state_to_numpy(fin)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jfin))

    jst = jax.jit(jmt.seed_states)(jnp.asarray(seeds))
    st = interop.mt_states_from_numpy(np.asarray(jst), CPU)
    assert np.array_equal(interop.mt_states_to_numpy(mt19937.twist(st)),
                          np.asarray(jax.jit(jmt.twist)(jst)))
