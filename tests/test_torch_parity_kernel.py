"""The port's parity kernel module (ops/parity_kernel.py) against the JAX
package's: the class tables, the joint-row table, and the wrappers'
outputs, which on the CPU are the plain versions, against the Pallas
kernel run in interpret mode.  Tolerance 0: journals and final fields are
int32 and compared for equality."""
import functools
import os

import jax
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxEnvConfig
from gym_soccer_tpu.core import parity as jparity
from gym_soccer_tpu.ops import parity_kernel as jpk
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import parity, rules, tables
from gym_soccer_tpu_torch.ops import parity_kernel as pk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B = 128


def _jcfg(cfg):
    return JaxEnvConfig(cfg.width, cfg.height, cfg.slip_prob, cfg.max_steps)


def _policies(cfg, sa=1, sb=7):
    nS = tables.build_statespace(cfg).nS
    return (np.random.RandomState(sa).randint(0, 5, nS).astype(np.int32),
            np.random.RandomState(sb).randint(0, 5, nS).astype(np.int32))


def _assert_events_equal(got, want):
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.dtype == np.int32, name
        assert np.array_equal(g.numpy(), w), name


# ----------------------------------------------------------------------
# Class tables
# ----------------------------------------------------------------------

def _f64_from_bytes(limbs):
    """JAX's 8 byte limbs (hi bytes then lo bytes, MSB first) -> float64."""
    b = limbs.astype(np.uint64)
    hi = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    lo = (b[..., 4] << 24) | (b[..., 5] << 16) | (b[..., 6] << 8) | b[..., 7]
    return ((hi << np.uint64(32)) | lo).view(np.float64)


@pytest.mark.parametrize("cfg", [EnvConfig(5, 4, 0.2), EnvConfig(5, 4, 0.0),
                                 EnvConfig(7, 5, 0.3)],
                         ids=["5x4-0.2", "5x4-0.0", "7x5-0.3"])
def test_build_pk_equals_jax(cfg):
    got, want = pk.build_pk(cfg), jpk.build_pk(_jcfg(cfg))
    assert got.n_raw == want.n_raw
    assert got.occ_codes == want.occ_codes
    P = len(want.occ_codes)
    cum = _f64_from_bytes(want.cum_limbs[:P].reshape(P, 36, 8))
    assert got.cls_cum.dtype == np.float64
    assert got.cls_cum.tobytes() == cum.tobytes()
    assert np.array_equal(got.code_class[list(want.occ_codes)], np.arange(P))
    limbs = np.asarray(want.isd_limbs, np.uint64)
    hi = (limbs[:, 0] << np.uint64(16)) | limbs[:, 1]
    lo = (limbs[:, 2] << np.uint64(16)) | limbs[:, 3]
    isd = ((hi << np.uint64(32)) | lo).view(np.float64)
    assert got.isd_cum.tobytes() == isd.tobytes()
    if cfg.slip_prob == 0.0:
        assert P == 3  # only combo 0 counts: digits 0, 1, 2


def test_build_pk_rejects_oversize_grids():
    with pytest.raises(ValueError, match="journal packing"):
        pk.build_pk(EnvConfig(40, 30, 0.2))


@pytest.mark.parametrize("cfg", [EnvConfig(5, 4, 0.2), EnvConfig(7, 5, 0.3)],
                         ids=["5x4", "7x5"])
def test_jointrow_raw_equals_jax(cfg):
    pa, pb = _policies(cfg, 3, 4)
    got = pk.jointrow_raw(cfg, pa, pb)
    want = jpk.jointrow_raw(_jcfg(cfg), pa, pb)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ----------------------------------------------------------------------
# Closed loop (K12) and scripted (K13) against the Pallas kernel
# ----------------------------------------------------------------------

CLOSED = {"5x4-0.2": (EnvConfig(5, 4, 0.2), 640, False),
          "5x4-0.0": (EnvConfig(5, 4, 0.0), 640, False),
          "5x4-max_steps17": (EnvConfig(5, 4, 0.2, max_steps=17), 384, True),
          "11x7-0.3": (EnvConfig(11, 7, 0.3), 256, False)}


@functools.lru_cache(maxsize=None)
def _pallas_closed(case):
    """(seeds, jr, the Pallas kernel's output in interpret mode) of a CLOSED
    case, computed once for the tests that hold the port to it."""
    cfg, E, stand = CLOSED[case]
    pa, pb = _policies(cfg)
    if stand:
        pa, pb = np.zeros_like(pa), np.zeros_like(pb)
    seeds = np.arange(B, dtype=np.uint32) * 7 + 3
    jr = pk.jointrow_raw(cfg, pa, pb)
    want = jpk.parity_events(_jcfg(cfg), seeds, jr, E, interpret=True)
    return seeds, jr, jax.tree.map(np.asarray, want)


def _script_case():
    T = 120
    rng = np.random.RandomState(5)
    rows = (rng.randint(0, 5, (T, B)) * 5
            + rng.randint(0, 5, (T, B))).astype(np.int32)
    return T, rows, np.arange(B, dtype=np.uint32) * 3 + 1


@functools.lru_cache(maxsize=None)
def _pallas_scripted(slip):
    T, rows, seeds = _script_case()
    want = jpk.parity_scripted_events(_jcfg(EnvConfig(5, 4, slip)), seeds,
                                      rows, 2 * T, interpret=True)
    return jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("case", sorted(CLOSED))
def test_parity_events_equal_pallas_interpret(case):
    """Journal and all 8 final fields, across two MT19937 twists (E > 624),
    goals, truncations and episode chaining; with stand-vs-stand policies
    every episode of the max_steps=17 case truncates."""
    cfg, E, stand = CLOSED[case]
    seeds, jr, want = _pallas_closed(case)
    got = pk.parity_events(cfg, seeds, jr, E, "cpu")
    _assert_events_equal(got, want)
    J = pk.unpack_journal(got.journal)
    jJ = jpk.unpack_journal(np.asarray(want.journal))
    for k in jJ:
        assert np.array_equal(J[k].numpy(), jJ[k]), k
    assert torch.equal(got.steps, (1 - J["was_reset"]).sum(0).int())
    if stand:
        assert int(J["truncated"].sum()) > 0 and int(J["done"].sum()) == 0
    else:
        assert int(J["done"].sum()) > 0


@pytest.mark.parametrize("slip", [0.2, 0.0])
def test_parity_scripted_events_equal_pallas_interpret(slip):
    """A 120-row script over 240 events: every lane runs past the script's
    end (row 0 there) within the run."""
    cfg = EnvConfig(5, 4, slip)
    T, rows, seeds = _script_case()
    want = _pallas_scripted(slip)
    got = pk.parity_scripted_events(cfg, seeds, rows, 2 * T, "cpu")
    _assert_events_equal(got, want)
    assert bool((got.steps > T).all())


# ----------------------------------------------------------------------
# A numpy mirror of the CUDA kernel's event loop (csrc/parity_kernel.cu)
# ----------------------------------------------------------------------

def _mirror(cfg, seeds, n_events, jr=None, script=None):
    """The kernel's per-event arithmetic in numpy on the reference's own
    streams (JAX's gen_streams): the class lookup (the word's key closed
    loop, class[key, row] scripted), the two-level search of the class's
    thresholds with the fallback slot, the next-word lookup, and the merge
    with the ISD pick.  Returns a ParityEventsOut of numpy arrays."""
    lt = pk.build_lookup(cfg)
    if script is None:
        cls, words, isd = (t.numpy() for t in pk.closed_tables(
            pk.device_lookup(cfg, torch.device("cpu")), torch.as_tensor(jr)))
    else:
        cls, words = lt.cls.ravel(), lt.next_word.reshape(-1, 36)
        isd = lt.isd_word
    words = words.astype(np.int64) & pk.M32
    isd = isd.astype(np.int64) & pk.M32
    hi, lo = jparity.gen_streams(seeds, n_events)
    u = ((hi.astype(np.uint64) << np.uint64(32))
         | lo.astype(np.uint64)).view(np.float64)
    isd_cum = pk.build_pk(cfg).isd_cum
    n = len(seeds)
    lane = np.arange(n)
    word = np.zeros(n, np.int64)
    t, nr, steps = (np.zeros(n, np.int64), np.ones(n, np.int64),
                    np.zeros(n, np.int64))
    journal = np.empty((n_events, n), np.int32)
    for k in range(n_events):
        uk = u[:, k]
        key = word >> 17
        if script is None:
            base, c = word & 0x7FFF, key
        else:
            T = script.shape[0]
            row = np.where(steps < T,
                           script[np.minimum(steps, T - 1), lane], 0)
            base = key * 25 + row
            c = cls[base]
        cum = lt.cum[c]
        # the group of six (by the groups' last thresholds), then the slot
        # among the group's first five; the fallback slot past them all
        g = (cum[:, 5:36:6] <= uk[:, None]).sum(1)
        h = np.minimum(g, 5)
        group = np.take_along_axis(cum, 6 * h[:, None] + np.arange(5), 1)
        i = 6 * h + (group <= uk[:, None]).sum(1)
        i = np.where(g >= 6, cum[:, 36].astype(np.int64), i)
        ii = np.minimum((isd_cum[None, :] <= uk[:, None]).sum(1),
                        len(isd_cum) - 1)
        reset = nr != 0
        word = np.where(reset, isd[ii], words[base, i])
        f = pk.unpack_word(word)
        trunc = (~reset & (t + 1 >= cfg.max_steps)) * 1
        journal[k] = (f["raw"] | f["done"] << 15 | trunc << 16 | nr << 17
                      | (f["reward"] + 1) << 18)
        t = np.where(reset, 0, t + 1)
        steps = steps + 1 - nr
        nr = np.where(reset, 0, f["done"] | trunc)
    fields = rules.raw_decode(np, word & 0x7FFF, cfg)
    return pk.ParityEventsOut(journal, *(np.asarray(x, np.int32) for x in
                                         (*fields, t, nr, steps)))


def _assert_np_events_equal(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), name


@pytest.mark.parametrize("case", sorted(CLOSED))
def test_kernel_mirror_equals_pallas_interpret(case):
    """The mirror of the kernel's lookup loop, closed loop, reproduces the
    Pallas kernel's journal and final fields (max_steps=17, slip 0.0, 11x7
    and two MT19937 twists included)."""
    cfg, E, _ = CLOSED[case]
    seeds, jr, want = _pallas_closed(case)
    _assert_np_events_equal(_mirror(cfg, seeds, E, jr=jr), want)


@pytest.mark.parametrize("slip", [0.2, 0.0])
def test_kernel_mirror_scripted_equals_pallas_interpret(slip):
    """The mirror's scripted loop (class[key, row], the script row of the
    lane's transition count, row 0 past the end) reproduces the Pallas
    kernel."""
    T, rows, seeds = _script_case()
    _assert_np_events_equal(
        _mirror(EnvConfig(5, 4, slip), seeds, 2 * T, script=rows),
        _pallas_scripted(slip))


def test_scripted_events_equal_step_time_rollout():
    """Transition events, filtered per lane, are the step-time scripted
    rollout (core/parity.parity_rollout) on the same seeds."""
    cfg = EnvConfig(5, 4, 0.2)
    T = 60
    rng = np.random.RandomState(2)
    rows = (rng.randint(0, 5, (T, B)) * 5
            + rng.randint(0, 5, (T, B))).astype(np.int32)
    seeds = np.arange(B) + 11
    ev = pk.parity_scripted_events(cfg, seeds, rows, 2 * T, "cpu")
    J = pk.unpack_journal(ev.journal)
    _, out = parity.parity_rollout_device(
        cfg, parity.parity_tables(cfg), seeds, torch.as_tensor(rows), "cpu")
    r2d = torch.as_tensor(tables.build_statespace(cfg).raw_to_dense)
    for b in range(0, B, 9):
        tr = J["was_reset"][:, b] == 0
        assert int(tr.sum()) >= T
        assert torch.equal(r2d[J["raw"][tr, b][:T].long()], out.obs[:, b])
        assert torch.equal(J["reward_a"][tr, b][:T].float(),
                           out.reward_a[:, b])
        assert torch.equal(J["done"][tr, b][:T].bool(), out.done[:, b])


def test_closed_loop_reproduces_reference_policy_eval():
    """The joint-policy golden fixture's first 40 episodes from the event
    journal of one lane (the card reproduces all of them, chip_smoke.py)."""
    import json
    import os
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "reference_golden.json")) as f:
        fx = json.load(f)["policy_eval_5x4_slip02_joint"]
    cfg = EnvConfig(5, 4, 0.2)
    n_epi = 40
    lengths = fx["episode_lengths"][:n_epi]
    jr = pk.jointrow_raw(cfg, fx["policy_a"], fx["policy_b"])
    out = pk.parity_events(cfg, [fx["reset_seed"]] * B, jr,
                           sum(lengths) + n_epi, "cpu")
    J = {k: v[:, 0].numpy() for k, v in pk.unpack_journal(out.journal).items()}
    ends = np.flatnonzero(J["done"] | J["truncated"])
    starts = np.concatenate([[0], ends[:-1] + 1])
    assert [int((J["was_reset"][s:e + 1] == 0).sum())
            for s, e in zip(starts, ends)] == lengths
    want = [np.frombuffer(bytes.fromhex(h), np.float64)[0]
            for h in fx["episode_rewards"][:n_epi]]
    assert [float(J["reward_a"][s:e + 1].sum())
            for s, e in zip(starts, ends)] == want


def test_wrappers_check_their_arguments():
    cfg = EnvConfig(5, 4, 0.2)
    jr = pk.jointrow_raw(cfg, *_policies(cfg))
    with pytest.raises(ValueError, match="multiple of 128"):
        pk.parity_events(cfg, np.arange(100), jr, 4, "cpu")
    with pytest.raises(ValueError, match="jr must be"):
        pk.parity_events(cfg, np.arange(B), jr[:-1], 4, "cpu")
    with pytest.raises(ValueError, match=r"rows must be \[T, 128\]"):
        pk.parity_scripted_events(cfg, np.arange(B), np.zeros((4, 64)), 4,
                                  "cpu")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pk._launch("parity_events", cfg, pk.build_pk(cfg),
                   torch.zeros(B, dtype=torch.int64, device="meta"),
                   torch.as_tensor(jr), 4, 128)


@pytest.mark.parametrize("scripted", [False, True], ids=["jr", "script"])
@pytest.mark.parametrize("bad", [-7, 25, 2**31 + 3])
def test_wrappers_clamp_rows_outside_the_table(scripted, bad):
    """A joint row outside [0, 25) in jr or the script is clamped into it
    where the arrays arrive, for the wrapper and its plain version alike:
    the run equals the run on the clamped rows."""
    cfg = EnvConfig(5, 4, 0.2)
    seeds = np.arange(B)
    if scripted:
        rows = np.asarray(_script_case()[1][:40], np.int64)
        calls = (pk.parity_scripted_events, pk.parity_scripted_events_plain)
    else:
        rows = pk.jointrow_raw(cfg, *_policies(cfg)).astype(np.int64)
        calls = (pk.parity_events, pk.parity_events_plain)
    rows.ravel()[::7] = bad
    clamped = np.clip(rows, 0, 24).astype(np.int32)
    for call in calls:
        got = call(cfg, seeds, rows, 80, "cpu")
        _assert_events_equal(got, call(cfg, seeds, clamped, 80, "cpu"))


def test_zero_events():
    cfg = EnvConfig(5, 4, 0.2)
    out = pk.parity_events(cfg, np.arange(B), pk.jointrow_raw(
        cfg, *_policies(cfg)), 0, "cpu")
    assert out.journal.shape == (0, B)
    assert out.needs_reset.tolist() == [1] * B and int(out.steps.sum()) == 0


def test_event_oracle_equals_jax_on_jax_streams():
    """The plain version's event step, fed JAX's host streams, equals the
    JAX oracle parity_policy_events (the layer the Pallas kernel is
    held to in the JAX package)."""
    import jax.numpy as jnp
    cfg = EnvConfig(5, 4, 0.2)
    pa, pb = _policies(cfg, 2, 9)
    seeds = np.arange(B, dtype=np.uint32) % 31
    E = 200
    hi, lo = jparity.gen_streams(seeds, E)
    jpt = jparity.parity_tables(_jcfg(cfg))
    _, jev = jax.jit(lambda s: jparity.parity_policy_events(
        _jcfg(cfg), jpt, s, jparity.policy_rows(jpt, pa, pb), E,
        jnp.asarray(hi), jnp.asarray(lo)))(jparity.parity_init(_jcfg(cfg), B))
    got = pk.parity_events(cfg, seeds, pk.jointrow_raw(cfg, pa, pb), E, "cpu")
    J = pk.unpack_journal(got.journal)
    assert np.array_equal(J["raw"].numpy(), np.asarray(jev.raw))
    assert np.array_equal(J["reward_a"].float().numpy(),
                          np.asarray(jev.reward_a))
    assert np.array_equal(J["was_reset"].bool().numpy(),
                          np.asarray(jev.was_reset))
