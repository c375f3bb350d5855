"""Kernels S2 (the mixed-geometry engine's step) and S3 (the alternating
engine's tick), ops/csrc/mixed_alt_kernel.cu, on the CPU.

* Scalar Python mirrors of S2's and S3's lane programs (the threefry
  draws at n and the reset's at n + 1, S2's per-lane float32 slip
  thresholds, the collision chain and its slot, S3's mover and steal,
  the ISD picks, the observations before and after the reset) against
  ``multigrid.step_obs`` / ``alt_step_obs`` on the plain path, lane by
  lane over 64 steps, autoreset on and off: S2 on tools/bench_all's
  mixture (5x4 0.2, 6x5 0.1, 9x6 0.3), the ``--multigrid`` recipe's 5x4 +
  6x5 at 0.2, 5x4 + 11x7 and a mixture at slips 0.058 and 0.111; S3 on
  5x4 and 11x7 at slip 0.2; from goal-state, wrapping and truncating
  lanes (max_steps 6), boards of both parities of H.
* The per-lane thresholds at slips 0.058 and 0.111, where one float32
  operation on the float32 slip and one rounding of the float64 value
  differ.
* Autoreset on equals the step without reset, then ``reset_where`` /
  ``alt_reset_where`` on the ended lanes, with ``final_obs`` as the
  learners computed it; ``step_plain`` / ``alt_step_plain`` against the
  JAX package's engines on these boards.
* ``step`` / ``alt_step`` on CPU tensors are the plain versions; the
  wrappers refuse devices, shapes and types the kernels do not take; the
  ctypes struct and pointer counts match the .cu file.

Every comparison is exact: every int, every bool and every float32 bit."""
import os
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import multigrid as jmg
from gym_soccer_tpu.envs import soccer_alternating_env as jalt
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import batch, rules, threefry
from gym_soccer_tpu_torch.core import multigrid as mg
from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
from gym_soccer_tpu_torch.ops import _build
from gym_soccer_tpu_torch.ops import engine_kernel as ek
from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

M32 = 0xFFFFFFFF
B, MAX_STEPS, WARM, T = 48, 6, 8, 64
MIXTURES = {"bench-row": ((5, 4, 0.2), (6, 5, 0.1), (9, 6, 0.3)),
            "recipe": ((5, 4, 0.2), (6, 5, 0.2)),
            "5x4+11x7": ((5, 4, 0.2), (11, 7, 0.2)),
            "slips-0.058-0.111": ((5, 4, 0.058), (6, 5, 0.111))}
ALT_BOARDS = {"5x4": (5, 4, 0.2), "11x7": (11, 7, 0.2)}
AUTO = [True, False]


# ---- threefry, one lane ---------------------------------------------------

def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & M32


def _threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & M32, (x1 + k1) & M32
    for g in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def _uniforms(kw, n, count):
    """threefry.cuh's ``uniforms_at<count>``: uniform(fold_in(key, n))'s
    first ``count`` elements, float32."""
    k0, k1 = _threefry2x32(kw[0], kw[1], 0, n & M32)
    out = []
    for w in range(count):
        y0, y1 = _threefry2x32(k0, k1, 0, w)
        bits = ((y0 ^ y1) >> 9) | 0x3F800000
        one = np.float32(struct.unpack("<f", struct.pack("<I", bits))[0])
        out.append(one - np.float32(1.0))
    return out


def _wrap32(x):
    x &= M32
    return x - (1 << 32) if x >> 31 else x


# ---- the game, one lane ---------------------------------------------------

def _variant(u, keep, first):
    return 0 if u < keep else (1 if u < first else 2)


def _move(a, v):
    mc0, mr0 = int(a == 3) - int(a == 4), int(a == 2) - int(a == 1)
    if v == 0:
        return mc0, mr0
    return (-mr0, mc0) if v == 1 else (mr0, -mc0)


def _next(x, y, mc, mr, ball, H, W, lo, hi):
    nx = min(max(x + mr, 0), H - 1)
    ny = y + mc
    if ny in (0, W - 1) and not (lo <= nx <= hi and ball):
        ny = y
    return nx, ny


def _goal(s, W, lo, hi):
    xa, ya, xb, yb, p = s
    return (p == 0 and lo <= xa <= hi and ya in (0, W - 1)) or \
        (p == 1 and lo <= xb <= hi and yb in (0, W - 1))


def _resolve(s, aa, ab, ma, mb, u2, H, W, lo, hi):
    """game.cuh's ``resolve_step``: the new (xa, ya, xb, yb, p) and
    whether the lane started in a goal state."""
    xa, ya, xb, yb, p = s
    nxa, nya = _next(xa, ya, *ma, p == 0, H, W, lo, hi)
    nxb, nyb = _next(xb, yb, *mb, p == 1, H, W, lo, hi)
    c1 = (xa == xb and abs(ya - yb) == 1 and nya == yb and nyb == ya) or \
         (ya == yb and abs(xa - xb) == 1 and nxa == xb and nxb == xa)
    c2 = not c1 and ((nxa == xb and nya == yb and ab == 0) or
                     (nxb == xa and nyb == ya and aa == 0))
    c3 = not c1 and not c2 and (
        (xa == nxa and ya == nya and aa != 0 and nxb == xa and nyb == ya) or
        (xb == nxb and yb == nyb and ab != 0 and nxa == xb and nya == yb))
    c4 = not (c1 or c2 or c3) and nxa == nxb and nya == nyb
    c5 = not (c1 or c2 or c3 or c4)
    if _goal(s, W, lo, hi):
        return s, True
    w = [0.5 if c1 or c3 else (0.25 if c4 else 1.0),
         0.25 if c4 else (0.5 if c1 or c3 else 0.0), 0.25 if c4 else 0.0]
    sums = np.cumsum(np.float32([w[0], w[1], w[2], w[2]]), dtype=np.float32)
    k = min(int(sum(s_ <= u2 for s_ in sums)), 3)
    if k == 0:
        return (nxa if c5 else xa, nya if c5 else ya,
                nxb if c4 or c5 else xb, nyb if c4 or c5 else yb,
                1 - p if c2 else (p if c5 else 0)), False
    if k == 1:
        return (xa, ya, nxb if c4 else xb, nyb if c4 else yb, 1), False
    return (nxa, nya, xb, yb, 0 if k == 2 else 1), False


def _raw(s, H, W):
    xa, ya, xb, yb, p = s
    return (((xa * W + ya) * H + xb) * W + yb) * 2 + p


def _reward(s, W, lo, hi):
    ball = s[1] if s[4] == 0 else s[3]
    return (1.0 if ball == W - 1 else -1.0) if _goal(s, W, lo, hi) else 0.0


def _thresholds(q32):
    """S2's per-lane thresholds: one float32 operation each on the lane's
    float32 slip, as ``1.0 - q`` and ``1.0 - q * 0.5`` on a tensor."""
    return np.float32(1.0) - q32, np.float32(1.0) - q32 * np.float32(0.5)


def _mixed_lane(board, q32, vid, codec, f, kw, aa, ab, autoreset):
    """S2's program for one lane: (ra, ca, rb, cb, p, t, n, obs,
    final_obs, reward, goal, truncated)."""
    H, W, lo, hi = board
    *s, t, n = f
    u = _uniforms(kw, n, 3)
    keep, first = _thresholds(q32)
    ma = _move(aa, _variant(u[0], keep, first))
    mb = _move(ab, _variant(u[1], keep, first))
    s, was = _resolve(tuple(s), aa, ab, ma, mb, u[2], H, W, lo, hi)
    now = _goal(s, W, lo, hi)
    reward = _reward(s, W, lo, hi) if now and not was else 0.0
    t1 = _wrap32(t + 1)
    trunc = t1 >= MAX_STEPS

    def obs(s):
        raw = _raw(s, H, W)
        raw += codec.raw_to_dense.shape[1] if raw < 0 else 0
        return int(codec.offsets[vid] + codec.raw_to_dense[vid, raw])

    final = obs(s)
    n_out, t_out = n + 1, t1
    if autoreset:
        ur = _uniforms(kw, n + 1, 1)[0]
        nI = 4 if H % 2 == 0 else 2
        idx = min(int(ur * np.float32(nI)), nI - 1)
        n_out = n + 2
        if now or trunc:
            swap = H % 2 == 0 and idx // 2 == 1
            lo_row = (H - 1) // 2 if H % 2 == 0 else H // 2
            s = (H // 2 if swap else lo_row, 2, lo_row if swap else H // 2,
                 W - 3, idx % 2)
            t_out = 0
    return (*s, t_out, _wrap32(n_out), obs(s) if autoreset else final, final,
            reward, now, trunc)


def _alt_lane(cfg, r2d, isd, f, kw, a, autoreset):
    """S3's program for one lane: (ra, ca, rb, cb, p, turn, t, n, obs,
    final_obs, reward, goal, truncated)."""
    H, W = cfg.H, cfg.W
    lo, hi = cfg.goal_row_bounds
    xa, ya, xb, yb, p, turn, t, n = f
    keep, first, _ = ek.slip_constants(cfg.slip_prob)
    mc, mr = _move(a, _variant(_uniforms(kw, n, 1)[0], keep, first))
    mover, opp = ((xa, ya), (xb, yb)) if turn == 0 else ((xb, yb), (xa, ya))
    nx, ny = _next(*mover, mc, mr, p == turn, H, W, lo, hi)
    if (nx, ny) == opp:
        (nx, ny), p = mover, 1 - turn
    s = (nx, ny, xb, yb, p) if turn == 0 else (xa, ya, nx, ny, p)
    turn = 1 - turn
    now = _goal(s, W, lo, hi)
    reward = _reward(s, W, lo, hi)
    t1 = _wrap32(t + 1)
    trunc = t1 >= MAX_STEPS

    def obs(s, turn):   # JAX's gather: wrap a negative code, then clamp
        raw = _raw(s, H, W) * 2 + turn
        raw += len(r2d) if raw < 0 else 0
        return int(r2d[min(max(raw, 0), len(r2d) - 1)])

    final = obs(s, turn)
    n_out, t_out = n + 1, t1
    if autoreset:
        ur = _uniforms(kw, n + 1, 1)[0]
        cum = isd.isd_cum.numpy()
        idx = min(max(int(sum(c <= ur for c in cum)), 0), len(cum) - 1)
        n_out = n + 2
        if now or trunc:
            s, turn, t_out = tuple(int(x) for x in isd.isd_fields[idx]), 0, 0
    return (*s, turn, t_out, _wrap32(n_out),
            obs(s, turn) if autoreset else final, final, reward, now, trunc)


# ---- the engines' starting states -----------------------------------------

def _cfgs(mix):
    return tuple(EnvConfig(width=w, height=h, slip_prob=q, max_steps=MAX_STEPS)
                 for w, h, q in mix)


def _lanes_to_test(st):
    """Counters at 2**31 - 3 on every 5th lane (the draws' counters
    wrap), clocks one step from truncation on every 7th."""
    n, t = st.n.clone(), st.t.clone()
    n[::5] = 2 ** 31 - 3
    t[1::7] = MAX_STEPS - 1
    return st._replace(n=n, t=t % MAX_STEPS)


def _mixed_start(mix, seed):
    """B lanes of ``mix`` after WARM steps without autoreset (the lanes
    that scored stay in their goal states), max_steps MAX_STEPS."""
    st = mg.init(_cfgs(mix), threefry.key(seed), B, "cpu")
    st = st._replace(geo=st.geo._replace(max_steps=MAX_STEPS))
    rng = np.random.default_rng(seed)
    for _ in range(WARM):
        aa, ab = (torch.as_tensor(rng.integers(0, 5, B)) for _ in range(2))
        st, _ = mg.step_plain(st, aa, ab, autoreset=False)
    return _lanes_to_test(st)


def _alt_start(board, seed):
    cfg = _cfgs((board,))[0]
    st = alt.alt_init(cfg, threefry.key(seed), B, first_mover=seed % 2,
                      device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(WARM):
        st, _ = alt.alt_step_plain(cfg, st, torch.as_tensor(
            rng.integers(0, 5, B)), autoreset=False)
    turn = st.turn.clone()
    turn[::3] = 1 - turn[::3]   # both movers in one batch
    # A in its goal with the ball on every 11th lane (goals do not absorb
    # here: these lanes move on without autoreset)
    ra, ca, rb, cb, p = (f.clone() for f in st[:5])
    ra[::11], ca[::11], rb[::11], cb[::11], p[::11] = (
        cfg.goal_row_bounds[0], cfg.W - 1, 0, 1, 0)
    return cfg, _lanes_to_test(st._replace(
        rows_a=ra, cols_a=ca, rows_b=rb, cols_b=cb, poss=p, turn=turn))


def _actions(seed, count):
    rng = np.random.default_rng(seed)
    for s in range(T):
        dtype = np.int64 if s % 2 else np.int32
        yield tuple(torch.as_tensor(rng.integers(0, 5, B).astype(dtype))
                    for _ in range(count))


def _bits(x):
    x = x.numpy()
    return x.view(np.int32) if x.dtype == np.float32 else x


# ---- the lane mirrors against the plain versions --------------------------

@pytest.mark.parametrize("autoreset", AUTO, ids=["auto", "noauto"])
@pytest.mark.parametrize("mix", MIXTURES.values(), ids=MIXTURES.keys())
def test_mixed_lane_mirror_equals_step_plain(mix, autoreset):
    cfgs = _cfgs(mix)
    codec = mg.build_codec(cfgs)
    st = _mixed_start(mix, len(mix) + int(100 * mix[-1][2]))
    assert int(rules.is_goal_state(torch, *st[:5], st.geo).sum()) > 0
    geo = st.geo
    boards = [(int(geo.H[i]), int(geo.W[i]), int(geo.glo[i]),
               int(geo.ghi[i])) for i in range(B)]
    seen = {"goal": 0, "truncated": 0}
    for aa, ab in _actions(len(mix), 2):
        new, (rew, goal, trunc), (obs, final) = mg.step_obs(codec, st, aa,
                                                            ab, autoreset)
        cols = [_bits(x) for x in (*new[:7], obs, final, rew, goal, trunc)]
        for i in range(B):
            want = _mixed_lane(boards[i], geo.slip[i].numpy(),
                               int(geo.vid[i]), codec,
                               [int(x[i]) for x in st[:7]],
                               [int(x) for x in st.key[i]], int(aa[i]),
                               int(ab[i]), autoreset)
            want = [*want[:9], np.float32(want[9]).view(np.int32),
                    *want[10:]]
            assert [int(c[i]) for c in cols] == [int(x) for x in want], i
        seen["goal"] += int(goal.sum())
        seen["truncated"] += int(trunc.sum())
        st = new
    assert seen["goal"] and seen["truncated"], seen


@pytest.mark.parametrize("autoreset", AUTO, ids=["auto", "noauto"])
@pytest.mark.parametrize("board", ALT_BOARDS.values(), ids=ALT_BOARDS.keys())
def test_alt_lane_mirror_equals_alt_step_plain(board, autoreset):
    cfg, st = _alt_start(board, board[0])
    r2d = alt.build_alt_tables(cfg).raw_to_dense
    isd = batch.device_maps(cfg, torch.device("cpu"))
    assert int(rules.is_goal_state(torch, *st[:5], cfg).sum()) > 0
    assert set(st.turn.tolist()) == {0, 1}
    seen = {"goal": 0, "truncated": 0}
    for (a,) in _actions(board[1], 1):
        new, (rew, goal, trunc), (obs, final) = alt.alt_step_obs(cfg, st, a,
                                                                 autoreset)
        cols = [_bits(x) for x in (*new[:8], obs, final, rew, goal, trunc)]
        for i in range(B):
            want = _alt_lane(cfg, r2d, isd, [int(x[i]) for x in st[:8]],
                             [int(x) for x in st.key[i]], int(a[i]),
                             autoreset)
            want = [*want[:10], np.float32(want[10]).view(np.int32),
                    *want[11:]]
            assert [int(c[i]) for c in cols] == [int(x) for x in want], i
        seen["goal"] += int(goal.sum())
        seen["truncated"] += int(trunc.sum())
        st = new
    assert seen["goal"] and seen["truncated"], seen


# ---- the per-lane thresholds ----------------------------------------------

@pytest.mark.parametrize("q,keep,first,rounded", [
    (0.058, 0x3F7126EA, 0x3F789375, (0x3F7126E9, 0x3F789375)),
    (0.111, 0x3F639581, 0x3F71CAC0, (0x3F639581, 0x3F71CAC1)),
    (0.2, 0x3F4CCCCD, 0x3F666666, (0x3F4CCCCD, 0x3F666666))])
def test_lane_thresholds_are_float32_operations(q, keep, first, rounded):
    """S2 compares with 1 - q and 1 - q * 0.5 computed on the lane's
    float32 slip, as step_plain does on a float32 tensor; at 0.058 and
    0.111 one of them differs from the float64 value rounded once (S1's
    ``slip_constants``, which S3 takes for its one board)."""
    q32 = torch.tensor([q], dtype=torch.float32)
    got = [int(np.float32(x).view(np.uint32))
           for x in _thresholds(q32.numpy()[0])]
    assert got == [keep, first]
    assert [int(x.numpy().view(np.uint32)[0])
            for x in (1.0 - q32, 1.0 - q32 * 0.5)] == [keep, first]
    assert tuple(int(np.float32(v).view(np.uint32))
                 for v in ek.slip_constants(q)[:2]) == rounded


# ---- autoreset, CPU dispatch and the JAX package --------------------------

@pytest.mark.parametrize("mix", MIXTURES.values(), ids=MIXTURES.keys())
def test_mixed_autoreset_is_step_then_reset_where(mix):
    """step_obs with autoreset is step_plain's autoreset, and the step
    without reset then ``reset_where`` on the ended lanes, with final_obs
    the global_obs of the state before the reset, as the learners took
    it; ``step`` on CPU tensors is step_plain and launches nothing."""
    codec = mg.build_codec(_cfgs(mix))
    st = _mixed_start(mix, 3)
    mk.reset_launch_counts()
    for aa, ab in list(_actions(7, 2))[:16]:
        new, out, (obs, final) = mg.step_obs(codec, st, aa, ab)
        mid, (r, g, t) = mg.step(st, aa, ab, autoreset=False)
        want = mg.reset_where(mid, g | t)
        auto, out2 = mg.step_plain(st, aa, ab)
        for a, b, c in zip(new, want, auto):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b) and torch.equal(a, c)
        assert all(torch.equal(x, y) for x, y in zip(out, (r, g, t)))
        assert all(torch.equal(x, y) for x, y in zip(out, out2))
        assert torch.equal(final, mg.global_obs(codec, mid))
        assert torch.equal(obs, mg.global_obs(codec, want))
        st = new
    assert mk.launch_counts == {"multigrid_step": 0, "alt_step": 0}


@pytest.mark.parametrize("board", ALT_BOARDS.values(), ids=ALT_BOARDS.keys())
def test_alt_autoreset_is_step_then_reset_where(board):
    cfg, st = _alt_start(board, 4)
    r2d = torch.as_tensor(alt.build_alt_tables(cfg).raw_to_dense).long()

    def dense(s):   # the turn-based learner's observation before S3
        return r2d[alt.alt_raw_encode(torch, s.rows_a, s.cols_a, s.rows_b,
                                      s.cols_b, s.poss, s.turn, cfg).long()]

    mk.reset_launch_counts()
    for (a,) in list(_actions(9, 1))[:16]:
        new, out, (obs, final) = alt.alt_step_obs(cfg, st, a)
        mid, (r, g, t) = alt.alt_step(cfg, st, a, autoreset=False)
        want = alt.alt_reset_where(cfg, mid, g | t)
        auto, out2 = alt.alt_step_plain(cfg, st, a)
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(new, want, auto))
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(out, (r, g, t), out2))
        assert torch.equal(final.long(), dense(mid))
        assert torch.equal(obs.long(), dense(want))
        assert final.dtype == obs.dtype == torch.int32
        st = new
    assert mk.launch_counts == {"multigrid_step": 0, "alt_step": 0}


def _jax_keys(st):
    return jax.random.wrap_key_data(st.key.numpy().astype(np.uint32))


@pytest.mark.parametrize("mix", [MIXTURES["5x4+11x7"],
                                 MIXTURES["slips-0.058-0.111"]],
                         ids=["5x4+11x7", "slips-0.058-0.111"])
def test_mixed_step_plain_equals_jax(mix):
    """The boards the bench mixture test of test_torch_batch_threefry.py
    does not run, at max_steps MAX_STEPS, autoreset on and off."""
    st = _mixed_start(mix, 11)
    jcfgs = [JaxConfig(width=w, height=h, slip_prob=q, max_steps=MAX_STEPS)
             for w, h, q in mix]
    geo = jmg.lane_geometry(jcfgs, B, max_steps=MAX_STEPS)
    jst = jmg.MultiGridState(*(jnp.asarray(f.numpy()) for f in st[:7]),
                             key=_jax_keys(st), geo=geo)
    for k, (aa, ab) in enumerate(list(_actions(12, 2))[:24]):
        auto = k % 3 != 2
        aa32, ab32 = aa.int().numpy(), ab.int().numpy()
        jst, jout = jmg.step(jst, jnp.asarray(aa32), jnp.asarray(ab32),
                             autoreset=auto)
        st, out = mg.step_plain(st, aa, ab, autoreset=auto)
        for a, b in zip((*st[:7], *out), (*jst[:7], *jout)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("board", ALT_BOARDS.values(), ids=ALT_BOARDS.keys())
def test_alt_step_plain_equals_jax(board):
    cfg, st = _alt_start(board, 13)
    jcfg = JaxConfig(width=board[0], height=board[1], slip_prob=board[2],
                     max_steps=MAX_STEPS)
    jst = jalt.AltEnvState(*(jnp.asarray(f.numpy()) for f in st[:8]),
                           key=_jax_keys(st))
    r2d, off = alt.build_alt_tables(cfg).raw_to_dense, 0
    for k, (a,) in enumerate(list(_actions(14, 1))[:24]):
        auto = k % 3 == 2
        jst, jout = jalt.alt_step(jcfg, jst, jnp.asarray(a.int().numpy()),
                                  autoreset=auto)
        st, out = alt.alt_step_plain(cfg, st, a, autoreset=auto)
        for x, y in zip((*st[:8], *out), (*jst[:8], *jout)):
            x, y = x.numpy(), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        # the observation as JAX's gather reads it, off-board lanes too
        raw = jalt.alt_raw_encode(jnp, *jst[:6], jcfg)
        assert np.array_equal(alt.alt_observe(cfg, st).numpy(), np.asarray(
            jnp.asarray(r2d)[raw]))
        off += int(((st.cols_a < 0) | (st.cols_a >= cfg.W) | (st.cols_b < 0)
                    | (st.cols_b >= cfg.W)).sum())
    assert off, "no lane left the board"


# ---- the wrappers' refusals and the C interface ---------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take():
    mix = MIXTURES["recipe"]
    st = _mixed_start(mix, 1)
    geo = st.geo
    planes = (geo.H, geo.W, geo.glo, geo.ghi, geo.vid, geo.slip)
    acts = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        mk.multigrid_step(st[:7], st.key, acts, acts, planes, 6, True)
    meta = st._replace(**{f: getattr(st, f).to("meta")
                          for f in st._fields[:8]},
                       geo=geo._replace(**{f: getattr(geo, f).to("meta")
                                           for f in geo._fields[:6]}))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mg.step(meta, acts.to("meta"), acts.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mg.step_obs(mg.build_codec(_cfgs(mix)), meta, acts.to("meta"),
                    acts.to("meta"))
    m = [f.to("meta") for f in st[:7]]
    mplanes = [p.to("meta") for p in planes]
    key, a = st.key.to("meta"), acts.to("meta")
    with pytest.raises(ValueError, match="key int64"):
        mk.multigrid_step(m, key.int(), a, a, mplanes, 6, True)
    with pytest.raises(ValueError, match="7 int32"):
        mk.multigrid_step(m[:6], key, a, a, mplanes, 6, True)
    with pytest.raises(ValueError, match="7 int32"):
        mk.multigrid_step([f.long() for f in m], key, a, a, mplanes, 6, True)
    with pytest.raises(ValueError, match="actions"):
        mk.multigrid_step(m, key, a[:3], a, mplanes, 6, True)
    with pytest.raises(ValueError, match="float32"):
        mk.multigrid_step(m, key, a, a, [*mplanes[:5], mplanes[5].double()],
                          6, True)
    with pytest.raises(ValueError, match="raw_to_dense"):
        mk.multigrid_step(m, key, a, a, mplanes, 6, True,
                          (torch.zeros(7, dtype=torch.int32, device="meta"),
                           torch.zeros(1, dtype=torch.int32, device="meta")))

    cfg, ast = _alt_start(ALT_BOARDS["5x4"], 2)
    maps = batch.device_maps(cfg, torch.device("cpu"))
    r2d = alt.alt_device_maps(cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        mk.alt_step(cfg, ast[:8], ast.key, acts, r2d, maps, True)
    ameta = alt.AltEnvState(*(f.to("meta") for f in ast))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        alt.alt_step(cfg, ameta, a)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        alt.alt_step_obs(cfg, ameta, a)
    am = list(ameta[:8])
    with pytest.raises(ValueError, match="8 int32"):
        mk.alt_step(cfg, am[:7], ameta.key, a, r2d.to("meta"), maps, True)
    with pytest.raises(ValueError, match="actions"):
        mk.alt_step(cfg, am, ameta.key, a[:5], r2d.to("meta"), maps, True)
    with pytest.raises(ValueError, match="raw_to_dense int32"):
        mk.alt_step(cfg, am, ameta.key, a, r2d.to("meta").long(), maps, True)


def _struct_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"(\w+)\s*(?:[,;])", body)


def test_c_interface_matches_the_kernel_source():
    """The .cu file's Params is S1's field for field (ops/engine_kernel.
    EngineParams; the library checks its size at load), the wrappers hand
    the C entries the pointers they read, and the library builds from the
    sources it shares with S1."""
    src = (_build.CSRC / "mixed_alt_kernel.cu").read_text()
    assert _struct_fields(src, "Params") == [n for n, _ in
                                             ek.EngineParams._fields_]
    assert f"ptrs[{mk.N_PTRS['multigrid_step'] - 1}]" in src
    for name, n in mk.N_PTRS.items():
        c_entry = src[src.index(f"int gst_{name}("):]
        assert f"ptrs: {n} device pointers" in src
        assert f"ptrs[{n - 1}]" in c_entry[:c_entry.index("\n}")]
    assert set(_build.LIBRARIES["mixed_alt_kernel"]) == {
        "mixed_alt_kernel.cu", "game.cuh", "threefry.cuh"}
    for name in ("multigrid_step_kernel", "alt_step_kernel"):
        assert name in src
    cfg = EnvConfig(width=11, height=7, slip_prob=0.111)
    maps = batch.device_maps(cfg, torch.device("cpu"))
    r2d = alt.alt_device_maps(cfg, torch.device("cpu"))
    prm = ek.params(cfg, len(r2d), maps.isd_fields.shape[0])
    assert (prm.H, prm.W, (prm.glo, prm.ghi), prm.max_steps, prm.nI) == (
        7, 13, cfg.goal_row_bounds, 100, 2)
    assert prm.n_raw == len(r2d) == 2 * cfg.n_raw
    assert (prm.keep, prm.first) == ek.slip_constants(0.111)[:2]
