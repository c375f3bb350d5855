"""Kernel S1 (the batched engine's step, ops/csrc/engine_kernel.cu) and T1's
keyed entry (ops/csrc/threefry_kernel.cu ``keyed_kernel``) on the CPU.

* Scalar Python mirrors of S1's lane program (the slot index counted
  from the float32 prefix sums of the four outcome weights with no slot
  stacking, the fourth uniform never drawn, the reset's draw at n + 1 on
  every lane, the products rounded in the kernel's order) against
  ``batch.step_plain``, lane by lane: 5x4 and 11x7, slip 0 and 0.2,
  autoreset on and off, threefry and counter, from states that hold
  goal-state lanes, with a max_steps of 6 so that truncation fires.  One
  mirror is the previous design (csrc/engine_prev_kernel.cu: the reset
  reads the ISD and a second observation after the draws), the other the
  kernel's order: both draws' first stages, then their second, one table
  read, the reset selected from ``batch.reset_table``.
* ``batch.reset_table`` against the JAX package's ISD and observations;
  the Reset struct, the C entry and the kernel's one read against the
  source; the variants' builds (ops/engine_variants) change one line.
* A mirror of the keyed kernel's element-to-thread mapping against
  ``jax.random`` at sizes that are no multiple of a block.
* ``step_plain`` against the JAX package's ``batch.step`` on the same
  cases; ``batch.step`` on CPU tensors is ``step_plain``.
* ``keyed_uniform`` / ``keyed_randint`` on CPU tensors against
  ``jax.random.uniform`` / ``randint`` of ``jax.random.fold_in``, at odd
  shapes and indices up to 2**31 - 1.
* The host constants: the slip thresholds' float32 bits, the geometry,
  and ``EngineParams`` against the kernel's ``Params``.

Every comparison is exact: every int, every bool and every float32 bit."""
import ctypes
import math
import operator
import os
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import batch as jbatch
from gym_soccer_tpu.core import rules as jrules
from gym_soccer_tpu.core import tables as jtables
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import batch, rules, threefry
from gym_soccer_tpu_torch.ops import _build
from gym_soccer_tpu_torch.ops import engine_kernel as ek
from gym_soccer_tpu_torch.ops import engine_variants as ev
from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
from gym_soccer_tpu_torch.ops import threefry_kernel as tk

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

M32 = 0xFFFFFFFF
B, MAX_STEPS, WARM, T = 48, 6, 8, 8
CASES = [(w, h, q, auto, rng) for w, h in ((5, 4), (11, 7))
         for q in (0.0, 0.2) for auto in (True, False)
         for rng in ("threefry", "counter")]
IDS = [f"{w}x{h}-slip{q}-{'auto' if a else 'noauto'}-{r}"
       for w, h, q, a, r in CASES]


# ---- the lane mirror ------------------------------------------------------

def _mul(a, b):
    """float32 product of two float32 values."""
    return float(np.float32(a) * np.float32(b))


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


def _to_uniform(bits):
    one = struct.unpack("<f", struct.pack("<I", (bits >> 9) | 0x3F800000))[0]
    return float(np.float32(one) - np.float32(1.0))


def _fmix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _draw(rng, kw0, kw1, n, count):
    """The kernel's ``draw<RNG, count>``: uniforms 0 .. count-1 at n."""
    if rng == "threefry":
        k0, k1 = _threefry2x32(kw0, kw1, 0, n)
        return [_to_uniform(x0 ^ x1) for w in range(count)
                for x0, x1 in [_threefry2x32(k0, k1, 0, w)]]
    base2 = _fmix32(kw1 ^ 0x3C6EF372)
    out = []
    for w in range(count):
        c = (n * 0x85EBCA77 + w * 0xC2B2AE3D) & M32
        bits = _fmix32((_fmix32(kw0 ^ c) + (c ^ base2)) & M32)
        out.append(float(np.float32(bits >> 8) * np.float32(2.0 ** -24)))
    return out


def _wrap32(x):
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _step(cfg, consts, r2d, f, aa, ab, u):
    """The step both of S1's designs take for one lane on the uniforms
    u[0..2]: (new (ra, ca, rb, cb, p), now a goal, reward, prob, t + 1,
    truncated, final_obs)."""
    keep, first, slip = consts
    W, H = cfg.W, cfg.H
    lo, hi = cfg.goal_row_bounds
    xa, ya, xb, yb, p, t = f

    def variant(x):
        return 0 if x < keep else (1 if x < first else 2)

    def move(a, v):
        mc0, mr0 = (a == 3) - (a == 4), (a == 2) - (a == 1)
        if v == 0:
            return mc0, mr0
        return (-mr0, mc0) if v == 1 else (mr0, -mc0)

    def rows(x):
        return lo <= x <= hi

    def nxt(x, y, mc, mr, ball):
        nx = min(max(x + mr, 0), H - 1)
        ny = y + mc
        xoob = ny in (0, W - 1)
        return nx, (y if xoob and not (rows(nx) and ball) else ny)

    va, vb = variant(u[0]), variant(u[1])
    nxa, nya = nxt(xa, ya, *move(aa, va), p == 0)
    nxb, nyb = nxt(xb, yb, *move(ab, vb), p == 1)
    c1 = (xa == xb and abs(ya - yb) == 1 and nya == yb and nyb == ya) or \
         (ya == yb and abs(xa - xb) == 1 and nxa == xb and nxb == xa)
    c2 = not c1 and ((nxa == xb and nya == yb and ab == 0) or
                     (nxb == xa and nyb == ya and aa == 0))
    c3 = not c1 and not c2 and (
        (xa == nxa and ya == nya and aa != 0 and nxb == xa and nyb == ya) or
        (xb == nxb and yb == nyb and ab != 0 and nxa == xb and nya == yb))
    c4 = not (c1 or c2 or c3) and nxa == nxb and nya == nyb
    c5 = not (c1 or c2 or c3 or c4)
    was = _goal(cfg, xa, ya, xb, yb, p)
    w = [0.5 if c1 or c3 else (0.25 if c4 else 1.0),
         0.25 if c4 else (0.5 if c1 or c3 else 0.0), 0.25 if c4 else 0.0]
    if was:
        w = [1.0, 0.0, 0.0]
    sums = np.cumsum(np.float32([w[0], w[1], w[2], w[2]]), dtype=np.float32)
    k = min(int(sum(float(s) <= u[2] for s in sums)), 3)
    if k == 0:
        new = (nxa if c5 else xa, nya if c5 else ya,
               nxb if c4 or c5 else xb, nyb if c4 or c5 else yb,
               1 - p if c2 else (p if c5 else 0))
    elif k == 1:
        new = (xa, ya, nxb if c4 else xb, nyb if c4 else yb, 1)
    else:
        new = (nxa, nya, xb, yb, 0 if k == 2 else 1)
    if was:
        new = (xa, ya, xb, yb, p)
    now = _goal(cfg, *new)
    pv = [keep if v == 0 else slip for v in (va, vb)]
    prob = _mul(_mul(pv[0], pv[1]), 1.0 if was else w[min(k, 2)])
    ball = new[1] if new[4] == 0 else new[3]
    reward = (1.0 if ball == W - 1 else -1.0) if now and not was else 0.0
    t1 = _wrap32(t + 1)
    return (new, now, reward, prob, t1, t1 >= cfg.max_steps,
            _dense(cfg, r2d, *new))


def _goal(cfg, xa, ya, xb, yb, p):
    lo, hi = cfg.goal_row_bounds
    return (p == 0 and lo <= xa <= hi and ya in (0, cfg.W - 1)) or \
        (p == 1 and lo <= xb <= hi and yb in (0, cfg.W - 1))


def _dense(cfg, r2d, xa, ya, xb, yb, p):
    raw = (((xa * cfg.W + ya) * cfg.H + xb) * cfg.W + yb) * 2 + p
    return int(r2d[raw + (len(r2d) if raw < 0 else 0)])


def _lane(cfg, consts, maps, f, kw, aa, ab, autoreset, rng):
    """S1's previous program for one lane (csrc/engine_prev_kernel.cu):
    (ra, ca, rb, cb, p, t, n, obs, final_obs, reward, prob, done,
    truncated); the reset's thresholds, entry and observation read from
    ``maps`` after the draws."""
    *s, n = f
    n &= M32
    u = _draw(rng, kw[0], kw[1], n, 3)
    new, now, reward, prob, t1, trunc, final = _step(
        cfg, consts, maps.raw_to_dense, s, aa, ab, u)
    t_out, n_out = t1, n + 1
    if autoreset:
        ur = _draw(rng, kw[0], kw[1], (n + 1) & M32, 1)[0]
        cum = maps.isd_cum.numpy()
        idx = min(max(int(sum(float(c) <= ur for c in cum)), 0),
                  len(cum) - 1)
        n_out = n + 2
        if now or trunc:
            new = tuple(int(x) for x in maps.isd_fields[idx])
            t_out = 0
    return (*new, t_out, _wrap32(n_out),
            _dense(cfg, maps.raw_to_dense, *new) if autoreset else final,
            final, reward, prob, now, trunc)


def _counter_word(n, w):
    return (n * 0x85EBCA77 + w * 0xC2B2AE3D) & M32


def _counter_uniform(bits):
    return float(np.float32(bits >> 8) * np.float32(2.0 ** -24))


def _draws_in_stages(rng, kw0, kw1, n, autoreset):
    """The kernel's ``draw_first`` then ``draw_second``: the first stages
    of both draws (threefry's fold_in(key, n) and fold_in(key, n + 1); the
    counter hash's inner finalizers of words 0..2 at n and word 0 at
    n + 1), then their second: (u[0..2], the reset's ur or None)."""
    m = (n + 1) & M32
    if rng == "threefry":
        d = [*_threefry2x32(kw0, kw1, 0, n),
             *(_threefry2x32(kw0, kw1, 0, m) if autoreset else ())]
        u = [_to_uniform(x0 ^ x1) for w in range(3)
             for x0, x1 in [_threefry2x32(d[0], d[1], 0, w)]]
        ur = (_to_uniform(operator.xor(*_threefry2x32(d[2], d[3], 0, 0)))
              if autoreset else None)
        return u, ur
    d = [_fmix32(kw0 ^ _counter_word(n, w)) for w in range(3)]
    if autoreset:
        d.append(_fmix32(kw0 ^ _counter_word(m, 0)))
    base2 = _fmix32(kw1 ^ 0x3C6EF372)
    u = [_counter_uniform(_fmix32((d[w] + (_counter_word(n, w) ^ base2))
                                  & M32)) for w in range(3)]
    ur = (_counter_uniform(_fmix32((d[3] + (_counter_word(m, 0) ^ base2))
                                   & M32)) if autoreset else None)
    return u, ur


def _lane_ahead(cfg, consts, r2d, reset, f, kw, aa, ab, autoreset, rng):
    """S1's program in the kernel's order for one lane: both draws' first
    stages, then their second, the step and its one table read
    (final_obs); the reset's entry and observation selected from the
    host's table (``batch.reset_table``, thresholds +inf past its
    entries); obs = final_obs on a lane that did not reset."""
    *s, n = f
    n &= M32
    u, ur = _draws_in_stages(rng, kw[0], kw[1], n, autoreset)
    new, now, reward, prob, t1, trunc, final = _step(cfg, consts, r2d, s,
                                                     aa, ab, u)
    obs, t_out, n_out = final, t1, n + 1
    if autoreset:
        cum = [*reset.cum, *[math.inf] * (ek.MAX_ISD - len(reset.cum))]
        idx = max(min(sum(c <= ur for c in cum), len(reset.fields) - 1), 0)
        n_out = n + 2
        if now or trunc:
            new, t_out, obs = reset.fields[idx], 0, reset.obs[idx]
    return (*new, t_out, _wrap32(n_out), obs, final, reward, prob, now,
            trunc)


def _bits(x):
    x = x.numpy()
    return x.view(np.int32) if x.dtype == np.float32 else x


def _rows(st, out):
    """The step's outputs in the mirror's order, as numpy columns."""
    return [_bits(x) for x in (*st[:7], out.obs, out.final_obs,
                               out.reward_a, out.prob, out.done,
                               out.truncated)]


def _start(cfg, rng, seed):
    """B lanes after WARM steps without autoreset from random keys (lanes
    that scored stay in their goal states), n moved to 2**31 - 3 on some
    lanes so the counter wraps, t on others near max_steps."""
    words = np.random.default_rng(seed).integers(0, 2 ** 32, (B, 2),
                                                 dtype=np.uint64)
    st = batch.init_from_keys(cfg, words, "cpu", rng=rng)
    acts = np.random.default_rng(seed + 1).integers(0, 5, (WARM, 2, B))
    for aa, ab in acts:
        st, _ = batch.step_plain(cfg, st, torch.as_tensor(aa),
                                 torch.as_tensor(ab), autoreset=False,
                                 rng=rng)
    n = st.n.clone()
    n[::5] = 2 ** 31 - 3
    t = st.t.clone()
    t[1::7] = MAX_STEPS - 1
    return st._replace(t=t % MAX_STEPS, n=n)


def _cfg(w, h, q):
    return EnvConfig(width=w, height=h, slip_prob=q, max_steps=MAX_STEPS)


def _actions(seed):
    rng = np.random.default_rng(seed)
    for s in range(T):
        dtype = np.int64 if s % 2 else np.int32
        yield (torch.as_tensor(rng.integers(0, 5, B).astype(dtype)),
               torch.as_tensor(rng.integers(0, 5, B).astype(dtype)))


@pytest.mark.parametrize("w,h,q,autoreset,rng", CASES, ids=IDS)
def test_lane_mirror_equals_step_plain(w, h, q, autoreset, rng):
    cfg = _cfg(w, h, q)
    maps = batch.device_maps(cfg, torch.device("cpu"))
    consts = ek.slip_constants(q)
    st = _start(cfg, rng, 5 + w + int(10 * q))
    goals = int(rules.is_goal_state(torch, *st[:5], cfg).sum())
    assert goals > 0, "no lane starts in a goal state"
    seen = {"done": 0, "truncated": 0}
    for aa, ab in _actions(w):
        new, out = batch.step_plain(cfg, st, aa, ab, autoreset, rng)
        cols = _rows(new, out)
        for i in range(B):
            want = _lane(cfg, consts, maps, [int(x[i]) for x in st[:7]],
                         [int(x) for x in st.key[i]], int(aa[i]),
                         int(ab[i]), autoreset, rng)
            got = [c[i] for c in cols]
            want = [*want[:9],
                    np.float32(want[9]).view(np.int32),
                    np.float32(want[10]).view(np.int32), *want[11:]]
            assert [int(x) for x in got] == [int(x) for x in want], i
        seen["done"] += int(out.done.sum())
        seen["truncated"] += int(out.truncated.sum())
        st = new
    assert seen["done"] and seen["truncated"], seen


@pytest.mark.parametrize("w,h,q,autoreset,rng", CASES, ids=IDS)
def test_lane_in_kernel_order_equals_step_plain(w, h, q, autoreset, rng):
    """S1's order (both draws' first stages, then their second, the step
    and its one table read; the reset's entry and observation selected
    from ``batch.reset_table``) gives step_plain's every output lane by
    lane, from goal-state, wrapping and truncating lanes."""
    cfg = _cfg(w, h, q)
    r2d = batch.device_maps(cfg, torch.device("cpu")).raw_to_dense
    reset = batch.reset_table(cfg)
    consts = ek.slip_constants(q)
    st = _start(cfg, rng, 7 + w + int(10 * q))
    resets = 0
    for aa, ab in _actions(w + 1):
        new, out = batch.step_plain(cfg, st, aa, ab, autoreset, rng)
        cols = _rows(new, out)
        for i in range(B):
            want = _lane_ahead(cfg, consts, r2d, reset,
                               [int(x[i]) for x in st[:7]],
                               [int(x) for x in st.key[i]], int(aa[i]),
                               int(ab[i]), autoreset, rng)
            want = [*want[:9], np.float32(want[9]).view(np.int32),
                    np.float32(want[10]).view(np.int32), *want[11:]]
            assert [int(c[i]) for c in cols] == [int(x) for x in want], i
        resets += int((out.done | out.truncated).sum())
        st = new
    assert resets > 0


# ---- step_plain against the JAX package -----------------------------------

def _jax_state(st):
    return jbatch.EnvState(
        *(jnp.asarray(f.numpy()) for f in st[:7]),
        key=jax.random.wrap_key_data(st.key.numpy().astype(np.uint32)))


@pytest.mark.parametrize("w,h,q,autoreset,rng", CASES, ids=IDS)
def test_step_plain_equals_jax(w, h, q, autoreset, rng):
    cfg = _cfg(w, h, q)
    jcfg = JaxConfig(width=w, height=h, slip_prob=q, max_steps=MAX_STEPS)
    st = _start(cfg, rng, 3 + w)
    jst = _jax_state(st)
    jstep = jax.jit(lambda s, a, b: jbatch.step(jcfg, s, a, b,
                                                autoreset=autoreset,
                                                rng=rng))
    for aa, ab in _actions(h):
        jst, jout = jstep(jst, jnp.asarray(aa.numpy().astype(np.int32)),
                          jnp.asarray(ab.numpy().astype(np.int32)))
        st, out = batch.step_plain(cfg, st, aa, ab, autoreset, rng)
        for name in jbatch.StepOut._fields:
            a, b = getattr(out, name).numpy(), np.asarray(getattr(jout, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name, a, b in zip(jbatch.EnvState._fields[:7], st, jst):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert np.array_equal(st.key.numpy(), np.asarray(
        jax.random.key_data(jst.key)).astype(np.int64))


def test_step_on_cpu_tensors_is_step_plain():
    cfg = _cfg(5, 4, 0.2)
    for rng in ("threefry", "counter"):
        st = _start(cfg, rng, 1)
        for aa, ab in _actions(2):
            a_st, a_out = batch.step(cfg, st, aa, ab, rng=rng)
            p_st, p_out = batch.step_plain(cfg, st, aa, ab, rng=rng)
            assert all(torch.equal(x, y) for x, y in
                       zip((*a_st, *a_out), (*p_st, *p_out)))
            st = a_st
    ek.reset_launch_counts()
    assert ek.launch_counts == {"engine_step": 0}


def test_engine_step_refuses_what_the_kernel_does_not_take():
    cfg = _cfg(5, 4, 0.2)
    st = _start(cfg, "threefry", 2)
    maps = batch.device_maps(cfg, torch.device("cpu"))
    aa = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ek.engine_step(cfg, st[:7], st.key, aa, aa, maps, True, "threefry")
    meta = batch.EnvState(*(f.to("meta") for f in st))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        batch.step(cfg, meta, aa.to("meta"), aa.to("meta"))
    with pytest.raises(ValueError, match="unknown rng"):
        batch.step_plain(cfg, st, aa, aa, rng="x")


# ---- T1's keyed entry -----------------------------------------------------

SHAPES = [(3,), (2, 7), (5, 1, 3), 1, (2, 1024)]
INDICES = [0, 1, 37, 2 ** 31 - 1]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("i", INDICES)
def test_keyed_uniform_equals_jax(shape, i):
    jk = jax.random.fold_in(jax.random.key(11), i)
    want = np.asarray(jax.random.uniform(jk, shape))
    tk.reset_launch_counts()
    got = tk.keyed_uniform(threefry.key(11), i, shape)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, tk.keyed_uniform_plain(threefry.key(11), i,
                                                   shape))
    assert tk.launch_counts["threefry_keyed"] == 0   # the CPU: no kernel


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("lo,hi", [(0, 5), (-3, 100_000), (4, 4)])
def test_keyed_randint_equals_jax(shape, lo, hi):
    for i in (0, 2 ** 31 - 1):
        jk = jax.random.fold_in(jax.random.key(12), i)
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = tk.keyed_randint(threefry.key(12), i, shape, lo, hi)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_keyed_entry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="one key"):
        tk.keyed_uniform(threefry.key([1, 2]), 0, 4)
    with pytest.raises(ValueError, match="one key"):
        tk.keyed_randint(threefry.key(1).int(), 0, 4, 0, 5)
    with pytest.raises(ValueError, match="must be int32"):
        tk.keyed_randint(threefry.key(1), 0, 4, 0, 2 ** 31)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tk._launch_keyed(threefry.key(1), 0, 4, None)


def test_random_policy_fn_draws_through_the_keyed_entry():
    """``random_policy_fn``'s actions are keyed_randint's, JAX's bits."""
    jcfg, cfg = JaxConfig(5, 4, 0.2), EnvConfig(5, 4, 0.2)
    jpol = jbatch.random_policy_fn(jcfg, jax.random.key(1), 33)
    pol = batch.random_policy_fn(cfg, threefry.key(1), 33)
    obs = torch.zeros(33, dtype=torch.int32)
    for i in (0, 5, 2 ** 31 - 1):
        want = jpol(jnp.zeros(33, jnp.int32), i)
        got = pol(obs, i)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))


# ---- host constants -------------------------------------------------------

@pytest.mark.parametrize("q,bits", [
    (0.0, (0x3F800000, 0x3F800000, 0x00000000)),
    (0.2, (0x3F4CCCCD, 0x3F666666, 0x3DCCCCCD)),
    (0.1, (0x3F666666, 0x3F733333, 0x3D4CCCCD)),
    (1 / 3, (0x3F2AAAAB, 0x3F555555, 0x3E2AAAAB))])
def test_slip_constants_are_pinned(q, bits):
    """The float32 bits of f32(1 - q), f32(1 - q / 2) and f32(q / 2), the
    values step_plain compares u with and multiplies prob by."""
    got = ek.slip_constants(q)
    assert tuple(int(np.float32(v).view(np.uint32)) for v in got) == bits
    assert got == (batch._f32(1.0 - q), batch._f32(1.0 - q * 0.5),
                   batch._f32(q * 0.5))


@pytest.mark.parametrize("w,h", [(5, 4), (11, 7), (6, 5)])
def test_engine_params_hold_the_board(w, h):
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    maps = batch.device_maps(cfg, torch.device("cpu"))
    prm = ek.board_args(cfg, maps.raw_to_dense.shape[0])[0]
    assert (prm.H, prm.W, (prm.glo, prm.ghi), prm.max_steps) == (
        cfg.H, cfg.W, cfg.goal_row_bounds, cfg.max_steps)
    assert prm.n_raw == (cfg.W * cfg.H) ** 2 * 2
    assert prm.nI == len(maps.isd_cum) == (4 if h % 2 == 0 else 2)
    assert (prm.keep, prm.first, prm.slip) == ek.slip_constants(0.2)


def _struct_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"(\w+)\s*(?:[,;])", body)


def test_engine_params_match_the_kernel_struct():
    """EngineParams is csrc/engine_kernel.cu's Params field for field (the
    library checks its size at load), and the wrapper hands the kernel
    the pointers its C entry reads, in order."""
    src = (_build.CSRC / "engine_kernel.cu").read_text()
    assert _struct_fields(src, "Params") == [n for n, _ in
                                             ek.EngineParams._fields_]
    assert [t.__name__ for _, t in ek.EngineParams._fields_] == \
        ["c_int"] * 7 + ["c_float"] * 3
    assert f"ptrs[{ek.N_PTRS - 1}]" in src
    assert "threefry.cuh" in src and "game.cuh" in src
    assert set(_build.LIBRARIES["engine_kernel"]) == {
        "engine_kernel.cu", "game.cuh", "threefry.cuh"}
    assert "threefry.cuh" in _build.LIBRARIES["threefry_kernel"]
    assert ek.RNG_IDS == {"threefry": 0, "counter": 1}
    assert "kThreefry = 0, kCounter = 1" in src


# ---- the host's reset table ------------------------------------------------

@pytest.mark.parametrize("w,h", [(5, 4), (11, 7), (6, 5)])
def test_reset_table_is_the_jax_isd_and_its_observations(w, h):
    """``batch.reset_table``, which S1's reset selects from in its launch's
    arguments: the JAX package's ISD (``build_statespace``'s isd_raw,
    decoded, and the float32 cumulative sums of its isd_probs) and each
    entry's dense observation from the JAX package's raw_to_dense; the
    kernel's struct holds them, +inf past the last threshold."""
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    ss = jtables.build_statespace(JaxConfig(width=w, height=h,
                                            slip_prob=0.2))
    reset = batch.reset_table(cfg)
    raw = np.asarray(ss.isd_raw)
    fields = np.stack(jrules.raw_decode(np, raw, ss.cfg), axis=-1)
    assert reset.fields == tuple(tuple(int(x) for x in f) for f in fields)
    cum = np.cumsum(np.asarray(ss.isd_probs)).astype(np.float32)
    assert np.array_equal(np.float32(reset.cum).view(np.int32),
                          cum.view(np.int32))
    assert reset.obs == tuple(int(x) for x in
                              np.asarray(ss.raw_to_dense)[raw])
    assert len(reset.fields) == (4 if h % 2 == 0 else 2)
    maps = batch.device_maps(cfg, torch.device("cpu"))
    assert reset.fields == tuple(tuple(f) for f in maps.isd_fields.tolist())
    prm, rst = ek.board_args(cfg, maps.raw_to_dense.shape[0])
    n = len(reset.fields)
    assert prm.nI == n
    assert [list(rst.isd[k]) for k in range(n)] == [list(f) for f in fields]
    assert list(rst.cum) == [*reset.cum, *[math.inf] * (ek.MAX_ISD - n)]
    assert list(rst.obs)[:n] == list(reset.obs)
    assert batch.reset_table(cfg) is reset   # cached once a configuration


def test_reset_struct_refuses_what_the_kernel_does_not_take():
    reset = batch.reset_table(_cfg(5, 4, 0.2))
    five = reset._replace(fields=reset.fields + reset.fields[:1],
                          cum=reset.cum + (1.0,), obs=reset.obs + (0,))
    for bad in (reset._replace(fields=(), cum=(), obs=()), five,
                reset._replace(obs=reset.obs[:1]),
                reset._replace(fields=((1, 2, 3),) * len(reset.fields))):
        with pytest.raises(ValueError, match="engine_step: 1 to 4 ISD"):
            ek.reset_struct(bad)


def test_reset_struct_matches_the_kernel_source():
    """csrc/engine_kernel.cu's Reset is EngineReset field for field (the
    library checks its size at load), the same layout as S3's AltReset,
    whose host struct is the same class; the C entry takes it after the
    Params and reads no ISD table."""
    src = (_build.CSRC / "engine_kernel.cu").read_text()
    body = re.search(r"struct Reset \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+)((?:\[[^\]]*\])+);", body) == [
        ("isd", "[gst::kMaxIsd][5]"), ("cum", "[gst::kMaxIsd]"),
        ("obs", "[gst::kMaxIsd]")]
    assert [n for n, _ in ek.EngineReset._fields_] == ["isd", "cum", "obs"]
    assert ctypes.sizeof(ek.EngineReset) == 4 * (5 + 1 + 1) * ek.MAX_ISD
    assert f"constexpr int kMaxIsd = {ek.MAX_ISD};" in (
        _build.CSRC / "game.cuh").read_text()
    assert mk.AltReset is ek.EngineReset
    assert _c_params(src, "gst_engine_step") == [
        "int device", "void* const* ptrs", "const void* params",
        "const void* reset", "int lanes", "int rng", "int autoreset",
        "int act64", "void* stream"]
    lib = _FakeLib()
    ek.declare(lib)
    assert len(lib.gst_engine_step.argtypes) == len(
        _c_params(src, "gst_engine_step"))
    kernel = src[src.index("engine_step_kernel(Args a)"):]
    kernel = kernel[:kernel.index("\n}\n")]
    # after the draws, one table read (final_obs); the ISD from the Reset
    assert kernel.count("dense(a, s)") == 1
    assert "isd_cum" not in src and "isd_fields" not in src
    assert kernel.index("draw_first<") < kernel.index("draw_second<")
    assert src.index("gst::fold_in(d[0], d[1], n)") < src.index(
        "gst::random_bits(d[0], d[1]")


# ---- the designs' builds ---------------------------------------------------

def _c_params(src, entry):
    sig = re.search(r"\b%s\((.*?)\)\s*\{" % entry, src, re.S).group(1)
    return [p.strip() for p in sig.split(",")]


class _FakeLib:
    """Stands in for a loaded library: each attribute a bare function
    object that a declaration can give argtypes and restype."""

    def __getattr__(self, name):
        fn = type("CFunction", (), {})()
        object.__setattr__(self, name, fn)
        return fn


def _diff(a, b):
    return [(x, y) for x, y in zip(a.splitlines(), b.splitlines()) if x != y]


@pytest.mark.parametrize("threads", ev.SHAPES)
def test_s1_shape_builds_change_the_lanes_a_block_alone(threads):
    """Each lanes-a-block shape engine_variants times is S1's source with
    its kThreads line set to the shape and nothing else changed; the
    wrapper's shape is the source itself."""
    src = (_build.CSRC / ev.KERNEL_SOURCE).read_text()
    text = ev.shape_source(threads)
    assert len(src.splitlines()) == len(text.splitlines())
    if threads == ek.LANES_PER_BLOCK:
        assert text == src
    else:
        lines = [ev.THREADS_LINE.format(n)
                 for n in (ek.LANES_PER_BLOCK, threads)]
        assert _diff(src, text) == [tuple(lines)]
    assert text.count("__launch_bounds__(kThreads)") == 1
    assert text.count("<<<blocks, kThreads, 0, s>>>") == 2


def test_variants_name_their_builds_and_refuse_the_cpu():
    """The builds engine_variants makes: S1's previous design, the empty
    kernel and S1 at each other of its shapes; each design's floor is the
    empty kernel at its threads a block; the launchers refuse CPU tensors
    before any build, and a source whose line is not the wrapper's."""
    assert ev.SHAPES == (32, 64, 128, 256) and ek.LANES_PER_BLOCK in ev.SHAPES
    assert len(ev.builders()) == 2 + 3
    assert ev.designs() == [f"kernel, {s} lanes a block" for s in ev.SHAPES
                            if s != ek.LANES_PER_BLOCK] + [ev.PREVIOUS]
    assert ev.floor_name("kernel") == \
        f"floor, {ek.LANES_PER_BLOCK} threads a block"
    assert ev.floor_name(ev.PREVIOUS) == ev.floor_name("keyed") == \
        "floor, 256 threads a block"
    assert ev.floor_name("kernel, 64 lanes a block") == \
        "floor, 64 threads a block"
    assert (_build.CSRC / ev.PREV_SOURCE).is_file()
    assert not any(ev.PREV_SOURCE in files
                   for files in _build.LIBRARIES.values())
    prev = (_build.CSRC / ev.PREV_SOURCE).read_text()
    assert "constexpr int kThreads = 256;" in prev and "isd_cum" in prev
    cfg = _cfg(5, 4, 0.2)
    st = _start(cfg, "threefry", 3)
    aa = torch.zeros(B, dtype=torch.int64)
    for design in ev.designs():
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            ev.engine_step_on(design, cfg, st, aa, aa, True, "threefry")
    orig = ek.LANES_PER_BLOCK
    try:
        ek.LANES_PER_BLOCK = 96
        with pytest.raises(ValueError, match="no line"):
            ev.shape_source(32)
    finally:
        ek.LANES_PER_BLOCK = orig


def test_variant_cases_are_the_callers_widths():
    """S1 at the entry point's 8192 lanes (threefry), greedy_win_share's
    2048 (counter), eval_episode_stats' 1024 and the learning checks' 512;
    the keyed entry at the evaluation's 2 x 1024 and at 2 x 8192; on the
    CPU every case's kernel call is its plain version."""
    assert {c[2] for c in ev.CASES.values() if c[0] == "engine_step"} == {
        8192, 2048, 1024, 512}
    assert [c[1] for c in ev.CASES.values() if c[0] == "engine_step"] == [
        "threefry", "counter", "threefry", "threefry"]
    assert [c[2] for c in ev.CASES.values() if c[0] == "keyed"] == [
        (2, 1024), (2, 8192)]
    for case in ("S1 512 lanes, threefry (learning checks)",
                 "keyed 2 x 1024 (evaluation draw)"):
        calls = ev.case_calls(case, torch.device("cpu"))
        ours = "kernel" if case.startswith("S1") else "keyed"
        assert all(torch.equal(a, b) for a, b in zip(
            ev.outputs(calls[ours]()), ev.outputs(calls["plain"]()),
            strict=True))
        assert {ev.floor_name(n) for n in calls
                if not n.startswith("floor") and n != "plain"} == {
            n for n in calls if n.startswith("floor")}


# ---- the keyed entry's element-to-thread mapping ----------------------------

def _keyed_mirror(kw, i, numel, threads, randint=None):
    """The keyed kernel's program in a grid of ceil(numel / threads)
    blocks: thread t of block b takes element b * threads + t, if below
    numel, and repeats the fold_in (and the split) for it; the elements no
    thread writes stay -1."""
    out = np.full(numel, -1, dtype=np.int64)
    for blk in range(-(-numel // threads)):
        for th in range(threads):
            j = blk * threads + th
            if j >= numel:
                continue
            k = _threefry2x32(kw[0], kw[1], 0, i & M32)
            if randint is None:
                x0, x1 = _threefry2x32(*k, 0, j)
                out[j] = int(np.float32(_to_uniform(x0 ^ x1)).view(np.int32))
            else:
                minval, span, mult = randint
                a, b = _threefry2x32(*k, 0, 0), _threefry2x32(*k, 0, 1)
                hi = operator.xor(*_threefry2x32(*a, 0, j))
                lo = operator.xor(*_threefry2x32(*b, 0, j))
                off = ((hi % span) * mult + lo % span) % span & M32
                out[j] = _wrap32(minval + off)
    return out


@pytest.mark.parametrize("i", INDICES)
@pytest.mark.parametrize("shape", [(7,), (2, 13), (3, 5, 7), (2, 300)],
                         ids=str)
def test_keyed_mapping_equals_jax(shape, i):
    """The keyed kernel's element-to-thread mapping, one element a thread
    in blocks of ``threefry_kernel.LANES_PER_BLOCK`` (no size here a
    multiple of a block), writes every element once, equal to
    ``jax.random.uniform`` and ``randint`` of ``fold_in``."""
    numel = math.prod(shape)
    threads = tk.LANES_PER_BLOCK
    assert numel % threads != 0
    kw = [int(x) for x in threefry.key(13)]
    jk = jax.random.fold_in(jax.random.key(13), i)
    want_u = np.asarray(jax.random.uniform(jk, shape)).reshape(-1)
    got_u = _keyed_mirror(kw, i, numel, threads)
    assert np.array_equal(got_u.astype(np.int32), want_u.view(np.int32))
    lo, hi = -3, 100_000
    want_r = np.asarray(jax.random.randint(jk, shape, lo, hi)).reshape(-1)
    got_r = _keyed_mirror(kw, i, numel, threads,
                          (lo & M32, *threefry.randint_span(lo, hi)))
    assert np.array_equal(got_r, want_r.astype(np.int64))
