"""Kernel S1 (the batched engine's step, ops/csrc/engine_kernel.cu) and T1's
keyed entry (ops/csrc/threefry_kernel.cu ``keyed_kernel``) on the CPU.

* A scalar Python mirror of S1's lane program (the slot index counted
  from the float32 prefix sums of the four outcome weights with no slot
  stacking, the fourth uniform never drawn, the reset's draw at n + 1 on
  every lane, the products rounded in the kernel's order) against
  ``batch.step_plain``, lane by lane: 5x4 and 11x7, slip 0 and 0.2,
  autoreset on and off, threefry and counter, from states that hold
  goal-state lanes, with a max_steps of 6 so that truncation fires.
* ``step_plain`` against the JAX package's ``batch.step`` on the same
  cases; ``batch.step`` on CPU tensors is ``step_plain``.
* ``keyed_uniform`` / ``keyed_randint`` on CPU tensors against
  ``jax.random.uniform`` / ``randint`` of ``jax.random.fold_in``, at odd
  shapes and indices up to 2**31 - 1.
* The host constants: the slip thresholds' float32 bits, the geometry,
  and ``EngineParams`` against the kernel's ``Params``.

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
from gym_soccer_tpu.core import batch as jbatch
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import batch, rules, threefry
from gym_soccer_tpu_torch.ops import _build
from gym_soccer_tpu_torch.ops import engine_kernel as ek
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


def _lane(cfg, consts, maps, f, kw, aa, ab, autoreset, rng):
    """S1's program for one lane: (ra, ca, rb, cb, p, t, n, obs, final_obs,
    reward, prob, done, truncated)."""
    keep, first, slip = consts
    W, H = cfg.W, cfg.H
    lo, hi = cfg.goal_row_bounds
    xa, ya, xb, yb, p, t, n = f
    n &= M32
    u = _draw(rng, kw[0], kw[1], n, 3)

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

    def goal(xa, ya, xb, yb, p):
        return (p == 0 and rows(xa) and ya in (0, W - 1)) or \
            (p == 1 and rows(xb) and yb in (0, W - 1))

    def dense(xa, ya, xb, yb, p):
        raw = (((xa * W + ya) * H + xb) * W + yb) * 2 + p
        return int(maps.raw_to_dense[raw + (len(maps.raw_to_dense)
                                            if raw < 0 else 0)])

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
    was = goal(xa, ya, xb, yb, p)
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
    now = goal(*new)
    pv = [keep if v == 0 else slip for v in (va, vb)]
    prob = _mul(_mul(pv[0], pv[1]), 1.0 if was else w[min(k, 2)])
    ball = new[1] if new[4] == 0 else new[3]
    reward = (1.0 if ball == W - 1 else -1.0) if now and not was else 0.0
    t1 = _wrap32(t + 1)
    trunc = t1 >= cfg.max_steps
    final = dense(*new)
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
            dense(*new) if autoreset else final, final, reward, prob, now,
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
    prm = ek.params(cfg, maps.raw_to_dense.shape[0],
                    maps.isd_fields.shape[0])
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
