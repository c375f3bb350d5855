"""Time variants of the RM+ solve kernel R1 on a CUDA card.

Each variant is ``csrc/rmplus_kernel.cu`` with a few text patches
(`VARIANTS`), built beside the port's own build and launched through
``agents.learners.solve_matrix_games`` at the shapes its callers give it:
the 5x4 contract's re-solve (761 games x 400 iterations) and final solve
(x 3000), the ``--multigrid`` recipe's (2502 x 200) and the 11x7
contract's (11705 x 600), on random games from a numpy seed.  Design
variants (another block size; every share by __fdiv_rn, zero regrets too,
R1's first build; the shares from an approximate reciprocal checked by
their exact remainders, with a __fdiv_rn or a float64 fallback in the
loop or the unchecked iterations run out of the loop: designs tried and
not kept) must equal the committed kernel bit for bit, and the plain
version run on the CPU on 64 games x 40 iterations; they are checked so.
``diag-`` variants break the result on purpose to show what one part of
an iteration costs (approximate divisions, the checked shares with no
fallback or with a fallback never taken, the FMA chains or the averaging
in float32) and are only timed.

    python -m gym_soccer_tpu_torch.ops.rmplus_variants

prints one line per variant (ms per call, median of 5 legs of at least
50 ms, CUDA events; registers; the card's name and power limit) and exits
1 if a design variant differs.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_BLOCK = "constexpr int kThreads = 32;    // games a block: one warp"
_ZERO_SKIP = ("    x[i] = s > 0.0f ? (r[i] == 0.0f ? r[i] : __fdiv_rn(r[i], d)) "
              ": 0.2f;")
_CHAIN = "  return __double2float_rn(__fma_rn(p, z, (double)acc));"
_AVERAGE = """    sx[i] = __double2float_rn(__fma_rn((double)x[i], w, (double)sx[i]));
    sy[i] = __double2float_rn(__fma_rn((double)y[i], w, (double)sy[i]));"""

# The shares from an approximate reciprocal, each checked by its exact
# remainder (designs tried for R1 and not kept: every form of the fallback
# for an unchecked share cost more than the zero regrets' skip saves).
_STRATEGY = "// The RM+ strategy of regrets r:"
_VOUCHED = """// An approximation of 1 / d (MUFU.RCP, within about an ulp), d normal.
__device__ __forceinline__ float rcp_approx(float d) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d));
  return y;
}

// r / d from y ~ 1 / d, corrected once by its remainder; ok where the
// remainder e = r - d * q (exact here) shows q is the float32 nearest to
// r / d: e == 0, or |e| < d * ulp(q) / 2 with q no power of two.
__device__ __forceinline__ float quotient(float r, float d, float y,
                                          bool& ok) {
  const float q0 = __fmul_rn(r, y);
  const float q = __fmaf_rn(__fmaf_rn(-d, q0, r), y, q0);
  const float e = __fmaf_rn(-d, q, r);
  const int bits = __float_as_int(q);
  const float half = __int_as_float((bits & 0x7f800000) - (24 << 23));
  ok = q >= 0x1p-40f && d >= 0x1p-40f &&
       (e == 0.0f || ((bits & 0x7fffff) != 0 &&
                      fabsf(e) < __fmul_rn(d, half)));
  return q;
}

// r / d in float64 (three Newton steps from rcp.approx.f64), rounded to
// float32: within ~2^-52 of r / d, which is never within ~2^-49 of a
// float32 rounding midpoint.
__device__ __forceinline__ float quotient64(float r, float d) {
  const double rd = r, dd = d;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(dd));
#pragma unroll
  for (int k = 0; k < 3; ++k) y = __fma_rn(y, __fma_rn(-dd, y, 1.0), y);
  const double q = __dmul_rn(rd, y);
  return __double2float_rn(__fma_rn(__fma_rn(-dd, q, rd), y, q));
}

// The shares from `quotient`; whether every one is vouched for.
__device__ __forceinline__ bool fast_strategy(const float (&r)[kA],
                                              float (&x)[kA]) {
  const float s = seq_sum(r);
  const float d = fmaxf(s, 1e-30f);
  const float y0 = rcp_approx(d);
  const float y = __fmaf_rn(y0, __fmaf_rn(-d, y0, 1.0f), y0);
  bool all = true;
#pragma unroll
  for (int i = 0; i < kA; ++i) {
    bool ok;
    const float q = quotient(r[i], d, y, ok);
    all = all & (ok | (r[i] == 0.0f));
    x[i] = s > 0.0f ? (r[i] == 0.0f ? r[i] : q) : 0.2f;
  }
  return !(s > 0.0f) | all;
}

""" + _STRATEGY
_SHARE_LOOP = "#pragma unroll\n  for (int i = 0; i < kA; ++i)\n" + _ZERO_SKIP


def _in_loop(fallback: str):
    """The strategy's shares vouched for, with ``fallback`` (a share's
    expression, or None) for the others inside the iteration loop."""
    block = ("""  if (!exact) {
#pragma unroll
    for (int i = 0; i < kA; ++i)
      if (!ok[i]) x[i] = %s;
  }
""" % fallback) if fallback else ""
    return [(_STRATEGY, _VOUCHED), (_SHARE_LOOP, """  const float y0 = rcp_approx(d);
  const float y = __fmaf_rn(y0, __fmaf_rn(-d, y0, 1.0f), y0);
  bool exact = true, ok[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) {
    const float q = quotient(r[i], d, y, ok[i]);
    ok[i] = ok[i] || r[i] == 0.0f;
    exact = exact && ok[i];
    x[i] = r[i] == 0.0f ? r[i] : q;
  }
""" + block + """#pragma unroll
  for (int i = 0; i < kA; ++i) x[i] = s > 0.0f ? x[i] : 0.2f;""")]


# The iteration loop as the vouched shares run it: an iteration whose
# shares are not all vouched for leaves it and runs with `strategy`.
_LOOP = """#pragma unroll 1
  for (int t = 0; t < iters; ++t) {
    float x[kA], y[kA];
    strategy(rx, x);
    strategy(ry, y);
    update(m, x, y, t, rx, ry, sx, sy);
  }"""
_FAST_LOOP = [(_STRATEGY, _VOUCHED), (_LOOP, """  int t = 0;
  while (t < iters) {
#pragma unroll 1
    for (; t < iters; ++t) {
      float x[kA], y[kA];
      if (!(fast_strategy(rx, x) & fast_strategy(ry, y))) break;
      update(m, x, y, t, rx, ry, sx, sy);
    }
    if (t < iters) {
      float x[kA], y[kA];
      strategy(rx, x);
      strategy(ry, y);
      update(m, x, y, t, rx, ry, sx, sy);
      ++t;
    }
  }""")]

# name -> [(text in rmplus_kernel.cu, its replacement)]; each text must
# occur exactly once.
VARIANTS = {
    "kernel": [],
    "128 games a block": [(_BLOCK, "constexpr int kThreads = 128;")],
    # R1's first build: __fdiv_rn for every share, zero regrets too
    "__fdiv_rn on every share": [
        (_ZERO_SKIP, "    x[i] = s > 0.0f ? __fdiv_rn(r[i], d) : 0.2f;")],
    "vouched shares, __fdiv_rn fallback": _in_loop("__fdiv_rn(r[i], d)"),
    "vouched shares, float64 fallback": _in_loop("quotient64(r[i], d)"),
    "vouched shares, fallback out of the loop": _FAST_LOOP,
    # diagnostics: wrong results, by design
    # each share by the approximate division (MUFU.RCP and a product)
    "diag-approximate division": [
        (_ZERO_SKIP, "    x[i] = s > 0.0f ? __fdividef(r[i], d) : 0.2f;")],
    # the FMA chains in float32, with no float64 and no conversion
    "diag-float32 chains": [(_CHAIN, "  return __fmaf_rn((float)p, (float)z, "
                                     "acc);")],
    # the vouched shares alone: the others as the unchecked quotient gives
    "diag-vouched shares, no fallback": _in_loop(None),
    # a __fdiv_rn fallback in the loop that is never taken (d >= 1e-30)
    "diag-vouched shares, __fdiv_rn fallback never taken": [
        *_in_loop("__fdiv_rn(r[i], d)"),
        ("  if (!exact) {", "  if (!exact && d < 0.0f) {")],
    # the averaging in float32
    "diag-float32 averaging": [(_AVERAGE, """    sx[i] = __fmaf_rn(x[i], (float)w, sx[i]);
    sy[i] = __fmaf_rn(y[i], (float)w, sy[i]);""")],
}
# (games, iterations): the callers' shapes
SHAPES = ((761, 400), (761, 3000), (2502, 200), (11705, 600))


def variant_source(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches applied; ValueError if a
    patched text does not occur exactly once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: its patch matches "
                             f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def _build_variant(name: str):
    from . import _build
    out_dir = _build.BUILD_DIR / "rmplus_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = "rmplus_kernel-" + re.sub(r"\W+", "-", name)
    src = out_dir / f"{stem}.cu"
    src.write_text(variant_source(
        name, (_build.CSRC / "rmplus_kernel.cu").read_text()))
    return _build.compile_sources([src], out_dir / f"{stem}.so")


def main() -> int:
    import ctypes

    import numpy as np
    import torch

    from ..agents import learners
    from . import parity_variants

    if not torch.cuda.is_available():
        print("rmplus_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    games = {n: torch.tensor(rng.uniform(-1, 1, (n, 5, 5)),
                             dtype=torch.float32, device=dev)
             for n in {g for g, _ in SHAPES}}
    small = torch.tensor(rng.uniform(-1, 1, (64, 5, 5)), dtype=torch.float32)
    cpu = learners.solve_matrix_games_plain(small, 40)

    committed = learners._library
    want, ok = {}, True
    try:
        for name, path in built.items():
            lib = learners.declare(ctypes.CDLL(str(path)))
            learners._library = lambda lib=lib: lib
            regs = re.findall(r"Used (\d+) registers",
                              path.with_suffix(".log").read_text())
            ms, same = {}, []
            for n, iters in SHAPES:
                out = learners.solve_matrix_games(games[n], iters)
                if name == "kernel":
                    want[n, iters] = out
                same.append(all(torch.equal(a, b)
                                for a, b in zip(out, want[n, iters])))
                ms[f"{n} x {iters}"] = parity_variants._time(
                    lambda: learners.solve_matrix_games(games[n], iters))
            got = learners.solve_matrix_games(small.to(dev), 40)
            same.append(all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu)))
            diag = name.startswith("diag-")
            ok &= diag or all(same)
            equal = ("diagnostic, not compared" if diag else
                     "bit-equal to the kernel and to the CPU plain version"
                     if all(same) else "DIFFERS from the kernel or the CPU "
                     "plain version")
            print(f"[variant] R1 {name}: " + ", ".join(
                f"{k} games x iterations {v} ms/call" for k, v in ms.items())
                + f"; registers {regs}; {equal} | {card}", flush=True)
    finally:
        learners._library = committed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
