"""Time variants of the RM+ solve kernel R1 on a CUDA card.

Each variant is ``csrc/rmplus_kernel.cu`` (a game on a group of lanes of
one warp) with a few text patches (`VARIANTS`), or the previous design,
``csrc/rmplus_thread_kernel.cu`` (one thread a game), which only this
module builds.  Each is built beside the port's own build and launched
through ``agents.learners.solve_matrix_games`` at the shapes its callers
give it: the 5x4 contract's re-solve (761 games x 400 iterations) and
final solve (x 3000), the HBM-table learner's re-solve (761 x 200), the
``--multigrid`` recipe's (2502 x 200) and the 11x7 contract's
(11705 x 600), on random games from a numpy seed.  Design variants (the
previous design; 5 lanes a game, one action of both players a lane; four
warps a block; the committed kernel's three choices undone, alone and
together: a branch around a zero regret's division, each reader
converting the shares it reads to float64, the averaging weight
converted from t; every share by __fdiv_rn, zero regrets too; the shares
from an approximate reciprocal checked by their exact remainders, with a
__fdiv_rn or a float64 fallback) must equal the committed kernel bit for
bit, and the plain version run on the CPU on 64 games x 40 iterations
and on 7 games (a warp partly empty); they are checked so.  ``diag-``
variants break the result on purpose to show what one part of an
iteration costs (approximate divisions, the checked shares with no
fallback or with a fallback never taken, the FMA chains or the averaging
in float32) and are only timed.

    python -m gym_soccer_tpu_torch.ops.rmplus_variants

prints one line per variant: at each shape the ms per call (median of 5
legs of at least 50 ms, CUDA events) and the device ms by CUDA-graph
replay, with the cycles an iteration at 1.98 GHz; its registers; the
card's name and power limit.  Exits 1 if a design variant differs.
Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# The previous design's source; every other variant patches the kernel's.
THREAD_SOURCE = "rmplus_thread_kernel.cu"
PREVIOUS = "one thread a game (previous design)"
_LANES = "constexpr int kLanes = 10;             // lanes a game: 10 or 5"
_WARPS = "constexpr int kWarps = 1;              // warps a block"
_SHARE_BODY = """  const float q = __fdiv_rn(r == 0.0f ? d : r, d);
  return s > 0.0f ? (r == 0.0f ? r : q) : 0.2f;"""
_CHAIN = "  return __double2float_rn(__fma_rn(p, z, (double)acc));"
_AVERAGE = ("      s[k] = __double2float_rn(__fma_rn(zd[k], w, "
            "(double)s[k]));")

# The shares from an approximate reciprocal, each checked by its exact
# remainder (a design tried for the previous design and not kept: every
# form of the fallback for an unchecked share cost more than the zero
# regrets' skip saves).
_SHARE = "// The RM+ share of regret r,"
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

""" + _SHARE


def _vouched(fallback, taken="!ok"):
    """The share vouched for, with ``fallback`` (an expression of r and d,
    or None) where it is not, under the condition ``taken``."""
    block = (f"  if ({taken} && r != 0.0f) q = {fallback};\n"
             if fallback else "")
    return [(_SHARE, _VOUCHED), (_SHARE_BODY, """  const float y0 = rcp_approx(d);
  const float y = __fmaf_rn(y0, __fmaf_rn(-d, y0, 1.0f), y0);
  bool ok;
  float q = quotient(r, d, y, ok);
""" + block + "  return s > 0.0f ? (r == 0.0f ? r : q) : 0.2f;")]


# The committed design's three choices, each undone: a branch around the
# division of a zero regret; each reader converting the shares it reads to
# float64; the averaging weight converted from t each iteration.
_SKIP_ZEROS = [(_SHARE_BODY, "  return s > 0.0f ? (r == 0.0f ? r : "
                "__fdiv_rn(r, d)) : 0.2f;")]
_READERS_CONVERT = [
    ("__shfl_sync(kWarp, zd, owner(base, q, j)));",
     "(double)__shfl_sync(kWarp, z, owner(base, q, j)));")]
_WEIGHT_FROM_T = [("    w = __dadd_rn(w, 1.0);", "    w = (double)(t + 1);")]

# name -> [(text in rmplus_kernel.cu, its replacement)]; each text must
# occur exactly once.  PREVIOUS builds THREAD_SOURCE as it is.
VARIANTS = {
    "kernel": [],
    PREVIOUS: [],
    "5 lanes a game": [(_LANES, "constexpr int kLanes = 5;")],
    "zero regrets skipped": _SKIP_ZEROS,
    "shares converted by their readers": _READERS_CONVERT,
    "weight converted from t": _WEIGHT_FROM_T,
    "the three choices undone":
        _SKIP_ZEROS + _READERS_CONVERT + _WEIGHT_FROM_T,
    "4 warps a block": [(_WARPS, "constexpr int kWarps = 4;")],
    # the previous design's first build: __fdiv_rn for every share
    "__fdiv_rn on every share": [
        (_SHARE_BODY, "  return s > 0.0f ? __fdiv_rn(r, d) : 0.2f;")],
    "vouched shares, __fdiv_rn fallback": _vouched("__fdiv_rn(r, d)"),
    "vouched shares, float64 fallback": _vouched("quotient64(r, d)"),
    # diagnostics: wrong results, by design
    # each share by the approximate division (MUFU.RCP and a product)
    "diag-approximate division": [
        (_SHARE_BODY, "  return s > 0.0f ? __fdividef(r, d) : 0.2f;")],
    # the FMA chains in float32, with no float64 and no conversion
    "diag-float32 chains": [(_CHAIN, "  return __fmaf_rn((float)p, (float)z, "
                                     "acc);")],
    # the vouched shares alone: the others as the unchecked quotient gives
    "diag-vouched shares, no fallback": _vouched(None),
    # a __fdiv_rn fallback that is never taken (d >= 1e-30)
    "diag-vouched shares, __fdiv_rn fallback never taken": _vouched(
        "__fdiv_rn(r, d)", taken="!ok && d < 0.0f"),
    # the averaging in float32
    "diag-float32 averaging": [(_AVERAGE, "      s[k] = __fmaf_rn(z[k], "
                                          "(float)w, s[k]);")],
}
# (games, iterations): the callers' shapes
SHAPES = ((761, 400), (761, 3000), (761, 200), (2502, 200), (11705, 600))
# The clock at which `cycles an iteration` is stated: the H100 SXM's boost
CLOCK_HZ = 1.98e9


def variant_source(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches applied; ValueError if a
    patched text does not occur exactly once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: its patch matches "
                             f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def build_variant(name: str):
    """Compile variant ``name`` beside the port's build; its path."""
    from . import _build
    out_dir = _build.BUILD_DIR / "rmplus_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = "rmplus_kernel-" + re.sub(r"\W+", "-", name)
    src = out_dir / f"{stem}.cu"
    origin = THREAD_SOURCE if name == PREVIOUS else "rmplus_kernel.cu"
    src.write_text(variant_source(name, (_build.CSRC / origin).read_text()))
    return _build.compile_sources([src], out_dir / f"{stem}.so")


def device_ms(fn) -> float:
    """ms of device time of ``fn``'s launches: one call captured in a CUDA
    graph, its replays timed (``parity_variants._time``)."""
    import torch

    from . import parity_variants
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return parity_variants._time(graph.replay)


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
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    games = {n: torch.tensor(rng.uniform(-1, 1, (n, 5, 5)),
                             dtype=torch.float32, device=dev)
             for n in {g for g, _ in SHAPES}}
    small = [(torch.tensor(rng.uniform(-1, 1, (n, 5, 5)),
                           dtype=torch.float32), iters)
             for n, iters in ((64, 40), (7, 40))]
    cpu = [learners.solve_matrix_games_plain(M, iters) for M, iters in small]

    committed = learners._library
    want, ok = {}, True
    try:
        for name, path in built.items():
            lib = learners.declare(ctypes.CDLL(str(path)))
            learners._library = lambda lib=lib: lib
            regs = re.findall(r"Used (\d+) registers",
                              path.with_suffix(".log").read_text())
            shape = (ctypes.c_int32 * 3)()
            lib.gst_rmplus_shape(shape)
            timed, same = [], []
            for n, iters in SHAPES:
                out = learners.solve_matrix_games(games[n], iters)
                if name == "kernel":
                    want[n, iters] = out
                same.append(all(torch.equal(a, b)
                                for a, b in zip(out, want[n, iters])))

                def call(n=n, iters=iters):
                    learners.solve_matrix_games(games[n], iters)
                ms = parity_variants._time(call)
                dev_ms = device_ms(call)
                timed.append(f"{n} x {iters} {ms} ms/call, device {dev_ms} "
                             f"ms ({dev_ms * 1e-3 * CLOCK_HZ / iters} cycles "
                             f"an iteration)")
            for (M, iters), plain in zip(small, cpu):
                got = learners.solve_matrix_games(M.to(dev), iters)
                same.append(all(torch.equal(a.cpu(), b)
                                for a, b in zip(got, plain)))
            diag = name.startswith("diag-")
            ok &= diag or all(same)
            equal = ("diagnostic, not compared" if diag else
                     "bit-equal to the kernel and to the CPU plain version"
                     if all(same) else "DIFFERS from the kernel or the CPU "
                     "plain version")
            print(f"[variant] R1 {name} ({shape[0]} lanes a game, "
                  f"{shape[1]} games a warp, {shape[2]} warps a block): "
                  + "; ".join(timed) + f"; registers {regs}; {equal} "
                  f"| {card}", flush=True)
    finally:
        learners._library = committed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
