"""Time variants of the K12/K13 parity kernel on a CUDA card.

Each variant is ``csrc/parity_kernel.cu`` with a few text patches
(`VARIANTS`), built beside the port's own build and launched through the
public wrappers at ``chip_smoke.py``'s timed shapes: K12 (``parity_events``)
8192 lanes x 1536 events on 5x4 and 11x7, K13
(``parity_scripted_events``) 8192 x 768 with an 800-row script on 5x4, all
at slip 0.2.  Design variants (another threshold search, another twist
chunk) must stay bit-equal to the committed kernel and are checked so;
``diag-`` variants break the result on purpose to show what one part of
the event costs (no twist, a next-word table that stays in L1) and are
only timed.  The committed kernel is also timed at 32 lanes per block.

    python -m gym_soccer_tpu_torch.ops.parity_variants

prints one line per variant (ms per call, median of 5 legs of at least
50 ms, CUDA events, with the card's name and power limit) and exits 1 if
a design variant differs from the kernel.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import math
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# The committed pick_slot's body: the two-level search.
_TWO_LEVEL = """  int g = 0;
#pragma unroll
  for (int m = 0; m < 6; ++m) g += cum[6 * m + 5] <= u;
  const int h = min(g, 5);
  const double* c = cum + 6 * h;
  int i = 6 * h;
#pragma unroll
  for (int j = 0; j < 5; ++j) i += c[j] <= u;
  return g >= 6 ? (int)cum[kSlots] : i;"""
_TWIST_CHUNK = "  constexpr int kC = 8;"
_IN_LOOP_TWIST = "if (k + 1 < a.n_events) twist(w, L);"
_WORD_LOAD = "__ldg(a.words + (size_t)base * kSlots + i_sel)"
# the next word read from the table's first 64 rows, which stay in L1
_L1_WORD_LOAD = "__ldg(a.words + (size_t)(base & 63) * kSlots + i_sel)"

# name -> [(text in parity_kernel.cu, its replacement)]; each text must
# occur exactly once.
VARIANTS = {
    "kernel": [],
    # the 36 compares summed one after another
    "search-linear": [(_TWO_LEVEL, """  int i = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) i += cum[j] <= u;
  return i >= kSlots ? (int)cum[kSlots] : i;""")],
    # the 36 compares summed as a balanced tree
    "search-tree": [(_TWO_LEVEL, """  int b[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) b[j] = cum[j] <= u;
#pragma unroll
  for (int s = 1; s < kSlots; s *= 2)
#pragma unroll
    for (int j = 0; j + s < kSlots; j += 2 * s) b[j] += b[j + s];
  return b[0] >= kSlots ? (int)cum[kSlots] : b[0];""")],
    "twist-chunk-1": [(_TWIST_CHUNK, "  constexpr int kC = 1;")],
    "twist-chunk-4": [(_TWIST_CHUNK, "  constexpr int kC = 4;")],
    "twist-chunk-16": [(_TWIST_CHUNK, "  constexpr int kC = 16;")],
    # diagnostics: wrong results, by design
    "diag-no-twist": [(_IN_LOOP_TWIST, "(void)0;")],
    "diag-l1-word": [(_WORD_LOAD, _L1_WORD_LOAD)],
    "diag-both": [(_IN_LOOP_TWIST, "(void)0;"), (_WORD_LOAD, _L1_WORD_LOAD)],
}
B, E_K12, E_K13, SCRIPT_ROWS, SLIP = 8192, 1536, 768, 800, 0.2


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
    out_dir = _build.BUILD_DIR / "parity_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"parity_kernel-{name}.cu"
    src.write_text(variant_source(
        name, (_build.CSRC / "parity_kernel.cu").read_text()))
    return _build.compile_sources([src], out_dir / f"parity_kernel-{name}.so")


def _time(fn, min_leg_ms=50.0, legs=5):
    """Median ms per call over ``legs`` legs of back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    reps = max(1, math.ceil(min_leg_ms / max(e0.elapsed_time(e1), 1e-3)))
    per_call = []
    for _ in range(legs):
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        per_call.append(e0.elapsed_time(e1) / reps)
    return statistics.median(per_call)


def main() -> int:
    import ctypes

    import numpy as np
    import torch

    from ..config import EnvConfig
    from ..core import tables
    from . import parity_kernel as pk

    if not torch.cuda.is_available():
        print("parity_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))

    dev = torch.device("cuda", 0)
    cfgs = {(w, h): EnvConfig(width=w, height=h, slip_prob=SLIP)
            for w, h in ((5, 4), (11, 7))}
    seeds = torch.as_tensor(np.arange(B) % 997, device=dev)
    jr = {}
    for b, c in cfgs.items():
        nS = tables.build_statespace(c).nS
        jr[b] = torch.as_tensor(pk.jointrow_raw(
            c, np.random.RandomState(1).randint(0, 5, nS),
            np.random.RandomState(7).randint(0, 5, nS)), device=dev)
    rng = np.random.RandomState(3)
    script = torch.as_tensor((rng.randint(0, 5, (SCRIPT_ROWS, B)) * 5
                              + rng.randint(0, 5, (SCRIPT_ROWS, B))).astype(
                                  np.int32), device=dev)
    calls = {
        "K12 5x4": lambda t: pk.parity_events(
            cfgs[(5, 4)], seeds, jr[(5, 4)], E_K12, dev, threads=t),
        "K12 11x7": lambda t: pk.parity_events(
            cfgs[(11, 7)], seeds, jr[(11, 7)], E_K12, dev, threads=t),
        "K13 5x4": lambda t: pk.parity_scripted_events(
            cfgs[(5, 4)], seeds, script, E_K13, dev, threads=t)}

    committed = pk._library
    want, ok = {}, True
    try:
        for name, path in built.items():
            lib = pk.declare(ctypes.CDLL(str(path)))
            pk._library = lambda lib=lib: lib
            regs = {f"K1{2 + int(k)}": int(r) for k, r in re.findall(
                r"parity_kernelILb([01])E.*?Used (\d+) registers",
                path.with_suffix(".log").read_text(), re.S)}
            runs = [(name, None)] + ([(name + ", 32 lanes per block", 32)]
                                     if name == "kernel" else [])
            for label, threads in runs:
                ms, same = {}, []
                for call_name, call in calls.items():
                    out = call(threads)
                    if name == "kernel" and threads is None:
                        want[call_name] = out
                    same.append(all(torch.equal(a, b) for a, b in
                                    zip(out, want[call_name])))
                    ms[call_name] = _time(lambda: call(threads))
                if not name.startswith("diag-") and not all(same):
                    ok = False
                equal = ("diagnostic, not compared" if name.startswith("diag-")
                         else "bit-equal to the kernel" if all(same)
                         else "DIFFERS from the kernel")
                print(f"[variant] {label}: " + ", ".join(
                    f"{k} {v} ms/call" for k, v in ms.items())
                    + f"; registers {regs}; "
                    f"{equal} | {card}")
    finally:
        pk._library = committed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
