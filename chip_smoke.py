#!/usr/bin/env python3
"""Build and drive the PyTorch port's main path on one NVIDIA GPU, and
check it.

    python3 chip_smoke.py

The main path is the batched random-play rollout at 8192 lanes on the 5x4
(slip 0.2) and 11x7 (slip 0.2) boards: ``fused_rollout`` (kernel K1),
``fused_journal_rollout`` (kernel K2) with ``unpack_journal``, and the
batched engine ``core.batch``.  Phases, each of which raises on failure:

1. device: a CUDA device is present; its name and power limit;
2. build: the kernels compile from the sources in this checkout;
3. main path: the user entry points at 8192 lanes, with the kernels'
   launch counters reset before and read after; outputs are checked by
   the repo's own means (valid states, journal decodes, stats agree);
4. K1: bit-equal to its plain version, for two block sizes, and a run
   split by ``step_offset`` equals one run;
5. K2: journal bit-equal to its plain version; fields and stats equal K1's;
6. small inputs: both kernels equal the plain versions run on the CPU;
7. batched engine: 8192 lanes x 100 steps on the card equal the CPU run;
8. timing: env-steps/s of K1, K2 and their plain versions (CUDA events,
   median of 5 legs of at least 50 ms each, after warmup).

The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is the JSON verdict.  Exits non-zero, with
no verdict, if anything fails or no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

B = 8192
BOARDS = ((5, 4), (11, 7))
SLIP = 0.2
T_K1 = 1000
T_K2 = 1024
SOURCE = "gym_soccer_tpu_torch/ops/csrc/step_kernel.cu"
REPLACES = {"fused_rollout": "gym_soccer_tpu/ops/step_kernel.py:254",
            "fused_journal_rollout": "gym_soccer_tpu/ops/step_kernel.py:714"}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ints(stats):
    return [int(x) for x in stats]


def max_abs_err(pairs):
    """max |a - b| over pairs of integer tensors (or ints)."""
    import torch
    err = 0
    for a, b in pairs:
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            d = (a.cpu().long() - b.cpu().long()).abs().max()
            err = max(err, int(d))
    return err


def time_cuda(fn, min_leg_ms=50.0, legs=5):
    """Median ms per call of ``fn`` over ``legs`` legs, each of enough
    back-to-back calls to last at least ``min_leg_ms``; CUDA events."""
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
    return statistics.median(per_call), reps, per_call


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, tables
    from gym_soccer_tpu_torch.ops import _build
    from gym_soccer_tpu_torch.ops import step_kernel as sk

    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build("step_kernel")
    _build.load("step_kernel")
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.3f} s")
    print(lib_path.with_suffix(".log").read_text().strip())

    cfgs = {b: EnvConfig(width=b[0], height=b[1], slip_prob=SLIP)
            for b in BOARDS}

    # ---- 3. main path, through the user entry points -------------------
    sk.reset_launch_counts()
    main_out = {}
    for board, cfg in cfgs.items():
        seed = 11 + board[0]
        k1 = sk.fused_rollout(cfg, seed, B, T_K1, dev)
        k2 = sk.fused_journal_rollout(cfg, seed, B, T_K2, dev)
        traj = sk.unpack_journal(cfg, k2[2])
        main_out[board] = (seed, k1, k2, traj)
    torch.cuda.synchronize()
    launches = dict(sk.launch_counts)
    print(f"[main path] launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    for board, (seed, k1, k2, traj) in main_out.items():
        cfg = cfgs[board]
        ss = tables.build_statespace(cfg)
        r2d = torch.as_tensor(ss.raw_to_dense, device=dev)
        for fields, stats, T in ((k1[0], k1[1], T_K1), (k2[0], k2[1], T_K2)):
            ra, ca, rb, cb, p, t = fields
            dense = r2d[((((ra * cfg.W + ca) * cfg.H + rb) * cfg.W + cb) * 2
                         + p).long()]
            check(bool((dense > 0).all()), "a lane ended terminal/unreachable")
            check(bool(((t >= 0) & (t < cfg.max_steps)).all()), "t out of range")
            rew, goals, truncs = ints(stats)
            check(0 < goals < B * T and abs(rew) <= goals and truncs >= 0,
                  f"implausible stats {ints(stats)}")
        rew, goals, truncs = ints(k2[1])
        check(int(traj["done"].sum()) == goals, "journal goals != stats")
        check(int(traj["truncated"].sum()) == truncs, "journal truncs != stats")
        check(int(traj["reward_a"].sum()) == rew, "journal reward != stats")
        check(int(traj["obs"].min()) >= 0 and int(traj["obs"].max()) < ss.nS,
              f"obs outside [0, {ss.nS})")
        check(int(traj["actions_a"].max()) <= 4, "action outside the space")
        print(f"[main path] {board[0]}x{board[1]} B={B}: K1 T={T_K1} stats "
              f"{ints(k1[1])}; K2 T={T_K2} stats {ints(k2[1])}, obs in "
              f"[0, {ss.nS})")

    errs = {"fused_rollout": 0, "fused_journal_rollout": 0}

    # ---- 4. K1 ---------------------------------------------------------
    for board, (seed, k1, _, _) in main_out.items():
        cfg = cfgs[board]
        pf, ps = sk.fused_rollout_plain(cfg, seed, B, T_K1, dev)
        e = max_abs_err([*zip(k1[0], pf), (ints(k1[1]), ints(ps))])
        errs["fused_rollout"] = max(errs["fused_rollout"], e)
        check(e == 0, f"K1 != plain on {board}: max abs err {e}")
        f256, s256 = sk.fused_rollout(cfg, seed, B, T_K1, dev, threads=256)
        f96, s96 = sk.fused_rollout(cfg, seed, B, T_K1, dev, threads=96)
        check(max_abs_err([*zip(f256, pf), *zip(f96, pf),
                           (ints(s256), ints(ps)), (ints(s96), ints(ps))]) == 0,
              f"K1 depends on the block size on {board}")
        h = T_K1 // 2
        fa, sa = sk.fused_rollout(cfg, seed, B, h, dev)
        fb, sb = sk.fused_rollout(cfg, seed, B, T_K1 - h, dev,
                                  init_fields=fa, step_offset=h)
        split = [x + y for x, y in zip(ints(sa), ints(sb))]
        check(max_abs_err([*zip(fb, pf), (split, ints(ps))]) == 0,
              f"K1 split at step {h} != one run on {board}")
        print(f"[K1] {board[0]}x{board[1]} B={B} T={T_K1}: bit-equal to plain "
              f"(max abs err {e}); threads 128/256/96 equal; "
              f"{h}+{T_K1 - h} split equals one run")

    # ---- 5. K2 ---------------------------------------------------------
    for board, (seed, _, k2, _) in main_out.items():
        cfg = cfgs[board]
        pf, ps, pj = sk.fused_journal_rollout_plain(cfg, seed, B, T_K2, dev)
        e = max_abs_err([*zip(k2[0], pf), (ints(k2[1]), ints(ps)),
                         (k2[2], pj)])
        errs["fused_journal_rollout"] = max(errs["fused_journal_rollout"], e)
        check(e == 0, f"K2 != plain on {board}: max abs err {e}")
        kf, ks = sk.fused_rollout(cfg, seed, B, T_K2, dev)
        check(max_abs_err([*zip(k2[0], kf), (ints(k2[1]), ints(ks))]) == 0,
              f"K2 fields/stats != K1's on {board}")
        jf, js, jj = sk.fused_journal_rollout(cfg, seed, B, T_K2, dev,
                                              threads=256)
        check(max_abs_err([(jj, pj), *zip(jf, pf)]) == 0,
              f"K2 depends on the block size on {board}")
        print(f"[K2] {board[0]}x{board[1]} B={B} T={T_K2}: journal bit-equal "
              f"to plain (max abs err {e}); fields and stats equal K1's; "
              "threads 128/256 equal")

    # ---- 6. small inputs against the CPU plain versions ----------------
    for board, cfg in cfgs.items():
        cf, cs, cj = sk.fused_journal_rollout(cfg, 3, 1024, 64, "cpu")
        gf, gs, gj = sk.fused_journal_rollout(cfg, 3, 1024, 64, dev)
        kf, ks = sk.fused_rollout(cfg, 3, 1024, 64, dev)
        check(max_abs_err([*zip(gf, cf), *zip(kf, cf), (gj, cj),
                           (ints(gs), ints(cs)), (ints(ks), ints(cs))]) == 0,
              f"kernels != CPU plain versions on {board}")
    print("[small] K1 and K2 at B=1024 T=64 equal the CPU plain versions")

    # ---- 7. batched engine, card against CPU ---------------------------
    import numpy as np
    key_words = np.random.default_rng(0).integers(0, 2**32, (B, 2),
                                                  dtype=np.uint64)
    for board, cfg in cfgs.items():
        runs = []
        for d in (dev, torch.device("cpu")):
            st = batch.init_from_keys(cfg, key_words, d)
            st, acc = batch.random_rollout_stats(cfg, st, 100)
            runs.append((st, acc))
        (gst, gacc), (cst, cacc) = runs
        check(max_abs_err(list(zip(gst, cst))) == 0,
              f"batched engine state differs CUDA vs CPU on {board}")
        check([a.item() for a in gacc] == [a.item() for a in cacc],
              f"batched engine stats differ CUDA vs CPU on {board}")
        print(f"[engine] {board[0]}x{board[1]} B={B} x 100 steps: CUDA == CPU, "
              f"stats {[a.item() for a in gacc]}")

    # ---- 8. timing -----------------------------------------------------
    cfg = cfgs[(5, 4)]
    T = T_K2
    timed = {
        "fused_rollout": lambda: sk.fused_rollout(cfg, 1, B, T, dev),
        "fused_rollout_plain":
            lambda: sk.fused_rollout_plain(cfg, 1, B, T, dev),
        "fused_journal_rollout":
            lambda: sk.fused_journal_rollout(cfg, 1, B, T, dev),
        "fused_journal_rollout_plain":
            lambda: sk.fused_journal_rollout_plain(cfg, 1, B, T, dev),
    }
    ms = {}
    for name, fn in timed.items():
        med, reps, legs = time_cuda(fn)
        ms[name] = med
        print(f"[time] {name} 5x4 B={B} T={T}: {med} ms/call, "
              f"{B * T / (med / 1e3)} env-steps/s (median of {len(legs)} "
              f"legs x {reps} calls; legs ms/call {legs}) | {card}")
    for name in ("fused_rollout", "fused_journal_rollout"):
        big = cfgs[(11, 7)]
        fn = getattr(sk, name)
        med, reps, legs = time_cuda(lambda: fn(big, 1, B, T, dev))
        print(f"[time] {name} 11x7 B={B} T={T}: {med} ms/call, "
              f"{B * T / (med / 1e3)} env-steps/s (median of {len(legs)} "
              f"legs x {reps} calls) | {card}")
    print(f"[clocks] sm MHz, power W, temp C after timing: "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": ms[name],
         "plain_ms": ms[name + "_plain"]}
        for name in ("fused_rollout", "fused_journal_rollout")]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
