"""On-device check and throughput of the parity kernels, the twin of the
JAX package's tools/bench_parity_kernel.py:

1. closed loop: K12's journal (``parity_events``) for the first 256 lanes
   at 512 events, through ``unpack_journal``, must equal
   ``core.parity.parity_policy_events`` on the same device in ``raw``,
   ``reward_a`` and ``done``;
2. its throughput: events/s from the slope between ``--e-short`` and
   ``--e-long`` events, the share of events that are transitions, and
   bit-exact env-steps/s;
3. scripted mode: K13 (``parity_scripted_events``) with an 800-row script
   against ``parity_rollout`` on the first 128 lanes, every 31st lane's
   transitions compared; then its slope at 256 / 768 events.

Each length is timed by ``bench_all.timed`` (a warm-up call, CUDA events,
the median of 5 legs of at least 50 ms each); a slope whose long length
is not slower fails.  Each check prints ``{"check": ..., "ok": ...}`` with
the platform and the card; the exit code is 1 on any mismatch.

    python -m gym_soccer_tpu_torch.tools.bench_parity_kernel [--batch 8192]
        [--e-short 512] [--e-long 1536] [--quick] [--device cpu]

``--device cuda`` (the default) needs a CUDA device and exits 2 without
one; with ``--device cpu`` the kernels' plain versions run.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core import parity, tables
from ..ops import parity_kernel as pkm
from . import bench_all
from .bench_scaling import card

CFG = bench_all.CFG
CHECK_LANES = 256
CHECK_EVENTS = 512
SCRIPT_ROWS = 800
SCRIPT_LANES = 128
SCRIPT_EVENTS = 256
SCRIPT_STRIDE = 31


def closed_loop_check(seeds, jr, pol_a, pol_b, device) -> bool:
    """K12's journal of the first ``CHECK_LANES`` lanes against the event
    loop of ``core/parity`` on ``device``."""
    out = pkm.parity_events(CFG, seeds, jr, CHECK_EVENTS, device)
    n = min(CHECK_LANES, seeds.shape[0])
    J = pkm.unpack_journal(out.journal[:, :n])
    pt = parity.parity_tables(CFG)
    rows = parity.policy_rows(pt, pol_a, pol_b, device=device)
    hi, lo = parity.gen_streams(seeds[:n].cpu().numpy(), CHECK_EVENTS,
                                device)
    _, ev = parity.parity_policy_events(CFG, pt, parity.parity_init(
        CFG, n, device), rows, CHECK_EVENTS, hi, lo)
    return bool(torch.equal(J["raw"], ev.raw)
                and torch.equal(J["reward_a"].float(), ev.reward_a)
                and torch.equal(J["done"].bool(), ev.done))


def scripted_check(seeds, script, device) -> bool:
    """K13 over every lane for ``SCRIPT_EVENTS`` events against
    ``parity_rollout`` of the first ``SCRIPT_LANES`` lanes on the script's
    first ``SCRIPT_EVENTS // 2`` rows: every ``SCRIPT_STRIDE``-th lane's
    transitions, observation and reward."""
    out = pkm.parity_scripted_events(CFG, seeds, script, SCRIPT_EVENTS,
                                     device)
    n = min(SCRIPT_LANES, seeds.shape[0])
    J = {k: v.cpu().numpy() for k, v in
         pkm.unpack_journal(out.journal[:, :n]).items()}
    n_rows = SCRIPT_EVENTS // 2
    hi, lo = parity.gen_streams(seeds[:n].cpu().numpy(), 2 * n_rows + 2,
                                device)
    _, so = parity.parity_rollout(
        CFG, parity.parity_tables(CFG), parity.parity_init(CFG, n, device),
        script[:n_rows, :n], hi, lo)
    obs, reward = so.obs.cpu().numpy(), so.reward_a.cpu().numpy()
    r2d = tables.build_statespace(CFG).raw_to_dense
    ok = True
    for b in range(0, n, SCRIPT_STRIDE):
        tr = J["was_reset"][:, b] == 0
        k = min(int(tr.sum()), n_rows)
        ok &= np.array_equal(r2d[J["raw"][tr, b][:k]], obs[:k, b])
        ok &= np.array_equal(J["reward_a"][tr, b][:k].astype(np.float32),
                             reward[:k, b])
    return bool(ok)


def slope_line(metric, call, lengths, batch, device, **extra) -> dict:
    """A slope of ``call(n) -> transitions`` between the two event
    counts: events/s, the long call's share of transitions, and
    bit-exact env-steps/s."""
    steps = []
    row = bench_all.slope(lambda n: steps.append(call(n)), lengths, batch,
                          device)
    share = steps[-1] / (lengths[1] * batch)
    return {"metric": metric, "batch": batch, **extra,
            "events_per_s": row["env_steps_per_s"], "step_fraction": share,
            "env_steps_per_s_bit_exact": row["env_steps_per_s"] * share,
            "w_short_s": row["short_ms"] / 1e3,
            "w_long_s": row["long_ms"] / 1e3, "events": list(lengths),
            "calls": row["calls"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=bench_all.LANES_ONE_WAVE)
    ap.add_argument("--e-short", type=int, default=512)
    ap.add_argument("--e-long", type=int, default=1536)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = args.device
    where = None
    if device == "cuda":
        if not torch.cuda.is_available():
            print("bench_parity_kernel: --device cuda needs a CUDA device and "
                  "none is present; pass --device cpu for the plain versions",
                  file=sys.stderr)
            return 2
        where = card()
    platform = {"cuda": "gpu", "cpu": "cpu"}[device]
    B = args.batch
    lengths = (256, 512) if args.quick else (args.e_short, args.e_long)

    pol_a, pol_b = bench_all.parity_policies()
    jr = torch.as_tensor(pkm.jointrow_raw(CFG, pol_a, pol_b), device=device)
    seeds = torch.as_tensor(np.arange(B) % 997, device=device)
    ok = closed_loop_check(seeds, jr, pol_a, pol_b, device)
    print(json.dumps({"check": "on_chip_bit_exact", "ok": ok,
                      "platform": platform, "card": where}), flush=True)
    if not ok:
        return 1
    print(json.dumps(slope_line(
        "parity_kernel",
        lambda n: int(pkm.parity_events(CFG, seeds, jr, n, device)
                      .steps.sum()),
        lengths, B, device, card=where)), flush=True)

    # The script covers every measured event: lanes past its end play row
    # 0, which is cheaper, so a slope run off the script would read high.
    rng = np.random.RandomState(3)
    script = torch.as_tensor(
        (rng.randint(0, 5, (SCRIPT_ROWS, B)) * 5
         + rng.randint(0, 5, (SCRIPT_ROWS, B))).astype(np.int32),
        device=device)
    ok = scripted_check(seeds, script, device)
    print(json.dumps({"check": "scripted_on_chip_bit_exact", "ok": ok,
                      "platform": platform, "card": where}), flush=True)
    print(json.dumps(slope_line(
        "parity_kernel_scripted",
        lambda n: int(pkm.parity_scripted_events(CFG, seeds, script, n,
                                                 device).steps.sum()),
        (128, 384) if args.quick else (256, 768), B, device,
        script_rows=SCRIPT_ROWS, card=where)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
