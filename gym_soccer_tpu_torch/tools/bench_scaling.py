"""Scaling bench: throughput against the number of ranks of the env mesh,
the port's twin of tools/bench_scaling.py.

Weak scaling: each rank holds a fixed number of envs and the global batch
grows with the world size; efficiency(N) = thr(N) / (N * thr(1)).  The
four paths of the JAX tool, each through parallel/mesh:

* ``rollout``: ``sharded_rollout_fn``, random play (T1's keyed draw and
  kernel S1 on the card), one all-reduce of its sums a call;
* ``minimax_train``: ``sharded_minimax_train_fn``, the HBM-table learner
  with its sums and counts all-reduced every step;
* ``fused_learner_chunk``: ``sharded_learner_chunk_fn``, one unpacked
  chunk (kernel K7 on the card) a rank, its accumulators all-reduced.  On
  the CPU the plain version runs, at most 256 lanes (and at least the 128
  lanes a chunk takes) a rank and 8 steps;
* ``sharded_solve``: ``sharded_solve_fn``, the state-sharded RM+ solve of
  the 761 states (kernel R1 on the card): strong scaling over a fixed
  number of games, steps_per_s counting game-iterations.

By default each rank is a process on its own CUDA device and the group
NCCL, and each row carries the card's name and power limit; the world
sizes are clipped to the devices present, and without a CUDA device the
run is refused (exit code 2).  ``--device cpu`` runs the ranks as gloo CPU
processes instead: the proxy of the JAX tool's virtual mesh (the ranks
share the machine's cores, so the wall-clock efficiency is not the
program's), its rows marked ``proxy``.  ``efficiency_device_work``
compares work per second of process CPU time, summed over the ranks'
processes, as the JAX tool compares its one process's.

``--solve-split`` measures instead what ``fused_minimax_train`` weighs
when it re-solves under a mesh: at each world size and each
(games, iterations) of ``SOLVE_SHAPES``, the replicated solve (every rank
solves every game with ``solve_matrix_games``) against
``sharded_solve_fn`` (each rank solves its share, then the gather), both
bit-equal, in ms a call.

    python -m gym_soccer_tpu_torch.tools.bench_scaling [--device cpu]
        [--quick] [--solve-split]

One JSON line per row and a summary line; exit code 0 (a measurement, not
a gate), or 2 where the device asked for is absent.
"""
from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time

# (games, RM+ iterations) of --solve-split: the 5x4 contract's re-solve,
# the 6x5 board's state count and the 11x7 contract's re-solve.
SOLVE_SHAPES = ((761, 400), (2502, 400), (11705, 600))


def _timed(fn, mesh, n: int = 3):
    """Median (wall, process-CPU) seconds a call of ``fn``, after one
    warm-up call; on a CUDA device each call ends synchronised.  Every
    timed call starts after a barrier (an all-reduce of one value), so a
    rank's clock does not count the time it waits for a rank still busy
    with earlier work."""
    import torch
    device = mesh.device
    one = torch.zeros(1, device=device)

    def call():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    ts, cs = [], []
    for _ in range(n):
        mesh.all_reduce_(one)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        cs.append((r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime))
    return sorted(ts)[n // 2], sorted(cs)[n // 2]


def card() -> str | None:
    """The first card's name and power limit, as nvidia-smi reports them,
    or None where there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else None


def measure(mesh, envs_per_device: int, n_steps: int, reps: int) -> list:
    """One rank's rows of the four paths at this world size (every rank
    runs the same calls; rank 0's walls are kept)."""
    import torch

    from ..agents import learners
    from ..config import EnvConfig
    from ..core import batch, threefry
    from ..ops import learner_kernel as lk
    from ..parallel import mesh as pmesh

    cfg = EnvConfig(5, 4, 0.2)
    dev, n = mesh.device, mesh.world
    nS = lk.n_states(cfg)
    B = envs_per_device * n
    blk = mesh.block(B)
    rows = []

    def row(path, n_envs, steps, dt_dc):
        dt, dc = dt_dc
        rows.append({"path": path, "n_devices": n, "n_envs": n_envs,
                     "steps_per_s": steps / dt, "cpu_s_per_call": dc})

    # the random rollout: the rank's block of the global draw
    pol = batch.random_policy_fn(cfg, threefry.key(1), B)
    st = pmesh.sharded_init(cfg, mesh, threefry.key(0), B)
    roll = pmesh.sharded_rollout_fn(
        cfg, mesh, lambda obs, i: tuple(a[blk] for a in pol(obs, i)),
        n_steps)

    def run_roll():
        nonlocal st
        st, sums = roll(st)
        int(sums[0])   # a host read of the all-reduced sums

    row("rollout", B, B * n_steps, _timed(run_roll, mesh, reps))

    # the HBM-table minimax-Q learner, sums all-reduced every step
    f32 = dict(dtype=torch.float32, device=dev)
    uniform = torch.full((nS, 5), 0.2, **f32)
    lstate = learners.MinimaxQState(
        q=torch.zeros((nS, 5, 5), **f32), v=torch.zeros(nS, **f32),
        pi_a=uniform, pi_b=uniform.clone(),
        env=pmesh.sharded_init(cfg, mesh, threefry.key(2), B),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        n=torch.zeros((nS, 5, 5), **f32))
    train = pmesh.sharded_minimax_train_fn(
        cfg, learners.MinimaxQConfig(resolve_every=64), mesh, n_steps)

    def run_train():
        nonlocal lstate
        lstate, td = train(lstate)
        float(td.sum())

    row("minimax_train", B, B * n_steps, _timed(run_train, mesh, reps))

    # the fused chunk a rank, accumulators all-reduced
    cuda = dev.type == "cuda"
    f_epd = envs_per_device if cuda else max(128, min(envs_per_device, 256))
    f_T = n_steps if cuda else min(n_steps, 8)
    fB = f_epd * n
    m = lk.pack_m(cfg, uniform, uniform, torch.zeros((nS, 5, 5), **f32),
                  torch.zeros(nS, **f32), 0.3)
    fields = pmesh.shard_fields(lk.init_state_fields(cfg, fB, dev), mesh, fB)
    chunk = pmesh.sharded_learner_chunk_fn(cfg, mesh, fB, f_T)

    def run_fused():
        nonlocal fields
        fields, acc, _ = chunk(0, m, fields)
        int(acc[1][0, 0])

    row("fused_learner_chunk", fB, fB * f_T, _timed(run_fused, mesh, reps))

    # the state-sharded RM+ solve of a fixed batch of games
    iters = 2 * n_steps
    gen = torch.Generator().manual_seed(5)
    q = pmesh.replicated(mesh, torch.rand((nS, 5, 5), generator=gen) * 2 - 1)
    solve = pmesh.sharded_solve_fn(mesh, iters)
    row("sharded_solve", nS, nS * iters,
        _timed(lambda: float(solve(q)[0][0]), mesh, reps))
    return rows


def solve_split(mesh, shapes, calls: int, reps: int) -> list:
    """One rank's rows of ``--solve-split``: for each (games, iters) the
    replicated and the sharded re-solve of the same random games, each
    timed as the median over ``reps`` of ``calls`` calls in a row (after a
    barrier, ending synchronised), in ms a call; the two results are
    checked equal bit for bit."""
    import torch

    from ..agents.learners import solve_matrix_games
    from ..parallel import mesh as pmesh
    rows = []
    for games, iters in shapes:
        gen = torch.Generator().manual_seed(games)
        q = pmesh.replicated(
            mesh, torch.rand((games, 5, 5), generator=gen) * 2 - 1)
        sharded = pmesh.sharded_solve_fn(mesh, iters)
        want, got = solve_matrix_games(q, iters=iters), sharded(q)
        if not all(torch.equal(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"the sharded solve of {games} games "
                                 "differs from the replicated one")

        def loop(fn):
            def run():
                for _ in range(calls):
                    fn()
            return run
        rep = _timed(loop(lambda: solve_matrix_games(q, iters=iters)),
                     mesh, reps)[0]
        shd = _timed(loop(lambda: sharded(q)), mesh, reps)[0]
        rows.append({"path": "solve_split", "n_devices": mesh.world,
                     "games": games, "iters": iters,
                     "replicated_ms": rep * 1e3 / calls,
                     "sharded_ms": shd * 1e3 / calls})
    return rows


def sweep(device_counts, envs_per_device: int = 2048, n_steps: int = 200,
          reps: int = 3, device: str = "cuda") -> list:
    """The rows of the four paths at each world size in ``device_counts``,
    each measured by that many spawned ranks (one rank per CUDA device
    over NCCL, or with ``device`` "cpu" gloo CPU processes), with each
    row's ``efficiency_vs_linear`` against the 1-rank row of its path and
    ``efficiency_device_work`` (see the module docstring)."""
    from ..parallel import mesh as pmesh
    rows = []
    for n in device_counts:
        ranks = pmesh.spawn(measure, n, (envs_per_device, n_steps, reps),
                            device=device)
        for i, r in enumerate(ranks[0]):
            r["cpu_s_per_call"] = sum(rk[i]["cpu_s_per_call"] for rk in ranks)
        rows += ranks[0]
    base = {r["path"]: r["steps_per_s"] for r in rows if r["n_devices"] == 1}
    wbase = {r["path"]: r["n_envs"] / r["cpu_s_per_call"]
             for r in rows if r["n_devices"] == 1 and r["cpu_s_per_call"] > 0}
    for r in rows:
        b = base.get(r["path"])
        if b:
            r["efficiency_vs_linear"] = r["steps_per_s"] / (r["n_devices"] * b)
        wb = wbase.get(r["path"])
        if wb and r["cpu_s_per_call"] > 0:
            r["efficiency_device_work"] = (
                (r["n_envs"] / r["cpu_s_per_call"]) / wb)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one rank per CUDA device over NCCL; cpu: "
                         "gloo CPU processes (a proxy)")
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="world sizes to sweep (default 1 2 4 8, clipped "
                         "to the CUDA devices on cuda)")
    ap.add_argument("--envs-per-device", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--solve-split", action="store_true",
                    help="time the replicated re-solve against the "
                         "sharded one (see the module docstring)")
    ap.add_argument("--json-out", type=str, default=None)
    args = ap.parse_args(argv)
    counts = args.devices or [1, 2, 4, 8]
    proxy = args.device == "cpu"
    where = "cpu (gloo processes)"
    if not proxy:
        import torch
        if not torch.cuda.is_available():
            print("bench_scaling: --device cuda needs a CUDA device and none "
                  "is present; pass --device cpu for the gloo CPU proxy")
            return 2
        counts = [n for n in counts if n <= torch.cuda.device_count()]
        where = card()
    if args.solve_split:
        from ..parallel import mesh as pmesh
        rows = []
        for n in counts:
            rows += pmesh.spawn(solve_split, n, (SOLVE_SHAPES, 10, 5),
                                device=args.device)[0]
    else:
        n_steps = args.steps or (50 if args.quick else 200)
        rows = sweep(counts, args.envs_per_device, n_steps,
                     reps=2 if args.quick else 3, device=args.device)
    for r in rows:
        r.update(device=where, proxy=proxy)
        print(json.dumps(r))
    summary = {"metric": "scaling_efficiency", "device": where,
               "proxy": proxy, "device_counts": counts, "rows": rows}
    if args.solve_split:
        summary["metric"] = "solve_split"
    else:
        summary.update(envs_per_device=args.envs_per_device,
                       min_efficiency=min(
                           (r["efficiency_vs_linear"] for r in rows
                            if r["n_devices"] > 1), default=1.0))
    print(json.dumps(summary))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
