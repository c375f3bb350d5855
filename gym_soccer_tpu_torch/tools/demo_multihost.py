"""Multi-process data-parallel training, shown with real process
boundaries: the port's twin of tools/demo_multihost.py.

1. baseline: ONE process runs the data-parallel minimax-Q training call
   (parallel/mesh ``sharded_minimax_train_fn``) over the whole batch, on
   a mesh of one rank;
2. distributed: TWO processes, each one rank of a gloo group joined
   through a ``FileStore`` in a temporary directory, run the same global
   computation, each on its block of the lanes;
3. the parent checks that the two ranks agree bit for bit (they hold one
   replicated table) and that both agree with the baseline within 1e-6
   relative: every instance steps the same stream on one rank or two
   (global-id keys), but the float32 sums of a step's TDs are added in
   another order when the lanes are split.

    python -m gym_soccer_tpu_torch.tools.demo_multihost [--device cpu]
    python -m gym_soccer_tpu_torch.tools.demo_multihost --worker I N STORE

``--device`` defaults to cuda: rank r sits on cuda:(r % cards), so on a
machine with one card both ranks share it, over gloo with CUDA tensors.
A gloo collective cannot be captured in a CUDA graph, and none has to be:
the ``TRAIN_STEPS`` steps are fewer than one of the learner's replays
(``learners.GROUP_STEPS``), so they run step by step.  Without a CUDA
device the default is refused before any process starts (exit code 2).
Prints ``MULTIHOST OK`` or ``MULTIHOST MISMATCH`` and exits 0 or 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

N_ENVS = 64
TRAIN_STEPS = 12
WORKER_TIMEOUT = 420


def initial_q(nS: int):
    """The deterministic NONZERO start table (tools/demo_multihost.py:63-
    66), so that every step moves the tables: q = (arange % 17) * 1e-2 and
    v its mean over the joint actions, float32 numpy."""
    import numpy as np
    q0 = ((np.arange(nS * 25, dtype=np.float32).reshape(nS, 5, 5) % 17)
          * np.float32(1e-2))
    return q0, q0.mean(axis=(1, 2), dtype=np.float32)


def run_training(mesh, tag: str) -> dict:
    """The data-parallel minimax-Q call on ``mesh``: ``TRAIN_STEPS`` steps
    over ``N_ENVS`` global instances from ``initial_q``.  Returns the
    TD summary (averaged over the ranks) and sum |q| (replicated)."""
    import torch

    from ..agents import learners
    from ..config import EnvConfig
    from ..core import threefry
    from ..parallel import mesh as pmesh

    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    lcfg = learners.MinimaxQConfig(resolve_every=2)
    nS = 761
    q0, v0 = initial_q(nS)
    f32 = dict(dtype=torch.float32, device=mesh.device)
    state = learners.MinimaxQState(
        q=torch.tensor(q0, **f32), v=torch.tensor(v0, **f32),
        pi_a=torch.full((nS, 5), 0.2, **f32),
        pi_b=torch.full((nS, 5), 0.2, **f32),
        env=pmesh.sharded_init(cfg, mesh, threefry.key(0), N_ENVS),
        step=torch.zeros((), dtype=torch.int32, device=mesh.device),
        n=torch.zeros((nS, 5, 5), **f32))
    train = pmesh.sharded_minimax_train_fn(cfg, lcfg, mesh, TRAIN_STEPS)
    state, td = train(state)
    return {"tag": tag, "td": [float(x) for x in td],
            "q_l1": float(state.q.abs().sum()), "world": mesh.world}


def worker(rank: int, world: int, store: str, device: str) -> None:
    import torch

    from ..parallel import mesh as pmesh
    if device == "cpu":
        torch.set_num_threads(1)
    pmesh.distributed_init(f"file://{store}", world, rank, backend="gloo",
                           device=device)
    try:
        out = run_training(pmesh.env_mesh(world, device=device),
                           f"proc{rank}/{world}")
    finally:
        torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)


def _command(*args) -> list:
    return [sys.executable, "-m", "gym_soccer_tpu_torch.tools.demo_multihost",
            *map(str, args)]


def parent(device: str) -> int:
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("demo_multihost: --device cuda needs a CUDA device and none is "
              "present; pass --device cpu to run the ranks as gloo CPU "
              "processes")
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    # 1. one process over the whole batch
    base = subprocess.run(_command("--baseline", "--device", device),
                          capture_output=True, text=True, timeout=600,
                          env=env)
    baseline = _extract(base.stdout)
    if base.returncode or not baseline:
        print(f"baseline failed:\n{base.stdout}\n{base.stderr}")
        return 1
    # 2. two processes, one rank each.  A failure or a timeout kills both
    # workers by their PIDs: a survivor would wait in gloo for ever.
    results, ok = [], True
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            _command("--worker", i, 2, store, "--device", device),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(2)]
        try:
            for p in procs:
                out, err = p.communicate(timeout=WORKER_TIMEOUT)
                r = _extract(out)
                if p.returncode or not r:
                    print(f"worker failed (rc={p.returncode}):\n{out}\n{err}")
                    return 1
                results.append(r)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    # 3a. the two ranks hold one replicated computation: bit for bit
    if (json.dumps(results[0]["td"]) != json.dumps(results[1]["td"])
            or results[0]["q_l1"] != results[1]["q_l1"]):
        ok = False
        print("MISMATCH between the two distributed processes")
    # 3b. one rank against two: within 1e-6 relative
    for r in results:
        for a, b in zip(baseline["td"] + [baseline["q_l1"]],
                        r["td"] + [r["q_l1"]]):
            if abs(a - b) > 1e-6 * max(abs(a), abs(b), 1e-3):
                ok = False
                print(f"MISMATCH {r['tag']}: {a} vs {b}")
    print(json.dumps({"baseline_1proc": baseline,
                      "distributed_2proc": results,
                      "placement_invariant": ok}, indent=2))
    print("MULTIHOST OK" if ok else "MULTIHOST MISMATCH")
    return 0 if ok else 1


def _extract(stdout: str):
    for line in stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "WORLD", "STORE"))
    ap.add_argument("--baseline", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, store = args.worker
        worker(int(rank), int(world), store, args.device)
        return 0
    if args.baseline:
        import torch

        from ..parallel import mesh as pmesh
        if args.device == "cpu":
            torch.set_num_threads(1)
        print("RESULT " + json.dumps(run_training(
            pmesh.env_mesh(device=args.device), "1proc")), flush=True)
        return 0
    return parent(args.device)


if __name__ == "__main__":
    sys.exit(main())
