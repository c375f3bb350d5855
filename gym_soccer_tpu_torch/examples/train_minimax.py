"""Minimax-Q self-play at 8192 envs on one GPU: the port's twin of
examples/train_minimax_tpu.py, with every mode and flag of it but
``--interpret`` (the port has no interpret mode: ``--device cpu`` runs the
kernels' plain versions), and ``--device`` (default ``cuda``).

* default: the HBM-table learner (agents/learners ``minimax_train``) in
  chunks of ``--chunk`` steps, with ``--ckpt`` save/resume of its state;
  its draws are the engine's threefry streams (on the card the step is
  kernel S1 and the learner's action draw kernel T1), the re-solve is R1;
* ``--fused``: ``fused_minimax_train`` (K5) with an exact ``--ckpt``
  resume; ``--multigrid [--with-big]``: the mixture trainer (K6);
  ``--converge [--grid W H]``: the equilibrium recipe;
  ``--best-response player_a|player_b``: the single-agent trainer.

Each ends with ``eval_episode_stats``: the learned mixed strategies
played against each other on the threefry engine.

Run: python -m gym_soccer_tpu_torch.examples.train_minimax [--steps 20000]
     [--envs 8192]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..agents import learners
from ..agents.evaluation import exploitability
from ..config import EnvConfig
from ..core import batch, tables, threefry
from ..ops import threefry_kernel
from ..utils import checkpoint
from ..utils.metrics import chunk_stats
from ..utils.profiling import Throughput, log_json


def eval_episode_stats(cfg, pi_a, pi_b, n_envs=1024, n_steps=400, seed=7,
                       device="cuda"):
    """Play the mixed strategies against each other for ``n_steps`` on
    ``n_envs`` lanes of the threefry engine from ``key(seed + 1)``, the
    actions sampled from ``uniform(fold_in(key(seed), i), (2, n_envs))``
    (on the card one launch of T1's keyed entry a step, and the step one
    launch of S1); the episode aggregates (utils/metrics) as the JAX
    example reports them (the reference main()'s 1000-episode eval loop,
    batched)."""
    device = torch.device(device)
    pi_a = torch.as_tensor(pi_a, device=device)
    pi_b = torch.as_tensor(pi_b, device=device)
    key = threefry.key(seed, device)

    def policy_fn(obs, i):
        u = threefry_kernel.keyed_uniform(key, i, (2, obs.shape[0]))
        obs = obs.long()
        return (learners._sample_mixed(pi_a[obs], u[0]),
                learners._sample_mixed(pi_b[obs], u[1]))

    st = batch.init(cfg, threefry.key(seed + 1), n_envs, device)
    _, out = batch.rollout(cfg, st, policy_fn, n_steps)
    s = chunk_stats(out)
    s = type(s)(*(x.item() if isinstance(x, torch.Tensor) else x for x in s))
    return {"episodes": int(s.episodes), "goals": int(s.goals),
            "truncations": int(s.truncations),
            "win_rate_a": round(s.win_rate_a, 4),
            "mean_reward_a": round(s.mean_reward_a, 4),
            "mean_length": round(s.mean_length, 2)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--fused", action="store_true",
                    help="use the fused learner kernel "
                         "(ops/learner_kernel.py, K5)")
    ap.add_argument("--multigrid", action="store_true",
                    help="train ONE concatenated table over a mixed "
                         "5x4+6x5 batch through the fused multigrid "
                         "kernel and report per-variant exploitability")
    ap.add_argument("--with-big", action="store_true",
                    help="with --multigrid: make the mixture 5x4 + the "
                         "reference's 11x7 big grid (nS=11705); "
                         "per-variant exploitability uses the segmented "
                         "solvers")
    ap.add_argument("--converge", action="store_true",
                    help="run the verified equilibrium recipe (2.1B "
                         "steps): lr=1.0 Bellman-backup phase then "
                         "polynomial anneal")
    ap.add_argument("--grid", type=int, nargs=2, default=(5, 4),
                    metavar=("W", "H"),
                    help="board size for --converge (default 5 4); "
                         "'--grid 11 7' runs the reference's big grid "
                         "with the round-5 avg_q recipe and segmented "
                         "evaluation")
    ap.add_argument("--best-response", choices=["player_a", "player_b"],
                    default="",
                    help="SINGLE-AGENT mode: train the given side as a "
                         "fused best response against a frozen random "
                         "opponent (the reference main()'s training "
                         "shape); reports the gap to the exact "
                         "best-response value and the eval win rate")
    return ap.parse_args(argv)


def best_response(args, device):
    from ..agents.evaluation import best_response_value, start_value
    from ..ops import learner_kernel as lk
    from ..utils.policies import get_random_policy_array
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    side = args.best_response
    nS = tables.build_statespace(cfg).nS
    opp = get_random_policy_array(nS, 5, seed=42)
    n_chunks = max(2, args.steps // 32)
    t0 = time.perf_counter()
    q, v, pa, pb, hist = lk.fused_best_response_train(
        cfg, opp, side, batch=args.envs, n_chunks=n_chunks, chunk_len=32,
        lr=1.0, eps=0.3, eps_halflife=8 * n_chunks, eps_min=0.05,
        lr_anneal_start=n_chunks // 2, lr_anneal_tau=25.0, device=device)
    dt = time.perf_counter() - t0
    steps = n_chunks * 32 * args.envs
    opp_oh = torch.as_tensor(np.eye(5, dtype=np.float32)[np.asarray(opp)],
                             device=device)
    v_br, _ = best_response_value(cfg, opp_oh, side)
    sign = 1.0 if side == "player_a" else -1.0
    gap = float((v - sign * v_br).abs().mean())
    log_json(event="finished_best_response", side=side, env_steps=steps,
             seconds=round(dt, 1), env_steps_per_s=round(steps / dt),
             start_value=round(start_value(cfg, v), 4),
             mean_gap_to_exact_br=round(gap, 4))
    log_json(event="eval_episode_stats",
             **eval_episode_stats(cfg, pa, pb, device=device))


def multigrid(args, device):
    from ..ops import learner_kernel as lk
    cfgs = (EnvConfig(5, 4, 0.2),
            EnvConfig(11, 7, 0.2) if args.with_big else EnvConfig(6, 5, 0.2))
    n_chunks = max(2, args.steps // 64)
    t0 = time.perf_counter()
    q, v, pa, pb, hist = lk.fused_minimax_train(
        cfgs, batch=args.envs, n_chunks=n_chunks, chunk_len=64, lr=1.0,
        eps=0.2, lr_anneal_start=n_chunks // 2, lr_anneal_tau=25.0,
        lr_anneal_pow=1.5, final_solver_iters=2000, device=device,
        chunks_per_dispatch=8 if device.type == "cuda" else 1)
    dt = time.perf_counter() - t0
    steps = n_chunks * 64 * args.envs
    off, per_variant = 0, {}
    for c in cfgs:
        nS = tables.build_statespace(c).nS
        seg = 200 if c.width * c.height > 40 else 0
        ex = exploitability(c, pa[off:off + nS], pb[off:off + nS],
                            segment_iters=seg)
        per_variant[f"{c.width}x{c.height}"] = round(float(ex), 4)
        off += nS
    log_json(event="finished_multigrid", env_steps=steps,
             seconds=round(dt, 1), env_steps_per_s=round(steps / dt),
             exploitability_per_variant=per_variant)


def converge(args, device):
    from ..ops import learner_kernel as lk
    w, h = args.grid
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    big = (w, h) != (5, 4)
    if big:
        kw = dict(n_chunks=6000, eps=0.25, eps_halflife=40000, eps_min=0.15,
                  lr_anneal_start=2500, lr_anneal_tau=160.0,
                  lr_anneal_pow=1.2, solver_iters=600, avg_after=4000,
                  avg_q=True, seed=2)
    else:
        kw = dict(n_chunks=1000, eps=0.2, lr_anneal_start=500,
                  lr_anneal_tau=25.0, lr_anneal_pow=1.5, solver_iters=400,
                  seed=1)
    t0 = time.perf_counter()
    q, v, pa, pb, hist = lk.fused_minimax_train(
        cfg, batch=65536, chunk_len=32, lr=1.0, final_solver_iters=3000,
        device=device, chunks_per_dispatch=8 if device.type == "cuda" else 1,
        **kw)
    dt = time.perf_counter() - t0
    steps = kw["n_chunks"] * 32 * 65536
    ex = exploitability(cfg, pa, pb, segment_iters=200 if big else 0)
    log_json(event="finished_converge", grid=f"{w}x{h}", env_steps=steps,
             seconds=round(dt, 1), env_steps_per_s=round(steps / dt),
             exploitability=round(float(ex), 5))
    log_json(event="eval_episode_stats",
             **eval_episode_stats(cfg, pa, pb, device=device))


def fused(args, device):
    """K5 with an exact ``--ckpt`` resume: the checkpoint holds the
    trainer's resume dict and the anneal anchor of the first segment, so a
    resumed run equals an uninterrupted one at the combined step count bit
    for bit."""
    from ..ops import learner_kernel as lk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    n_chunks = max(1, args.steps // 64)
    start, init_tabs, fields0, packed0 = 0, None, None, None
    anneal_start = n_chunks // 2
    if args.ckpt and os.path.exists(args.ckpt):
        nS = tables.build_statespace(cfg).nS
        f32 = dict(dtype=torch.float32, device=device)
        tmpl = {"q": torch.zeros((nS, 5, 5), **f32),
                "v": torch.zeros(nS, **f32),
                "pi_a": torch.zeros((nS, 5), **f32),
                "pi_b": torch.zeros((nS, 5), **f32),
                "n": torch.zeros((nS, 5, 5), **f32),
                "fields": lk.init_state_fields(cfg, args.envs, device),
                "next_chunk": 0, "lr_anneal_start": 0, "packed": True}
        r = checkpoint.load_pytree(args.ckpt, tmpl)
        start = r["next_chunk"]
        anneal_start = r["lr_anneal_start"]
        init_tabs = (r["q"], r["v"], r["pi_a"], r["pi_b"], r["n"])
        fields0 = r["fields"]
        # resume under the layout the checkpoint was stepped with
        packed0 = r["packed"]
        log_json(event="resumed_fused", chunk=start,
                 env_steps=start * 64 * args.envs,
                 lr_anneal_start=anneal_start)
    if start >= n_chunks:
        log_json(event="already_complete", chunk=start,
                 target_chunks=n_chunks,
                 hint="re-run with a larger --steps to continue")
        return
    t0 = time.perf_counter()
    q, v, pa, pb, hist, res = lk.fused_minimax_train(
        cfg, batch=args.envs, n_chunks=n_chunks - start, chunk_len=64,
        lr=1.0, eps=0.2, lr_anneal_start=anneal_start, lr_anneal_tau=25.0,
        lr_anneal_pow=1.5, final_solver_iters=2000, start_chunk=start,
        init=init_tabs, fields_init=fields0, packed=packed0,
        return_state=True, device=device)
    if args.ckpt:
        res = dict(res, lr_anneal_start=anneal_start)
        checkpoint.save_pytree(args.ckpt, res)
        log_json(event="checkpointed", path=args.ckpt,
                 chunk=int(res["next_chunk"]))
    dt = time.perf_counter() - t0
    steps = (n_chunks - start) * 64 * args.envs
    log_json(event="finished_fused", env_steps=steps, seconds=round(dt, 1),
             env_steps_per_s=round(steps / dt), v_min=float(v.min()),
             v_max=float(v.max()),
             exploitability=round(float(exploitability(cfg, pa, pb)), 4))
    log_json(event="eval_episode_stats",
             **eval_episode_stats(cfg, pa, pb, device=device))


def default(args, device):
    """The HBM-table learner in chunks of ``--chunk`` steps; on the card
    each chunk replays a CUDA graph of 64 steps (one re-solve period) as
    often as it fits (``learners.GROUP_STEPS``)."""
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    lcfg = learners.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=64,
                                   solver_iters=200,
                                   lr_halflife=args.steps // 5,
                                   eps_halflife=args.steps // 3)
    state = learners.minimax_init(cfg, threefry.key(0), args.envs, device)
    if args.ckpt and os.path.exists(args.ckpt):
        state = checkpoint.load_pytree(args.ckpt, state)
        log_json(event="resumed", step=int(state.step))

    # The first chunk also builds and loads the kernels (S1, T1, R1).
    t_first = time.perf_counter()
    state, td = learners.minimax_train(cfg, lcfg, state, args.chunk)
    float(td.mean())
    log_json(event="compiled",
             seconds=round(time.perf_counter() - t_first, 1))

    tp = Throughput()
    done = int(state.step)
    while done < args.steps:
        state, td = learners.minimax_train(cfg, lcfg, state, args.chunk)
        done = int(state.step)
        tp.tick(args.chunk * args.envs)
        log_json(step=done, mean_abs_td=round(float(td.mean()), 5),
                 v_max=round(float(state.v.abs().max()), 4),
                 **tp.summary())
        if args.ckpt:
            checkpoint.save_pytree(args.ckpt, state)

    log_json(event="finished", steps=done, v_min=float(state.v.min()),
             v_max=float(state.v.max()),
             exploitability=round(
                 float(exploitability(cfg, state.pi_a, state.pi_b)), 4),
             **tp.summary())
    log_json(event="eval_episode_stats",
             **eval_episode_stats(cfg, state.pi_a, state.pi_b,
                                  device=device))


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if args.best_response:
        best_response(args, device)
    elif args.multigrid:
        multigrid(args, device)
    elif args.converge:
        converge(args, device)
    elif args.fused:
        fused(args, device)
    else:
        default(args, device)


if __name__ == "__main__":
    main()
