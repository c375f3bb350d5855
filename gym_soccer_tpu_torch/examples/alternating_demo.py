"""The alternating-turn game end to end: solve, learn and play.  The
port's twin of examples/alternating_demo.py, printing its events with
the same keys:

1. build the tabular dynamics (``build_alt_tables``);
2. solve the zero-sum turn game exactly by turn-based minimax value
   iteration (max at A-to-move states, min at B-to-move states);
3. train the turn-based Q-learner in batched self-play (the HBM-table
   learner ``altq_init``/``altq_train`` on its schedule, or with
   ``--fused`` ``fused_altq_train``: kernel K10 on the card) and report
   its value error against the exact solution;
4. play batched closed-loop matches (``alt_policy_rollout``): minimax
   against itself, and the best response to a frozen random opponent.

    python -m gym_soccer_tpu_torch.examples.alternating_demo [--quick]
        [--fused] [--device cpu]

``--device`` defaults to cuda.
"""
import argparse

import numpy as np
import torch

from ..agents import learners
from ..config import EnvConfig
from ..core import threefry
from ..envs.soccer_alternating_env import (alt_policy_rollout,
                                           alt_value_iteration,
                                           build_alt_tables)
from ..utils.profiling import log_json, phase, phase_report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="shorter learner run (CI smoke)")
    ap.add_argument("--fused", action="store_true",
                    help="train with the fused kernel (ops/altq_kernel)")
    ap.add_argument("--device", default="cuda",
                    help="where the learner and the matches run (default "
                         "cuda; cpu runs the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)

    with phase("table_build", sync=False):
        tb = build_alt_tables(cfg)
    log_json(event="tables", nS=tb.nS)

    with phase("minimax_vi", sync=False):
        pi_star, v_star, _, sweeps = alt_value_iteration(tb)
    log_json(event="solved", sweeps=sweeps,
             v_abs_max=round(float(np.abs(v_star).max()), 4))

    # --- batched Q-learning self-play vs the exact solution -------------
    if args.fused:
        from ..ops.altq_kernel import fused_altq_train
        n_chunks = 60 if args.quick else 400
        envs = 8192 if args.quick else 65536
        with phase("altq_train_fused"):
            q, _ = fused_altq_train(
                cfg, batch=envs, n_chunks=n_chunks, chunk_len=32, lr=1.0,
                eps=0.25, eps_min=0.1, eps_halflife=300_000,
                lr_anneal_start=n_chunks // 2, lr_anneal_tau=25.0,
                lr_anneal_pow=1.5, seed=1, device=device)
        env_steps = envs * n_chunks * 32
    else:
        schedule = ([(0.25, 0.3, 3000)] if args.quick else
                    [(0.25, 0.3, 20000), (0.1, 0.2, 20000),
                     (0.03, 0.1, 20000)])
        st = learners.altq_init(cfg, threefry.key(0), 256, device)
        with phase("altq_train"):
            for lr, eps, n in schedule:
                lcfg = learners.AltQConfig(lr=lr, gamma=0.99, eps=eps)
                st, _ = learners.altq_train(cfg, lcfg, st, n)
        q = st.q
        env_steps = sum(n for _, _, n in schedule) * 256
    q = q.cpu().numpy()
    v_learned = np.where(tb.turn == 0, q.max(-1), q.min(-1))
    err = np.abs(v_learned - v_star)
    log_json(event="learned", env_steps=env_steps,
             v_err_mean=round(float(err.mean()), 4),
             v_err_max=round(float(err.max()), 4))

    # --- closed-loop matches --------------------------------------------
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pi_star, pi_star,
                                  batch=256, steps=400, seed=1,
                                  device=device)
    log_json(event="minimax_selfplay", wins_a=w, wins_b=l, truncations=tr)

    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    pi_br, _, _, _ = alt_value_iteration(tb, frozen_b=randpol)
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pi_br, randpol,
                                  batch=256, steps=400, seed=2,
                                  device=device)
    log_json(event="best_response_vs_random", wins=w, losses=l,
             truncations=tr,
             win_rate=round(w / max(w + l + tr, 1), 4))

    phase_report()


if __name__ == "__main__":
    main()
