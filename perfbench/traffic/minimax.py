"""Traffic kind ``minimax``: the configuration's minimax-Q recipe trained
back to back with ``fused_minimax_train``, each training ending in a
synchronise; with the parameter ``evaluate`` each training is followed by
``exploitability`` of the policies it returns, which makes a unit the
wall time to a trained and verified policy (``contract_s``), else a unit
is lane-steps trained (``learner_steps_per_s``).

Trainings in a window use the seeds base, base + 1, ... (mod
``SEED_SPAN``), base drawn from the run's seed: the trainer's chunk seeds
(seed * 1_000_003 + chunk) must fit int32.  With ``seed_pool`` = [first,
count] they cycle through the pool's seeds instead, from an offset drawn
from the run's seed: where a unit's work depends on its seed (the
evaluation's sweeps depend on the policies), every run then does the same
work in another order.

Checked after the window, on ``sampled_units`` trainings drawn from the
seed, by the plain reference (``perfbench/reference/``):

* ``q_step_gap``, ``step_fields_wrong``, ``step_counts_wrong``: chunks
  followed by the reference from the program's state (``learner.chunk``,
  float64): ``followed_chunks`` chunks spread evenly from the first, from
  the recipe's start, to the last of the sampled training, each from the
  program's state after the chunk before it, which the check gets by
  running the same training that many chunks long (the trainer is
  deterministic: its state after k chunks is the window's own).  The Q
  table after the chunk against the reference's (the worst cell's
  absolute gap), the lanes' fields exactly, and each cell's visit count
  exactly to the float32 rounding of the program's counts;
* ``exploitability``: the reference's best-response evaluation of the
  returned policies;
* ``published_exploitability``: the same evaluation of the program's
  training at the seed the configuration's published contract names
  (``contract.seed``; the window's own training where the window holds
  it, else one more training), held to that contract's limit;
* ``visits_rel_off``: |sum of the trainer's lifetime visit counts -
  lanes x steps x chunks| over lanes x steps x chunks: every chunk's
  lane-steps counted once (the counts are float32, so past 2**24 a cell's
  count rounds: sound runs read a few 1e-8);
* ``r1_gap``: R1's solves, re-solved by the reference's RM+ in float64 on
  the same Q: the last in-loop solve (the resume state's Q, v and
  policies, ``solver_iters``) and, where the recipe re-solves the final Q
  without averaging, the returned one (``final_solver_iters``); the worst
  game's |v - v_ref| and |x^T Q y - v_ref|;
* ``exp_gap`` (with ``evaluate``): |the port's exploitability reading -
  the reference's| on the same policies.
"""
from __future__ import annotations

import torch

from perfbench.harness import program as prog
from perfbench.harness.context import Check
from perfbench.reference import game, learner, markov

SEED_SPAN = 2000
RES_KEYS = ("q", "v", "pi_a", "pi_b", "n", "fields")


def setup(ctx) -> None:
    P, c = ctx.program, ctx.cell.config
    # a shortened run's parameters replace the recipe's
    recipe = {k: ctx.params.get(k, v) for k, v in c["recipe"].items()}
    board = game.Board.from_config(c["board"])
    ctx.state.update(cfg=prog.env_config(P, c["board"]), board=board,
                     recipe=recipe, contract=c["contract"],
                     evaluate=bool(ctx.params.get("evaluate", False)),
                     seeds=_seeds(ctx))
    # warm-up: the libraries, the tables, a capture of the recipe's group
    # at its lanes, the final solve, the averaging where the recipe has it,
    # and an evaluation
    warm = dict(recipe, n_chunks=min(recipe["n_chunks"],
                                     int(ctx.params.get("warmup_chunks", 16))))
    if warm.get("avg_after"):
        warm["avg_after"] = warm["n_chunks"] // 2
    out = P.fused_minimax_train(ctx.state["cfg"], **warm,
                                seed=ctx.state["seeds"](0), device=ctx.device,
                                return_state=True)
    if ctx.state["evaluate"]:
        P.exploitability(ctx.state["cfg"], out[2], out[3],
                         gamma=c["contract"]["gamma"],
                         segment_iters=c["contract"]["segment_iters"])


def _seeds(ctx):
    """unit index -> trainer seed."""
    pool = ctx.params.get("seed_pool")
    if pool:
        first, count = pool
        off = int(ctx.rng(1).integers(0, count))
        return lambda i: first + (off + i) % count
    base = int(ctx.rng(1).integers(0, SEED_SPAN))
    return lambda i: (base + i) % SEED_SPAN


def window(ctx, seconds: float) -> None:
    P, st = ctx.program, ctx.state
    cfg, recipe, con = st["cfg"], st["recipe"], st["contract"]
    t0 = ctx.begin_window()
    while True:
        u = ctx.new_unit()
        seed = st["seeds"](u.index)
        timing = {} if ctx.tracer is not None else None
        sync = not st["evaluate"] or ctx.tracer is not None
        with ctx.span(u, "train_call", sync=sync):
            q, v, pa, pb, _, res = P.fused_minimax_train(
                cfg, **recipe, seed=seed, device=ctx.device,
                return_state=True, timing=timing)
        u.data.update(seed=seed, q=q, v=v, pi_a=pa, pi_b=pb, timing=timing,
                      res={k: res[k] for k in RES_KEYS})
        if st["evaluate"]:
            with ctx.span(u, "eval_call", sync=True):
                u.data["exploitability"] = P.exploitability(
                    cfg, pa, pb, gamma=con["gamma"],
                    segment_iters=con["segment_iters"])
        ctx.end_unit()
        if ctx.stop(t0, seconds):
            break
    dt = ctx.end_window(t0)
    steps = recipe["batch"] * recipe["chunk_len"] * recipe["n_chunks"]
    if st["evaluate"]:
        ctx.end_to_end["contract_s"] = dt / len(ctx.units)
    else:
        ctx.end_to_end["learner_steps_per_s"] = len(ctx.units) * steps / dt


def r1_gap(q, v, x, y, iters: int) -> float:
    """The worst game's distance of the program's solve (v, x, y) of ``q``
    from the reference's RM+ value after ``iters`` rounds."""
    q64 = q.double()
    v_ref, _, _ = markov.rmplus(q64, iters)
    return max(float((v.double() - v_ref).abs().max()),
               float((markov.game_value(q64, x, y) - v_ref).abs().max()))


def start_state(st, ss, device) -> dict:
    """The trainer's documented start: Q and v 0, uniform policies, no
    visits, lane i on initial-state entry i % nI at t = 0."""
    nS, B = ss.nS, st["recipe"]["batch"]
    f32 = dict(dtype=torch.float32, device=device)
    return {"q": torch.zeros((nS, 5, 5), **f32),
            "v": torch.zeros(nS, **f32),
            "pi_a": torch.full((nS, 5), 0.2, **f32),
            "pi_b": torch.full((nS, 5), 0.2, **f32),
            "n": torch.zeros((nS, 5, 5), **f32),
            "fields": game.start_fields(st["board"], B, device)}


def step_readings(st, ss, before: dict, after: dict, seed: int, k: int,
                  dtype=torch.float64) -> dict:
    """Chunk ``k`` followed by the reference from the program's state
    ``before``, against the program's state ``after`` it."""
    B = st["recipe"]["batch"]
    q_ref, cnt, f_ref = learner.chunk(st["board"], ss.raw_to_dense, before,
                                      seed, k, st["recipe"], dtype)
    whole = all(f.shape == (B,) for f in after["fields"])
    fields_wrong = (sum(int((x.long() != y).sum())
                        for x, y in zip(after["fields"], f_ref))
                    if whole else 6 * B)
    n_ref = before["n"].double() + cnt
    counts_wrong = int(((after["n"].double() - n_ref).abs()
                        > 2.0 ** -23 * n_ref.clamp_min(1.0)).sum())
    return {"q_step_gap": float((after["q"].double() - q_ref.double())
                                .abs().max()),
            "step_fields_wrong": fields_wrong,
            "step_counts_wrong": counts_wrong}


def program_state(P, st, ctx, seed: int, n_chunks: int) -> dict:
    """The program's resume state after ``n_chunks`` chunks of the
    recipe."""
    res = P.fused_minimax_train(st["cfg"], **dict(st["recipe"],
                                                  n_chunks=n_chunks),
                                seed=seed, device=ctx.device,
                                return_state=True)[5]
    return {k: res[k] for k in RES_KEYS}


def check(ctx):
    P, st = ctx.program, ctx.state
    recipe, con = st["recipe"], st["contract"]
    n = len(ctx.units)
    k = min(n, int(ctx.params.get("sampled_units", 2)))
    picks = sorted(int(i) for i in ctx.rng(2).choice(n, k, replace=False))
    model = markov.Model(st["board"], ctx.device)
    N = recipe["n_chunks"]
    steps = recipe["batch"] * recipe["chunk_len"] * N
    final_resolve = (recipe.get("final_solver_iters")
                     and not recipe.get("avg_after"))
    lim = ctx.cell.limits
    names = ["q_step_gap", "step_fields_wrong", "step_counts_wrong",
             "exploitability", "visits_rel_off", "r1_gap"]
    if st["evaluate"]:
        names.append("exp_gap")
    worst = dict.fromkeys(names, 0.0)
    failed = 0
    for i in picks:
        d = ctx.units[i].data
        res, seed = d["res"], d["seed"]
        state = {N: res}

        def after(k):
            if k not in state:
                state[k] = (start_state(st, model.ss, ctx.device) if k == 0
                            else program_state(P, st, ctx, seed, k))
            return state[k]

        ks = followed(N, ctx.params.get("followed_chunks", 2))
        steps_got = [step_readings(st, model.ss, after(k), after(k + 1),
                                   seed, k) for k in ks]
        got = {key: max(s[key] for s in steps_got) for key in steps_got[0]}
        got.update(
            exploitability=markov.exploitability(
                model, d["pi_a"], d["pi_b"], gamma=con["gamma"]),
            visits_rel_off=abs(float(res["n"].double().sum()) - steps) / steps,
            r1_gap=r1_gap(res["q"], res["v"], res["pi_a"], res["pi_b"],
                          recipe["solver_iters"]))
        if final_resolve:
            got["r1_gap"] = max(got["r1_gap"], r1_gap(
                d["q"], d["v"], d["pi_a"], d["pi_b"],
                recipe["final_solver_iters"]))
        if st["evaluate"]:
            got["exp_gap"] = abs(d["exploitability"]
                                 - got["exploitability"])
        st.setdefault("readings", []).append(dict(
            got, seed=seed, chunks=[dict(s, chunk=k)
                                    for k, s in zip(ks, steps_got)]))
        failed += any(got[key] > lim[key] for key in names)
        for key in names:
            worst[key] = max(worst[key], got[key])
    checks = [Check(key, worst[key], lim[key]) for key in names]
    pub = published(ctx, model)
    st["published"] = pub
    checks.append(Check("published_exploitability", pub,
                        con["exploitability_max"]))
    return checks, failed + (pub > con["exploitability_max"])


def followed(n_chunks: int, count: int) -> list:
    """``count`` chunk indices spread evenly from 0 to ``n_chunks`` - 1."""
    if count < 2 or n_chunks < 2:
        return [0]
    return sorted({round(j * (n_chunks - 1) / (count - 1))
                   for j in range(count)})


def published(ctx, model) -> float:
    """The reference's exploitability of the program's training at the
    published contract's seed."""
    P, st = ctx.program, ctx.state
    seed = st["contract"]["seed"]
    own = [u.data for u in ctx.units if u.data["seed"] == seed]
    if own:
        pa, pb = own[0]["pi_a"], own[0]["pi_b"]
    else:
        pa, pb = P.fused_minimax_train(
            st["cfg"], **st["recipe"], seed=seed, device=ctx.device,
            return_state=True)[2:4]
    return markov.exploitability(model, pa, pb,
                                 gamma=st["contract"]["gamma"])


def control_program(program, cell, overrides=None,
                    dtype=torch.bfloat16):
    """The reference in the program's place at the precision below the
    configuration's float32: a training of the recipe's full length runs
    the program for all chunks but the last, then the reference's last
    chunk with its update in ``dtype`` (``learner.chunk``) and RM+ in
    ``dtype`` for the re-solve and the final solve; a shorter training
    (the check's reruns) is the program's, so the check reads the control
    from the window's own state.  With ``evaluate`` the evaluation is the
    reference's value iteration in ``dtype``."""
    from types import SimpleNamespace
    params = {**cell.params, **(overrides or {})}
    recipe = {k: params.get(k, v) for k, v in cell.config["recipe"].items()}
    full = recipe["n_chunks"]
    board = game.Board.from_config(cell.config["board"])
    ss = markov.StateSpace(board)

    def train(cfg, **kw):
        if kw["n_chunks"] != full or full < 2:
            return program.fused_minimax_train(cfg, **kw)
        kw = dict(kw, return_state=True)
        q, v, pa, pb, hist, res = program.fused_minimax_train(
            cfg, **dict(kw, n_chunks=full - 1))
        q2, cnt, fields = learner.chunk(board, ss.raw_to_dense, res,
                                        kw["seed"], full - 1, recipe, dtype)
        v2, x2, y2 = markov.rmplus(q2, kw["solver_iters"], dtype)
        res = dict(res, q=q2.float(), v=v2.float(), pi_a=x2.float(),
                   pi_b=y2.float(), n=res["n"] + cnt.float(),
                   fields=tuple(f.to(torch.int32) for f in fields),
                   next_chunk=full)
        if kw.get("final_solver_iters") and not kw.get("avg_after"):
            v, pa, pb = (t.float() for t in markov.rmplus(
                q2, kw["final_solver_iters"], dtype))
        return q2.float(), v, pa, pb, hist, res

    def evaluation(cfg, pi_a, pi_b, gamma=0.99, segment_iters=0):
        b = game.Board(cfg.width, cfg.height, cfg.slip_prob, cfg.max_steps)
        m = markov.Model(b, pi_a.device, dtype=dtype)
        return markov.exploitability(m, pi_a, pi_b, gamma, max_sweeps=5000)

    out = {"fused_minimax_train": train}
    if params.get("evaluate"):
        out["exploitability"] = evaluation
    return SimpleNamespace(**{**vars(program), **out})
