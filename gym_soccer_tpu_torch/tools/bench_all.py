"""Every execution path of the port timed side by side, one JSON line a
row: the twin of the JAX package's tools/bench_all.py, with its 24 rows in
its order and under its names, each doing the JAX row's work at the JAX
row's sizes through the port's counterpart.

    python -m gym_soccer_tpu_torch.tools.bench_all [--quick] [--device cpu]

Timing (``timed``): a warm-up call, then the median of ``LEGS`` legs of
back-to-back calls, each leg at least ``MIN_LEG_MS`` long (``SLOW_LEGS``
legs where one call takes over a second), on CUDA events on the card and
on the host clock for the host rows (the facade, the table build) and on
the CPU.  The engine, learner and parity rows read a value back at the
end of each call (the JAX row's fetch), which synchronises.  A slope row
times one call of each of its two lengths that way and divides the extra
steps by the extra time; where the long call does not take longer, the
row fails.  The JAX tool's chained dispatches are not ported: a length is
one call.

Each line holds the JAX keys ``path``, ``env_steps_per_s`` and
``vs_reference`` (against ``REFERENCE_RATE``, the reference's own host
rate), the row's sizes, ``ms`` (median per call), ``calls`` (every call
the row made, warm-up included), a slope row's ``lengths``, ``short_ms``
and ``long_ms``, and the device and card (nvidia-smi's name and power
limit).  ``xla_batch_engine_traj`` adds a line of its first call's episode
statistics.  A row that raises prints ``{"path": ..., "error": ...}`` and
the sweep goes on; the exit code is then 1.

``--device cuda`` (the default) needs a CUDA device and exits 2 without
one; no row moves to the CPU.  With ``--device cpu`` the chunk and rollout
wrappers run their plain versions.  Each row function takes its sizes as
keyword arguments, the JAX row's by default (``--quick``: the JAX tool's
reduced ones).
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from ..config import EnvConfig
from .bench_scaling import card

CFG = EnvConfig(5, 4, 0.2)
REFERENCE_RATE = 2.7e4
LEGS = 5
SLOW_LEGS = 3
MIN_LEG_MS = 50.0
LANES_ONE_WAVE = 8192
LANES_WIDE = 32768
CHUNK_STEPS = 64
MIXTURE = (CFG, EnvConfig(6, 5, 0.1), EnvConfig(8, 6, 0.3))
EPS_INT = int(0.3 * 65536)


def timed(run, device, host: bool = False) -> dict:
    """``{"ms": median ms per call of run(), "calls": calls made}``: one
    warm-up call, one call to size the legs, then ``LEGS`` legs
    (``SLOW_LEGS`` past a second a call) of enough calls to last
    ``MIN_LEG_MS`` each.  CUDA events on a CUDA device unless ``host``;
    else the host clock."""
    events = torch.device(device).type == "cuda" and not host
    if events:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def leg(n: int) -> float:
        if events:
            e0.record()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        if events:
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1)
        return (time.perf_counter() - t0) * 1e3

    run()
    if events:
        torch.cuda.synchronize()
    one = leg(1)
    legs = SLOW_LEGS if one > 1000.0 else LEGS
    reps = max(1, math.ceil(MIN_LEG_MS / max(one, 1e-3)))
    per_call = [leg(reps) / reps for _ in range(legs)]
    return {"ms": statistics.median(per_call), "calls": 2 + legs * reps}


def rate(work: int, t: dict, **sizes) -> dict:
    """A row's result: ``work`` env-steps (or events) a call of ``t``."""
    return {"env_steps_per_s": work / (t["ms"] / 1e3), **sizes,
            "ms": t["ms"], "calls": t["calls"]}


def slope(call, lengths, units: int, device) -> dict:
    """A slope row: ``call(n)`` at each of the two ``lengths`` timed by
    ``timed``; the extra ``units`` x length over the extra time.  Raises
    where the long call is not slower."""
    short, long_ = (timed(lambda n=n: call(n), device) for n in lengths)
    if long_["ms"] <= short["ms"]:
        raise RuntimeError(
            f"the long leg ({lengths[1]}: {long_['ms']} ms a call) is not "
            f"longer than the short one ({lengths[0]}: {short['ms']} ms)")
    return {"env_steps_per_s": (lengths[1] - lengths[0]) * units
            / ((long_["ms"] - short["ms"]) / 1e3),
            "batch": units, "lengths": list(lengths),
            "short_ms": short["ms"], "long_ms": long_["ms"],
            "calls": short["calls"] + long_["calls"]}


def _key(seed: int, device):
    from ..core import threefry
    return threefry.key(seed, device)


# ----------------------------------------------------------------------
# Rows (tools/bench_all.py's functions, in its order)
# ----------------------------------------------------------------------

def bench_facade(device, quick=False, steps=None):
    """The host facade, 5x4 slip 0.2: ``steps`` all-stand steps a call,
    resetting where an episode ended."""
    from ..envs import SoccerSimultaneousEnv
    n = steps or (2000 if quick else 20000)
    env = SoccerSimultaneousEnv(width=5, height=4, slip_prob=0.2)
    env.reset(seed=0)

    def run():
        for _ in range(n):
            if env.needs_reset:
                env.reset()
            env.step({"player_a": 0, "player_b": 0})
    return rate(n, timed(run, device, host=True), steps=n)


def bench_xla(device, quick=False, batch=LANES_ONE_WAVE, steps=None):
    """``batch.rollout`` (the StepOut of every step stacked on the
    device) under ``random_policy_fn``, aggregated by ``chunk_stats``;
    kernel S1 and T1's keyed entry once a step on the card.  Also returns
    the first call's episode statistics (from the initial state)."""
    from ..core import batch as cb
    from ..utils.metrics import chunk_stats
    T = steps or (200 if quick else 1000)
    pol = cb.random_policy_fn(CFG, _key(1, device), batch)
    st = cb.init(CFG, _key(0, device), batch, device)
    first = []

    def run():
        nonlocal st
        st, out = cb.rollout(CFG, st, pol, T)
        stats = chunk_stats(out)
        float(stats.reward_a_sum)
        if not first:
            first.append(stats)
    row = rate(batch * T, timed(run, device), batch=batch, steps=T)
    s = first[0]
    row["episode_stats"] = {"episodes": int(s.episodes),
                            "goals": int(s.goals),
                            "mean_length": s.mean_length}
    return row


def _bench_stats_rollout(device, quick, rng, batch, steps):
    from ..core import batch as cb
    T = steps or (200 if quick else 1000)
    st = cb.init(CFG, _key(0, device), batch, device)
    first = []

    def run():
        nonlocal st
        st, acc = cb.random_rollout_stats(CFG, st, T, rng=rng)
        float(acc.reward_sum)
        if not first:
            first.append([float(x) for x in acc])
    row = rate(batch * T, timed(run, device), batch=batch, steps=T)
    row["first_stats"] = first[0]
    return row


def bench_xla_stats_threefry(device, quick=False, batch=LANES_ONE_WAVE,
                             steps=None):
    """``random_rollout_stats(rng="threefry")``: T1 and S1 a step; the
    first call's (reward_sum, goals, truncs) in ``first_stats``."""
    return _bench_stats_rollout(device, quick, "threefry", batch, steps)


def bench_xla_stats_counter(device, quick=False, batch=LANES_ONE_WAVE,
                            steps=None):
    """``random_rollout_stats(rng="counter")``: S1 a step."""
    return _bench_stats_rollout(device, quick, "counter", batch, steps)


def bench_multigrid(device, quick=False, batch=LANES_ONE_WAVE, steps=None):
    """The mixed-geometry engine on 5x4 0.2, 6x5 0.1 and 9x6 0.3 (the JAX
    row's boards), actions from ``uniforms(s, 2, salt=9)``: S2 and the
    policy's T1 draw a step on the card."""
    from ..core import multigrid
    T = steps or (200 if quick else 1000)
    cfgs = [EnvConfig(5, 4, 0.2), EnvConfig(6, 5, 0.1), EnvConfig(9, 6, 0.3)]
    st = multigrid.init(cfgs, _key(0, device), batch, device)

    def pol(s, i):
        u = multigrid.uniforms(s, 2, salt=9)
        return ((u[:, 0] * 5).to(torch.int32).clamp(max=4),
                (u[:, 1] * 5).to(torch.int32).clamp(max=4))

    def run():
        nonlocal st
        st, (r, g, tr) = multigrid.rollout(st, pol, T)
        float(r.sum())
    return rate(batch * T, timed(run, device), batch=batch, steps=T)


def bench_alternating(device, quick=False, batch=LANES_ONE_WAVE, steps=None):
    """The alternating-turn engine under the minimax value iteration's
    policy pair (``alt_value_iteration`` on the host, set-up): S3 and the
    policy's lookup a step on the card."""
    from ..envs.soccer_alternating_env import (
        alt_init, alt_raw_encode, alt_step, alt_value_iteration,
        build_alt_tables)
    T = steps or (200 if quick else 1000)
    tb = build_alt_tables(CFG)
    pi, _, _, _ = alt_value_iteration(tb, theta=1e-6)
    r2d = torch.as_tensor(tb.raw_to_dense, device=device).long()
    pol = torch.as_tensor(pi, device=device)
    st = alt_init(CFG, _key(0, device), batch, device=device)

    def run():
        nonlocal st
        rews = []
        for _ in range(T):
            raw2 = alt_raw_encode(torch, st.rows_a, st.cols_a, st.rows_b,
                                  st.cols_b, st.poss, st.turn, CFG)
            st, (rew, goal, trunc) = alt_step(CFG, st, pol[r2d[raw2.long()]],
                                              autoreset=True)
            rews.append(rew.sum())
        float(torch.stack(rews).sum())
    return rate(batch * T, timed(run, device), batch=batch, steps=T)


def bench_altq_learner(device, quick=False, batch=LANES_ONE_WAVE,
                       steps=None):
    """The HBM-table turn-based Q learner (``altq_train``, replayed as
    64-step CUDA graphs on the card: T1's action draw, S3 and A1 a
    step)."""
    from ..agents import learners
    T = steps or (100 if quick else 500)
    lcfg = learners.AltQConfig()
    st = learners.altq_init(CFG, _key(0, device), batch, device=device)

    def run():
        nonlocal st
        st, td = learners.altq_train(CFG, lcfg, st, T)
        float(td.sum())
    return rate(batch * T, timed(run, device), batch=batch, steps=T)


def _chunks(call, fields0, device, batch, chunks, steps):
    """``chunks`` chunk calls of ``steps`` steps a run from ``fields0``,
    each ``call(k, fields)``; reads the last chunk's int64 sums.  Raises
    where a chunk of the last run counted a value outside its exact
    range."""
    last = []

    def run():
        fields = fields0
        last.clear()
        for k in range(chunks):
            fields, acc, stats = call(k, fields)
            last.append(stats[3])
        int(acc[0].sum())
    row = rate(batch * steps * chunks, timed(run, device), batch=batch,
               steps=steps, chunks=chunks)
    bad = int(torch.stack(last).sum())
    if bad:
        raise RuntimeError(f"{bad} table values outside the chunks' exact "
                           "range")
    return row


def _uniform(n_states: int, device):
    return torch.full((n_states, 5), 0.2, dtype=torch.float32, device=device)


def minimax_table(cfg, packed: bool, device, opp_policy=None):
    """The JAX row's M in the port's layout: uniform pi (``opp_policy``'s
    one-hot columns for B, unexplored, where given), v = 0 (q = 0 for the
    unpacked table), eps 0.3."""
    from ..ops import learner_kernel as lk
    nS = lk.n_states(cfg)
    uni = _uniform(nS, device)
    v = torch.zeros(nS, device=device)
    if opp_policy is not None:
        opp = torch.as_tensor(np.asarray(opp_policy), device=device).long()
        oh = torch.nn.functional.one_hot(opp, 5).float()
        return lk.pack_m2(cfg, uni, oh, v, eps=0.3, eps_b=0.0)
    if packed:
        return lk.pack_m2(cfg, uni, uni, v, eps=0.3)
    return lk.pack_m(cfg, uni, uni, torch.zeros((nS, 5, 5), device=device),
                     v, eps=0.3)


def _bench_learner_chunks(device, cfg, packed, batch, chunks, steps,
                          opp_policy=None):
    from ..ops import learner_kernel as lk
    table = minimax_table(cfg, packed, device, opp_policy)
    if isinstance(cfg, tuple):
        planes, fields0 = lk.init_state_fields(cfg, batch, device)
        f = (lk.multigrid_packed_learner_chunk if packed
             else lk.multigrid_learner_chunk)
        call = lambda k, fl: f(cfg, k, table, planes, fl, batch,  # noqa: E731
                               steps)
    else:
        fields0 = lk.init_state_fields(cfg, batch, device)
        f = lk.packed_learner_chunk if packed else lk.learner_chunk
        call = lambda k, fl: f(cfg, k, table, fl, batch, steps)  # noqa: E731
    return _chunks(call, fields0, device, batch, chunks, steps)


def bench_pallas_minimax_learner(device, quick=False, batch=LANES_ONE_WAVE,
                                 chunks=None, steps=CHUNK_STEPS):
    """``learner_chunk`` (kernel K7), 16 chunks of 64 steps a call."""
    return _bench_learner_chunks(device, CFG, False, batch,
                                 chunks or (4 if quick else 16), steps)


def bench_pallas_minimax_learner_packed(device, quick=False,
                                        batch=LANES_WIDE, chunks=None,
                                        steps=CHUNK_STEPS):
    """``packed_learner_chunk`` (kernel K5) at 32768 lanes."""
    return _bench_learner_chunks(device, CFG, True, batch,
                                 chunks or (4 if quick else 16), steps)


def bench_pallas_learner_11x7(device, quick=False, batch=LANES_WIDE,
                              chunks=None, steps=CHUNK_STEPS):
    """``packed_learner_chunk`` (kernel K5) on the reference's 11x7."""
    return _bench_learner_chunks(device, EnvConfig(11, 7, 0.2), True, batch,
                                 chunks or (2 if quick else 8), steps)


def bench_pallas_br_learner(device, quick=False, batch=LANES_WIDE,
                            chunks=None, steps=CHUNK_STEPS):
    """``packed_learner_chunk`` (kernel K5) as the frozen-opponent best
    response: B's columns the one-hot of ``get_random_policy_array(761,
    5, 42)``, unexplored."""
    from ..utils.policies import get_random_policy_array
    from ..ops import learner_kernel as lk
    opp = get_random_policy_array(lk.n_states(CFG), 5, seed=42)
    return _bench_learner_chunks(device, CFG, True, batch,
                                 chunks or (4 if quick else 16), steps,
                                 opp_policy=opp)


def iql_table(device):
    """The JAX rows' zero IQL M (either layout) in the port's table."""
    from ..ops import iql_kernel as ik
    from ..ops import learner_kernel as lk
    z = torch.zeros((lk.n_states(CFG), 5), device=device)
    return ik.pack_iql_table(CFG, z, z)


def _bench_iql(device, packed, batch, chunks, steps):
    from ..ops import iql_kernel as ik
    table = iql_table(device)
    chunk = ik.iql_packed_chunk if packed else ik.iql_chunk
    fields0 = ik.init_iql_state_fields(CFG, batch, device)
    return _chunks(lambda k, fl: chunk(CFG, k, EPS_INT, table, fl, batch,
                                       steps, step_offset=k * steps),
                   fields0, device, batch, chunks, steps)


def bench_pallas_iql_learner(device, quick=False, batch=LANES_ONE_WAVE,
                             chunks=None, steps=CHUNK_STEPS):
    """``iql_chunk`` (kernel K9), eps 0.3, step offsets k * 64."""
    return _bench_iql(device, False, batch, chunks or (4 if quick else 16),
                      steps)


def bench_pallas_iql_learner_packed(device, quick=False, batch=LANES_WIDE,
                                    chunks=None, steps=CHUNK_STEPS):
    """``iql_packed_chunk`` (kernel K8) at 32768 lanes."""
    return _bench_iql(device, True, batch, chunks or (4 if quick else 16),
                      steps)


def bench_pallas_multigrid_learner(device, quick=False, batch=LANES_ONE_WAVE,
                                   chunks=None, steps=CHUNK_STEPS):
    """``multigrid_learner_chunk`` (kernel K7's multigrid site) on 5x4
    0.2, 6x5 0.1 and 8x6 0.3."""
    return _bench_learner_chunks(device, MIXTURE, False, batch,
                                 chunks or (4 if quick else 16), steps)


def bench_pallas_multigrid_packed(device, quick=False, batch=LANES_WIDE,
                                  chunks=None, steps=CHUNK_STEPS):
    """``multigrid_packed_learner_chunk`` (kernel K6) on the mixture."""
    return _bench_learner_chunks(device, MIXTURE, True, batch,
                                 chunks or (2 if quick else 8), steps)


def alt_table(device):
    """The JAX rows' zero turn-based M (either layout) in the port's
    table."""
    from ..envs.soccer_alternating_env import build_alt_tables
    from ..ops import altq_kernel as ak
    return ak.pack_alt_table(CFG, torch.zeros((build_alt_tables(CFG).nS, 5),
                                              device=device))


def _bench_altq(device, packed, batch, chunks, steps):
    from ..ops import altq_kernel as ak
    table = alt_table(device)
    chunk = ak.altq_packed_chunk if packed else ak.altq_chunk
    fields0 = ak.init_alt_state_fields(CFG, batch, device)
    return _chunks(lambda k, fl: chunk(CFG, k, EPS_INT, table, fl, batch,
                                       steps, step_offset=k * steps),
                   fields0, device, batch, chunks, steps)


def bench_pallas_altq_learner(device, quick=False, batch=LANES_ONE_WAVE,
                              chunks=None, steps=CHUNK_STEPS):
    """``altq_chunk`` (kernel K11)."""
    return _bench_altq(device, False, batch, chunks or (4 if quick else 16),
                       steps)


def bench_pallas_altq_learner_packed(device, quick=False, batch=LANES_WIDE,
                                     chunks=None, steps=CHUNK_STEPS):
    """``altq_packed_chunk`` (kernel K10) at 32768 lanes."""
    return _bench_altq(device, True, batch, chunks or (4 if quick else 16),
                       steps)


def bench_parity(device, quick=False, batch=LANES_ONE_WAVE, steps=None):
    """``core.parity.parity_rollout`` (plain PyTorch, one step at a time)
    on ``RandomState(0)``'s joint rows, lane i seeded i % 64."""
    from ..core import parity
    T = steps or (200 if quick else 1000)
    pt = parity.parity_tables(CFG)
    hi, lo = parity.gen_streams(np.arange(batch) % 64, 2 * T + 2, device)
    rows = torch.as_tensor(np.random.RandomState(0).randint(
        0, 25, size=(T, batch)).astype(np.int32), device=device)
    st0 = parity.parity_init(CFG, batch, device)

    def run():
        _, out = parity.parity_rollout(CFG, pt, st0, rows, hi, lo)
        float(out.reward_a.sum())
    return rate(batch * T, timed(run, device), batch=batch, steps=T)


def parity_policies():
    """The JAX tools' closed-loop policies: ``RandomState(1)``'s and
    ``RandomState(7)``'s actions a dense state."""
    from ..core import tables
    nS = tables.build_statespace(CFG).nS
    return tuple(np.random.RandomState(seed).randint(0, 5, nS)
                 .astype(np.int32) for seed in (1, 7))


def bench_parity_kernel(device, quick=False, batch=LANES_ONE_WAVE,
                        events=None):
    """``parity_events`` (kernel K12): the slope of events between two
    event counts, times the share of events that are transitions."""
    from ..ops import parity_kernel as pkm
    e_s, e_l = events or ((256, 512) if quick else (512, 1536))
    pol_a, pol_b = parity_policies()
    jr = torch.as_tensor(pkm.jointrow_raw(CFG, pol_a, pol_b), device=device)
    seeds = torch.as_tensor(np.arange(batch) % 997, device=device)
    steps = []

    def call(n):
        out = pkm.parity_events(CFG, seeds, jr, n, device)
        steps.append(int(out.steps.sum()))
    row = slope(call, (e_s, e_l), batch, device)
    share = steps[-1] / (e_l * batch)
    row["events_per_s"] = row["env_steps_per_s"]
    row["step_share"] = share
    row["env_steps_per_s"] *= share
    return row


def bench_pallas_multigrid(device, quick=False, batch=LANES_ONE_WAVE,
                           lengths=None):
    """``multigrid_rollout`` (kernel K3) on 5x4 0.2, 6x5 0.1, 8x6 0.3."""
    from ..ops import step_kernel as sk
    return slope(lambda n: sk.multigrid_rollout(MIXTURE, 1, batch, n, device),
                 lengths or ((1000, 5000) if quick else (2000, 20000)),
                 batch, device)


def bench_pallas(device, quick=False, batch=LANES_ONE_WAVE, lengths=None):
    """``fused_rollout`` (kernel K1)."""
    from ..ops import step_kernel as sk
    return slope(lambda n: sk.fused_rollout(CFG, 1, batch, n, device),
                 lengths or ((1000, 5000) if quick else (2000, 20000)),
                 batch, device)


def bench_pallas_journal(device, quick=False, batch=LANES_ONE_WAVE,
                         lengths=None):
    """``fused_journal_rollout`` (kernel K2): the journal, one int32 a
    lane-step, stays on the device."""
    from ..ops import step_kernel as sk
    return slope(lambda n: sk.fused_journal_rollout(CFG, 1, batch, n, device),
                 lengths or ((512, 2048) if quick else (1024, 8192)),
                 batch, device)


def bench_pallas_alt(device, quick=False, batch=LANES_ONE_WAVE,
                     lengths=None):
    """``alt_rollout`` (kernel K4), single-mover ticks."""
    from ..ops import step_kernel as sk
    return slope(lambda n: sk.alt_rollout(CFG, 1, batch, n, device),
                 lengths or ((1000, 5000) if quick else (2000, 60000)),
                 batch, device)


def bench_table_build(device, quick=False, board=None):
    """``build_tables(backend="native")`` (the g++ library) on 11x7, 5x4
    with ``quick``: dense transition entries (nS x 25 x 36) a second, on
    the host clock.  Raises where the library cannot be built."""
    from ..core import tables
    w, h = board or ((5, 4) if quick else (11, 7))
    cfg = EnvConfig(w, h, 0.2)
    nS = tables.build_statespace(cfg).nS
    t = timed(lambda: tables.build_tables(cfg, backend="native"), device,
              host=True)
    return rate(nS * 25 * 36, t, board=[w, h])


ROWS = [
    ("facade_single_env", bench_facade),
    ("xla_batch_engine_traj", bench_xla),
    ("xla_stats_threefry", bench_xla_stats_threefry),
    ("xla_stats_counter", bench_xla_stats_counter),
    ("xla_multigrid_mixed", bench_multigrid),
    ("xla_alternating_engine", bench_alternating),
    ("xla_altq_learner", bench_altq_learner),
    ("pallas_minimax_learner", bench_pallas_minimax_learner),
    ("pallas_minimax_learner_packed", bench_pallas_minimax_learner_packed),
    ("pallas_learner_11x7_packed", bench_pallas_learner_11x7),
    ("pallas_br_learner", bench_pallas_br_learner),
    ("pallas_iql_learner", bench_pallas_iql_learner),
    ("pallas_iql_learner_packed", bench_pallas_iql_learner_packed),
    ("pallas_multigrid_learner", bench_pallas_multigrid_learner),
    ("pallas_multigrid_learner_packed", bench_pallas_multigrid_packed),
    ("pallas_altq_learner", bench_pallas_altq_learner),
    ("pallas_altq_learner_packed", bench_pallas_altq_learner_packed),
    ("parity_bit_exact", bench_parity),
    ("parity_kernel_fused", bench_parity_kernel),
    ("pallas_fused", bench_pallas),
    ("pallas_fused_journal", bench_pallas_journal),
    ("pallas_multigrid_fused", bench_pallas_multigrid),
    ("pallas_alt_fused", bench_pallas_alt),
    ("table_build_native", bench_table_build),
]


def run_row(name: str, fn, device, quick: bool, where) -> dict:
    """One row's line: its result with the JAX keys, the device and
    ``where`` (the card), or ``{"path": name, "error": ...}`` where it
    raised."""
    try:
        row = fn(device, quick)
    except Exception as e:  # noqa: BLE001 -- the sweep goes on
        traceback.print_exc()
        return {"path": name, "error": f"{type(e).__name__}: {e}"[:300]}
    v = row.pop("env_steps_per_s")
    return {"path": name, "env_steps_per_s": v,
            "vs_reference": v / REFERENCE_RATE, **row,
            "device": torch.device(device).type, "card": where}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the JAX tool's reduced sizes")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    where = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("bench_all: --device cuda needs a CUDA device and none is "
                  "present; pass --device cpu for the plain versions",
                  file=sys.stderr)
            return 2
        where = card()
    failed = 0
    for name, fn in ROWS:
        line = run_row(name, fn, args.device, args.quick, where)
        stats = line.pop("episode_stats", None)
        if stats is not None:
            print(json.dumps({"path": f"{name}/episode_stats", **stats}))
        print(json.dumps(line), flush=True)
        failed += "error" in line
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
