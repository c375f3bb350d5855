"""Traffic kind ``rollout_journal``: one long journaled random-vs-random
rollout decoded into the per-step stream, as the port's README runs it
(``fused_journal_rollout(cfg, 0, 8192, 1024)`` then ``unpack_journal``).

Each call steps ``lanes`` x ``steps_per_call`` and continues the last
one's lanes (``init_fields``, ``step_offset``), so the window is one
rollout; its journal is decoded on the device by ``unpack_journal`` into
the reference-shaped stream (observations before and after the reset,
both actions, player A's reward, goal and truncation flags), which is
what a user of the generator keeps.  Calls follow one another with no
synchronise of the harness's own; the window ends with a synchronise
after the last call that started inside ``--seconds``.  A consumer of the
stream is not modelled: each stream is dropped when the next call is
made, except those the check keeps.

Checked after the window: the first call (from the initial-state spread)
and ``sampled_calls`` more drawn from the seed as the window runs
(reservoir sampling), each re-run by the plain reference from the call's
own starting fields: every journal word, every final field, the three
totals and every entry of the decoded stream must be equal.
"""
from __future__ import annotations

import torch

from perfbench.harness import program as prog
from perfbench.harness.context import Check
from perfbench.reference import game, markov

NAMES = ("journal_words_wrong", "fields_wrong", "totals_wrong",
         "stream_wrong")


def _seed32(ctx) -> int:
    return ctx.seed & 0xFFFFFFFF


def setup(ctx) -> None:
    P, c = ctx.program, ctx.cell.config
    ctx.state.update(cfg=prog.env_config(P, c["board"]),
                     board=game.Board.from_config(c["board"]),
                     lanes=int(ctx.params["lanes"]),
                     steps=int(ctx.params["steps_per_call"]))
    # warm-up: the kernel library, its tables, a call from the spread and
    # a resumed one, each decoded, at the window's shapes
    cfg, B, T = ctx.state["cfg"], ctx.state["lanes"], ctx.state["steps"]
    out, _, journal = P.fused_journal_rollout(cfg, _seed32(ctx) ^ 0x5A5A, B,
                                              T, device=ctx.device)
    P.unpack_journal(cfg, journal)
    _, _, journal = P.fused_journal_rollout(cfg, _seed32(ctx) ^ 0x5A5A, B, T,
                                            device=ctx.device,
                                            init_fields=out, step_offset=T)
    P.unpack_journal(cfg, journal)


def window(ctx, seconds: float) -> None:
    P, st = ctx.program, ctx.state
    cfg, B, T = st["cfg"], st["lanes"], st["steps"]
    seed = _seed32(ctx)
    k = int(ctx.params.get("sampled_calls", 2))
    pick = ctx.rng(1)
    kept, fields, offset = {}, None, 0
    t0 = ctx.begin_window()
    while True:
        u = ctx.new_unit()
        with ctx.span(u, "rollout_call"):
            out, stats, journal = P.fused_journal_rollout(
                cfg, seed, B, T, device=ctx.device, init_fields=fields,
                step_offset=offset)
        with ctx.span(u, "decode_call"):
            stream = P.unpack_journal(cfg, journal)
        rec = (fields, offset, out, stats, journal, stream)
        i = u.index
        if i <= k:
            kept[i] = rec
        else:
            j = int(pick.integers(0, i))
            if j < k:
                del kept[sorted(kept)[1 + j]]
                kept[i] = rec
        fields, offset = out, offset + T
        ctx.end_unit()
        if ctx.stop(t0, seconds):
            break
    dt = ctx.end_window(t0)
    st["kept"] = kept
    ctx.end_to_end["env_steps_per_s"] = len(ctx.units) * B * T / dt


def reference_stream(r2d, rec: dict) -> dict:
    """The decoded stream of the reference's own record."""
    return {"obs": r2d[rec["raw_next"]], "final_obs": r2d[rec["raw"]],
            "actions_a": rec["aa"], "actions_b": rec["ab"],
            "reward_a": rec["r"], "done": rec["goal"],
            "truncated": rec["trunc"]}


def check(ctx):
    st = ctx.state
    b, B, T = st["board"], st["lanes"], st["steps"]
    r2d = torch.as_tensor(markov.StateSpace(b).raw_to_dense,
                          device=ctx.device)
    wrong = dict.fromkeys(NAMES, 0)
    failed = 0
    for i in sorted(st["kept"]):
        start, offset, out, stats, journal, stream = st["kept"][i]
        start = (game.start_fields(b, B, ctx.device) if start is None
                 else tuple(f.long() for f in start))
        rf, rs, rj, rec = game.journal_rollout(b, _seed32(ctx), start, T,
                                               offset, record=True)
        ref = reference_stream(r2d, rec)
        got = {"journal_words_wrong": int((journal != rj).sum()),
               "fields_wrong": sum(int((x.long() != y).sum())
                                   for x, y in zip(out, rf)),
               "totals_wrong": sum(int(int(x) != y)
                                   for x, y in zip(stats, rs)),
               "stream_wrong": sum(
                   int((stream[key].reshape(T, B).double()
                        != ref[key].double()).sum()) if key in stream
                   else T * B for key in ref)}
        for key in NAMES:
            wrong[key] += got[key]
        failed += any(got.values())
    lim = ctx.cell.limits
    return [Check(key, wrong[key], lim.get(key, 0)) for key in NAMES], failed


def control_program(program, cell, overrides=None, slip_bits: int = 8):
    """The reference in the program's place, its slip drawn from the top
    ``slip_bits`` bits of the 16-bit uniform: the lower-precision draw
    that would tempt a later change.  The program decodes its journal."""
    from types import SimpleNamespace
    b = game.Board.from_config(cell.config["board"])

    def rollout(cfg, seed, batch, n_steps, device="cuda", init_fields=None,
                step_offset=0):
        f = (game.start_fields(b, batch, device) if init_fields is None
             else tuple(x.long() for x in init_fields))
        out, tot, words = game.journal_rollout(b, seed, f, n_steps,
                                               step_offset,
                                               slip_bits=slip_bits)
        dev = torch.device(device)
        return (tuple(x.to(torch.int32) for x in out),
                tuple(torch.tensor(x, device=dev) for x in tot), words)

    return SimpleNamespace(**{**vars(program),
                              "fused_journal_rollout": rollout})
