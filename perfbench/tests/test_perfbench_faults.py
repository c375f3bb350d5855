"""The checks that decide ``correct``: a whole run on the CPU (the
harness's look for a chip skipped) with the timed path broken underneath
comes out not correct, once for each fault a cell can have; the control,
the reference in the program's place at a lower precision, fails too.
The sizes are cut to what a test run holds; on the card the same test
runs each cell's control at the cell's own size."""
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import control, run  # noqa: E402
from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness import program as prog  # noqa: E402
from perfbench.traffic import minimax  # noqa: E402

ROLLOUT = dict(lanes=1024, steps_per_call=16, max_units=3,
               host_probe_units=1, trace_from=1, trace_units=1)
TRAIN = dict(batch=1024, n_chunks=2, chunk_len=8, max_units=1,
             warmup_chunks=1, sampled_units=1, solver_iters=100,
             final_solver_iters=200)


def _cell(name):
    """The cell; the contract's on the 5x4 board, which a test's
    evaluation on the CPU can afford."""
    c = cells.load_cell(name)
    if c.params.get("evaluate"):
        small = cells.load_cell("minimax5x4.train").config
        c = dataclasses.replace(c, config=dict(
            c.config, board=small["board"], contract=dict(
                c.config["contract"], segment_iters=0)))
    return c


def _run(cell, program, overrides, trace=False):
    out, checks, _ = run.run_cell(_cell(cell), 2 ** 31 + 5, 0.0,
                               trace, device="cpu", program=program,
                               overrides=overrides)
    return out, {c.name: c for c in checks}


def _with(**entries):
    return SimpleNamespace(**{**vars(prog.load()), **entries})


# -- the rollout ------------------------------------------------------

def _rollout_fault(kind):
    real = prog.load().fused_journal_rollout
    decode = prog.load().unpack_journal

    def bad_decode(cfg, journal):
        stream = decode(cfg, journal)
        stream["obs"][journal.shape[0] // 2, 7] += 1
        return stream

    if kind == "decoded":             # one decoded entry altered
        return _with(unpack_journal=bad_decode)

    def broken(cfg, seed, batch, n_steps, device="cuda", init_fields=None,
               step_offset=0):
        out, stats, journal = real(cfg, seed, batch, n_steps, device,
                                   init_fields, step_offset)
        if kind == "unchanged":       # the state comes back as it went in
            start = init_fields or real(cfg, seed, batch, 0, device)[0]
            out = tuple(f.clone() for f in start)
        elif kind == "half":          # the second half of the lanes left out
            journal = journal.clone()
            journal[:, batch // 2:] = 0
            out = tuple(torch.cat([f[:batch // 2], torch.zeros_like(
                f[batch // 2:])]) for f in out)
        elif kind == "altered":       # one word altered where produced
            journal = journal.clone()
            journal[n_steps // 2, batch // 3] ^= 1 << 16
        return out, stats, journal

    return _with(fused_journal_rollout=broken)


@pytest.mark.parametrize("cell", ["rollout5x4.journal",
                                  "rollout11x7.journal"])
def test_rollout_sound(cell):
    out, checks = _run(cell, None, ROLLOUT, trace=True)
    assert out["correct"] and all(c.ok for c in checks.values())
    assert out["attempted"] == 3 and out["failed"] == 0


@pytest.mark.parametrize("kind,fails", [
    ("unchanged", "fields_wrong"), ("half", "journal_words_wrong"),
    ("altered", "journal_words_wrong"), ("decoded", "stream_wrong")])
def test_rollout_faults(kind, fails):
    out, checks = _run("rollout5x4.journal", _rollout_fault(kind), ROLLOUT)
    assert not out["correct"] and out["failed"] > 0
    assert not checks[fails].ok


def test_rollout_control():
    cell = cells.load_cell("rollout11x7.journal")
    r = control.readings(cell, 7, True, 2, device="cpu",
                         overrides=dict(ROLLOUT, max_units=None))
    assert not r["correct"]
    assert r["checks"]["journal_words_wrong"]["value"] > 0


# -- the trainer and the contract ------------------------------------

def _train_fault(kind):
    real = prog.load().fused_minimax_train

    def broken(cfg, **kw):
        if kind == "half":            # half of the lanes left out
            kw = dict(kw, batch=kw["batch"] // 2)
        if kind == "stale" and kw["n_chunks"] == TRAIN["n_chunks"]:
            # the last chunk returns the state it was given
            out = real(cfg, **dict(kw, n_chunks=kw["n_chunks"] - 1))
            return (*out[:5], dict(out[5], next_chunk=kw["n_chunks"]))
        q, v, pa, pb, hist, res = real(cfg, **kw)
        if kind == "unchanged":       # every table as it was given
            res = dict(res, q=torch.zeros_like(res["q"]),
                       v=torch.zeros_like(res["v"]),
                       n=torch.zeros_like(res["n"]))
        elif kind == "altered":       # an answer altered where produced
            res = dict(res, v=res["v"] + 0.01)
        return q, v, pa, pb, hist, res

    return _with(fused_minimax_train=broken)


def test_train_sound_numbers():
    """At a test's size the trained policies are far from the contract,
    so the exploitability fails; the other numbers hold."""
    out, checks = _run("minimax5x4.train", None, TRAIN)
    assert checks["visits_rel_off"].ok and checks["r1_gap"].ok
    assert checks["visits_rel_off"].value == 0.0
    assert checks["q_step_gap"].ok and checks["q_step_gap"].value < 1e-6
    assert checks["step_fields_wrong"].value == 0
    assert checks["step_counts_wrong"].value == 0


@pytest.mark.parametrize("kind,fails", [
    ("unchanged", "visits_rel_off"), ("unchanged", "q_step_gap"),
    ("half", "visits_rel_off"), ("half", "step_fields_wrong"),
    ("stale", "q_step_gap"), ("stale", "step_counts_wrong"),
    ("altered", "r1_gap")])
def test_train_faults(kind, fails):
    out, checks = _run("minimax5x4.train", _train_fault(kind), TRAIN)
    assert not out["correct"] and out["failed"] > 0
    assert not checks[fails].ok


@pytest.mark.parametrize("n,count,ks", [
    (1000, 2, [0, 999]), (6000, 2, [0, 5999]), (10, 4, [0, 3, 6, 9]),
    (1, 2, [0]), (5, 1, [0]), (3, 16, [0, 1, 2])])
def test_followed_chunks(n, count, ks):
    assert minimax.followed(n, count) == ks


def test_published_contract_reads_the_window_training():
    """Where the window trained the published seed, the published reading
    is that training's and no training of its own is made; elsewhere one
    more training of that seed is read."""
    real = prog.load().fused_minimax_train
    full = []

    def counted(cfg, **kw):
        if kw["n_chunks"] == TRAIN["n_chunks"]:
            full.append(kw["seed"])
        return real(cfg, **kw)

    pub = cells.load_cell("minimax5x4.train").config["contract"]["seed"]
    for first, extra in ((pub, 0), (pub + 1, 1)):
        full.clear()
        _, checks = _run("minimax5x4.train",
                         _with(fused_minimax_train=counted),
                         dict(TRAIN, seed_pool=[first, 1]))
        assert full == [first] + [pub] * extra
        if not extra:
            assert checks["published_exploitability"].value == \
                checks["exploitability"].value


def test_contract_altered_reading():
    real = prog.load().exploitability
    bad = _with(exploitability=lambda *a, **k: real(*a, **k) + 0.01)
    out, checks = _run("minimax11x7.contract", bad, TRAIN)
    assert not checks["exp_gap"].ok and checks["visits_rel_off"].ok


def test_train_control():
    cell = cells.load_cell("minimax5x4.train")
    r = control.readings(cell, 7, True, 1, device="cpu", overrides=TRAIN)
    assert not r["correct"]
    for key in ("r1_gap", "q_step_gap"):
        assert r["checks"][key]["value"] > r["checks"][key]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rollout5x4.journal", "rollout11x7.journal",
                                  "minimax5x4.train",
                                  "minimax11x7.contract"])
def test_control_at_cell_size(cell):
    """On the card: the control at the cell's own size fails its checks
    on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs the control at the cell's "
                    "size")
    c = cells.load_cell(cell)
    for seed in (4000000007, 4000000009, 4000000011):
        r = control.readings(c, seed, True, 3 if "rollout" in cell else 1)
        assert not r["correct"], r
