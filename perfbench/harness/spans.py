"""Readings of the harness's host spans and of the trainer's ``timing``
dict, shared by per-layer metrics."""


def mean_span(ctx, name: str):
    """Mean seconds of span ``name`` over the window's untraced units."""
    vals = [u.spans[name] for u in ctx.measured_units() if name in u.spans]
    return sum(vals) / len(vals) if vals else None


def replay_ms(ctx):
    """Mean ms of one replay: ``segments_ms / replays`` pooled over the
    window's untraced trainings."""
    seg = rep = 0
    for u in ctx.measured_units():
        t = u.data.get("timing")
        if t and t.get("replays"):
            seg, rep = seg + t["segments_ms"], rep + t["replays"]
    return seg / rep if rep else None
