"""outside_replay_ms.train: each training call's host wall (ending in a
synchronise) less its replays' device time: the trainer's own work
outside the graph (tables, packing, the capture, the remainder and the
final solve), averaged over the window's untraced trainings."""


def read(ctx):
    vals = [1e3 * u.spans["train_call"] - u.data["timing"]["segments_ms"]
            for u in ctx.measured_units()
            if u.data.get("timing") and "train_call" in u.spans]
    return sum(vals) / len(vals) if vals else None
