"""replay_ms.<cells>: the device time of one CUDA-graph replay of the
grouped dispatch (8 chunk bodies: K5, R1 and the ops between chunks), from
``ops/dispatch.run``'s ``timing`` (CUDA events around the replays), over
the window's untraced trainings; one reader for ``.train`` and
``.contract``."""
from perfbench.harness import spans


def read(ctx):
    return spans.replay_ms(ctx)
