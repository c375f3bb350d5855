"""decode_ms.rollout: the host clock around each call's ``unpack_journal``
(the decode of its journal into the per-step stream, with whatever waits
for the device it makes), averaged over the window's untraced calls."""
from perfbench.harness import spans


def read(ctx):
    s = spans.mean_span(ctx, "decode_call")
    return None if s is None else 1e3 * s
