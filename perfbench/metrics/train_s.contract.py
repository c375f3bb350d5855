"""train_s.contract: the host clock around each contract's training call,
ending in a synchronise, averaged over the window's untraced contracts."""
from perfbench.harness import spans


def read(ctx):
    return spans.mean_span(ctx, "train_call")
