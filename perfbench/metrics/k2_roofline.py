"""k2_roofline: K2's share of its roofline, in %.

K2 (``rollout_kernel<true, kTable>``) does no floating-point work, so its
roofline is its bytes over the card's HBM bandwidth: the journal's 4 B a
lane-step written once, the six int32 state fields read and written once
a lane, and the three int64 totals written once.  Its time is the median
of its launches' device durations in the traced window."""
from perfbench.harness.peaks import peak


def k2_bytes(lanes: int, steps: int) -> int:
    return 4 * lanes * steps + 2 * 6 * 4 * lanes + 3 * 8


def read(ctx):
    bw = peak(ctx, "hbm_bytes_per_s")
    s = ctx.trace
    if bw is None or s is None:
        return None
    times = sorted(s.kernel_times("rollout_kernel"))
    if not times:
        return None
    t = times[len(times) // 2]
    nbytes = k2_bytes(ctx.state["lanes"], ctx.state["steps"])
    return 100.0 * nbytes / bw / t
