"""host_ms.rollout: the host's time to enqueue one ``fused_journal_rollout``
call (the entry and its launch through ctypes), by the host clock around
the call with no synchronise, averaged over the window's first
``host_probe_units`` calls.  Set-up ends in a synchronise, so those calls
find the launch queue empty; later calls wait for room in it and read
the device's pace instead."""


def read(ctx):
    n = int(ctx.params.get("host_probe_units", 0))
    times = [u.spans["rollout_call"] for u in ctx.units[:n]
             if "rollout_call" in u.spans and not u.traced]
    return 1e3 * sum(times) / len(times) if times else None
