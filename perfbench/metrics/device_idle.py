"""device_idle.<cells>: the share of the traced window, in %, in which no
operation ran on the device, from the traced run's one profiler session
(the window's ``trace_units`` units from unit ``trace_from`` on).  One
reader for every split of the quantity (``.rollout``, ``.train``,
``.contract``), each moving its cells' own end-to-end metric."""


def read(ctx):
    s = ctx.trace
    return None if s is None else 100.0 * s.idle_share
