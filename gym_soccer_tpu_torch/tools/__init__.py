"""Host tools of the port: ``check_parity`` (the facade and the planners
against the reference's golden fixtures), ``run_reference_tests`` (the
reference's own test suite against the port), ``gen_golden`` and
``gen_render_golden`` (the fixtures, made by executing the reference),
``bench_all`` (every path timed, one JSON row each) and
``bench_parity_kernel`` (the parity kernels checked and timed), and the
shims they put on the path (``refcompat``: the port under the reference's
module names; ``refstub``: the few ``gym`` names the reference imports)."""
