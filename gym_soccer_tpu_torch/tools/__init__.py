"""Host tools of the port: ``check_parity`` (the facade and the planners
against the reference's golden fixtures), ``run_reference_tests`` (the
reference's own test suite against the port), and the shims they put on
the path (``refcompat``: the port under the reference's module names;
``refstub``: the few ``gym`` names the reference imports)."""
