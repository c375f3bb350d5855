from . import rules, tables  # noqa: F401
