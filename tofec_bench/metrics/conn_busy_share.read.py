"""The window's reads' chunk-task seconds over L connections times the window,
in % (the program's proxy.task events)."""

from tofec_bench.harness.program_spans import conn_busy_share as read  # noqa: F401
