"""Mean backlog the controller was given at the window's read picks, in requests
(the program's proxy.pick events)."""

from tofec_bench.harness.program_spans import pick_backlog as read  # noqa: F401
