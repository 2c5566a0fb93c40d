"""Mean store stage of the window's reads, in ms: from a read's first chunk task's
start to its k-th chunk (the program's proxy.read events)."""

from tofec_bench.harness.program_spans import store_wait_ms as read  # noqa: F401
