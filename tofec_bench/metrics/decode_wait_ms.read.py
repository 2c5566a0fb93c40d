"""Mean decode_wait stage of the window's reads, in ms: from a read's k-th chunk to
the start of the batched decode that serves it (the program's proxy.read events)."""

from tofec_bench.harness.program_spans import decode_wait_ms as read  # noqa: F401
