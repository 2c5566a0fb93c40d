"""Mean decode stage of the window's reads, in ms: from the start of a read's
batched decode to its decoded bytes (the program's proxy.read events)."""

from tofec_bench.harness.program_spans import decode_ms as read  # noqa: F401
