"""Mean RequestResult.queueing_s of the window's reads, in ms: the wait in the
proxy's admission before a read's first task starts."""

from tofec_bench.harness.readers import proxy_queue_ms as read  # noqa: F401
