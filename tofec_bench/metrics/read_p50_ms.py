"""Median delay of an object read, from its due time to the proxy's t_done for
its decoded bytes, over every read due in the window."""

from tofec_bench.harness.readers import latency_p50_ms as read  # noqa: F401
