"""95th percentile, over every prompt request due in the window, of the time
from its due time to its generated tokens on the host."""

from tofec_bench.harness.readers import latency_p95_ms as read  # noqa: F401
