"""Mean RequestResult.service_s of the window's reads, in ms: from a read's
first task to its decoded bytes."""

from tofec_bench.harness.readers import proxy_service_ms as read  # noqa: F401
