"""Median, over the prompt requests of the rounds before the profiler, of the
time from a request's due time to its generated tokens on the host."""

from tofec_bench.harness.readers import prompt_p50_ms as read  # noqa: F401
