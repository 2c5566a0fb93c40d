"""Median, over the traced K1 kernels, of a kernel's start minus the start of the
latest proxy.decode span begun before it, on the profiler's clock, in ms."""

from tofec_bench.harness.program_spans import k1_start_lag_ms as read  # noqa: F401
