"""Share of the profiled round's window in which no operation ran on the
device, in %."""

from tofec_bench.harness.readers import device_idle as read  # noqa: F401
