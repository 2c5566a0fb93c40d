"""Share of the traced window in which no operation ran on the device, in %."""

from tofec_bench.harness.readers import device_idle as read  # noqa: F401
