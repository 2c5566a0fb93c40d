"""Model FLOPs of the rows the unprofiled rounds served over their wall time
at the bfloat16 peak, in %."""

from tofec_bench.harness.readers import mfu as read  # noqa: F401
