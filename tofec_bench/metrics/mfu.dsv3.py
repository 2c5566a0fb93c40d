"""Model FLOPs of the rows the unprofiled rounds served, the routed experts'
at the held share, over their wall time at the bfloat16 peak, in %."""

from tofec_bench.harness.deepseek_readers import mfu as read  # noqa: F401
