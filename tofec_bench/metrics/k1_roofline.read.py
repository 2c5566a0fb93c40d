"""K1's share of its roofline in the traced window, in %: the sum of each
call's least time on the card over K1's device time in the profiler."""

from tofec_bench.harness.readers import k1_roofline as read  # noqa: F401
