"""Σ bound / Σ device time of the grouped expert product's kernels in the
profiled round, in %."""

from tofec_bench.harness.nemotron_readers import moe_gemm_roofline as read  # noqa: F401
