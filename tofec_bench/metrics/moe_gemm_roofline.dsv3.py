"""Σ bound / Σ device time of the grouped SwiGLU expert product's kernels in
the profiled round, in %."""

from tofec_bench.harness.deepseek_readers import moe_gemm_roofline as read  # noqa: F401
