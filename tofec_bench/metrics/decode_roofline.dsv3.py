"""Σ bound / Σ device time of the profiled round's decode steps, in %: weights,
held experts hit and the latent cache at the HBM rate, FLOPs at the bfloat16
peak."""

from tofec_bench.harness.deepseek_readers import decode_roofline as read  # noqa: F401
