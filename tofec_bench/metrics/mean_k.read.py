"""Mean k of the codes the controller gave the window's reads."""

from tofec_bench.harness.readers import mean_k as read  # noqa: F401
