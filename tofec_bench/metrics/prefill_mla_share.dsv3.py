"""Latent attention's share of the prefill's device time by layer kind, over
the unprofiled rounds, in %."""

from tofec_bench.harness.deepseek_readers import prefill_mla_share as read  # noqa: F401
