"""The expert layers' share of the prefill's device time by layer kind, over
the unprofiled rounds, in %."""

from tofec_bench.harness.nemotron_readers import prefill_moe_share as read  # noqa: F401
