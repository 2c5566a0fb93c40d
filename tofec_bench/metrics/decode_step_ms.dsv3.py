"""Sum of phase_ms['generate'] over the decode steps run, unprofiled rounds,
stream clock."""

from tofec_bench.harness.readers import decode_step_ms as read  # noqa: F401
