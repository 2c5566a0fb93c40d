"""Sum of phase_ms['launch'] over the sum of padded rows, unprofiled rounds:
upload, admission, K1 and the prefill, stream clock."""

from tofec_bench.harness.readers import launch_ms_per_row as read  # noqa: F401
