"""Generated tokens of the window's rounds over the time from the window's
start to the end of its last round."""

from tofec_bench.harness.readers import gen_tokens_per_s as read  # noqa: F401
