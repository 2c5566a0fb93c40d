"""Sum of k over sum of n over the window's reads, in %: the share of issued
chunk tasks whose result was needed."""

from tofec_bench.harness.readers import useful_chunk_share as read  # noqa: F401
