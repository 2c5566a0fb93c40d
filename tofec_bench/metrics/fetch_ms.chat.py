"""Mean phase_ms['fetch'] of the window's unprofiled rounds: the proxy's raw
reads and the row gather, host clock."""

from tofec_bench.harness.readers import fetch_ms as read  # noqa: F401
