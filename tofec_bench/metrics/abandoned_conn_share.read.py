"""The seconds of the window's reads' chunk tasks that ended after their read
had k chunks, over all their tasks' seconds, in % (the program's proxy.task events)."""

from tofec_bench.harness.program_spans import abandoned_conn_share as read  # noqa: F401
