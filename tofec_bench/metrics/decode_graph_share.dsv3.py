"""The traced rounds' decode steps replayed from a captured CUDA graph over all
their decode steps, in % (the program's serve.generate spans)."""

from tofec_bench.harness.decode_spans import decode_graph_share as read  # noqa: F401
