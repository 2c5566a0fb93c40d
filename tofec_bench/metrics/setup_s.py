"""Seconds from the process's start to the window's start: loading, the K1
build or load, weights, stored objects and warm-up."""

from tofec_bench.harness.readers import setup_s as read  # noqa: F401
