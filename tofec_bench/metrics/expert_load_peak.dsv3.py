"""The most loaded held expert's (token, choice) pairs over the mean held
expert's, over the traced round's decode steps and expert layers."""

from tofec_bench.harness.nemotron_readers import expert_load_peak as read  # noqa: F401
