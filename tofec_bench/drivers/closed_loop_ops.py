"""The closed-loop driver (``closed_loop.py``) with a traced run's summary
that also holds the grouped expert product's device seconds by phase:
``grouped_gemm_s``, ``{"launch": the prefill's, "generate": the decode
steps'}``.

A configuration names it as its ``driver`` where a per-layer metric reads
the grouped product's time by phase (``moe_gemm_roofline.dsv3``): the
closed-loop driver's summary keeps only the ten device operations with
most time, by name, which need not hold every variant of the grouped
kernels, and a name does not say its phase. A kernel is the decode's where
a replayed CUDA graph launched it (the profiler's correlation id ties a
kernel to the host call that launched it), the prefill's otherwise.
Everything else is the closed-loop driver's.
"""

from __future__ import annotations

from tofec_bench.drivers import closed_loop
from tofec_bench.harness import trace
from tofec_bench.harness.nemotron_readers import GROUPED_GEMM_KERNELS


def grouped_gemm_by_phase(events) -> dict:
    """Device seconds of the grouped expert product's kernels inside the
    ``bench.traced`` range, by the phase that launched them (see the
    module's docstring)."""
    from torch.autograd import DeviceType

    window, graph_launch, kernels = None, {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if any(k in name for k in GROUPED_GEMM_KERNELS):
                kernels.append((ev.correlation_id(), ev.start_ns(), ev.end_ns()))
        elif name == "bench.traced":
            window = (ev.start_ns(), ev.end_ns())
        elif "Launch" in name:
            graph_launch[ev.correlation_id()] = "GraphLaunch" in name
    out = {"launch": 0.0, "generate": 0.0}
    if window is None:
        return out
    w0, w1 = window
    for corr, s, e in kernels:
        if e > w0 and s < w1:
            phase = "generate" if graph_launch.get(corr, False) else "launch"
            out[phase] += (min(e, w1) - max(s, w0)) / 1e9
    return out


def run(cell, **kw):
    """:func:`closed_loop.run` (the same arguments), the traced summary
    holding ``grouped_gemm_s``."""
    summarize = trace.summarize

    def with_phases(events, enter_ns=None):
        out = summarize(events, enter_ns)
        out["grouped_gemm_s"] = grouped_gemm_by_phase(events)
        return out

    trace.summarize = with_phases
    try:
        return closed_loop.run(cell, **kw)
    finally:
        trace.summarize = summarize
