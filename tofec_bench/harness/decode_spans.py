"""The reading of the closed loop's decode counts from the program's own trace.

While tracing (``repro_torch.obs.tracing()``, true while ``torch.profiler``
runs) the port's ``ClosedLoopServer`` records a ``serve.generate`` span per
round, tagged with the round's decode steps replayed from a captured CUDA
graph (``graph_replays``) and run eagerly (``eager_steps``). The reader keeps
the spans begun in the window ``[rec.t0, rec.t1)`` and returns None where the
program tagged none: a run not traced, or a program without these tags.
"""

from __future__ import annotations

from tofec_bench.harness.record import Record


def _tracer():
    from repro_torch import obs

    return obs.get_tracer()


def decode_graph_share(rec: Record):
    """The window's decode steps replayed from a captured graph over all its
    decode steps, in %."""
    between = getattr(_tracer(), "events_between", None)
    if between is None or rec.t1 <= rec.t0:
        return None
    tags = [e["args"] for e in between(rec.t0, rec.t1)
            if e["name"] == "serve.generate" and "graph_replays" in e["args"]]
    steps = sum(a["graph_replays"] + a["eager_steps"] for a in tags)
    return 100.0 * sum(a["graph_replays"] for a in tags) / steps if steps else None
