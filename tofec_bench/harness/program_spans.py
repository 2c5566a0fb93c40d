"""The arithmetic of the metrics read from the program's own trace.

While tracing (``repro_torch.obs.tracing()``, true while ``torch.profiler``
runs) the port's proxy records, per request it submits: a ``proxy.pick``
instant (the backlog its controller was given), a ``proxy.task`` complete
event per chunk task (connection time and outcome), a ``proxy.read`` complete
event (arrival to answer, with its stages in ms) and, per batched decode, a
``proxy.decode`` complete event. The readers here keep the reads submitted
in the window ``[rec.t0, rec.t1)`` and their tasks, and return None where the
program recorded none: a run not traced, or a program without these events.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics

from tofec_bench.harness.record import Record


@dataclasses.dataclass
class Window:
    #: the window's ``proxy.read`` events, their ``proxy.task`` events and
    #: the window's ``proxy.pick`` events of reads
    reads: list[dict]
    tasks: list[dict]
    picks: list[dict]


def _tracer():
    from repro_torch import obs

    return obs.get_tracer()


def window(rec: Record) -> Window | None:
    """The reads the program traced that arrived in the window, their tasks
    (wherever they ended) and the window's read picks; None for none."""
    tracer = _tracer()
    between = getattr(tracer, "events_between", None)
    if between is None or rec.t1 <= rec.t0:
        return None
    evs = between(rec.t0, rec.t1)
    reads = [e for e in evs if e["name"] == "proxy.read"]
    if not reads:
        return None
    rids = {e["args"]["rid"] for e in reads}
    tasks = [e for e in tracer.events()
             if e["name"] == "proxy.task" and e["args"]["rid"] in rids]
    picks = [e for e in evs if e["name"] == "proxy.pick" and e["args"]["op"] == "read"]
    return Window(reads, tasks, picks)


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def _stage(rec: Record, stage: str):
    w = window(rec)
    return None if w is None else _mean(e["args"][stage] for e in w.reads if stage in e["args"])


def store_wait_ms(rec: Record):
    """Mean time from a read's first chunk task's start to its k-th chunk."""
    return _stage(rec, "store_ms")


def decode_wait_ms(rec: Record):
    """Mean time from a read's k-th chunk to the start of the batched decode
    that serves it: the admission thread's lateness."""
    return _stage(rec, "decode_wait_ms")


def decode_ms(rec: Record):
    """Mean time from the start of a read's batched decode to its answer."""
    return _stage(rec, "decode_ms")


def conn_busy_share(rec: Record):
    """The window's reads' task seconds over the connections' seconds in the
    window (L × its length), in %."""
    w = window(rec)
    if w is None:
        return None
    busy = sum(e["dur"] for e in w.tasks) / 1e6
    return 100.0 * busy / (int(rec.config["deployment"]["L"]) * (rec.t1 - rec.t0))


def abandoned_conn_share(rec: Record):
    """The seconds of the window's reads' tasks that ended after their read
    had k chunks (or had failed) over all their tasks' seconds, in %."""
    w = window(rec)
    total = sum(e["dur"] for e in w.tasks) if w else 0.0
    if total <= 0:
        return None
    return 100.0 * sum(e["dur"] for e in w.tasks if e["args"]["outcome"] == "abandoned") / total


def pick_backlog(rec: Record):
    """Mean backlog the controller was given at the window's read picks."""
    w = window(rec)
    return None if w is None else _mean(e["args"]["q"] for e in w.picks)


def decode_spans_ns(rec: Record) -> list[tuple[int, int]] | None:
    """Every ``proxy.decode`` span as (start, end) on the profiler's clock
    (ns): the tracer's anchor puts it on the wall clock, and the traced
    range's ``clock_offset_ns`` on the profiler's; in order of start."""
    tracer = _tracer()
    anchor = getattr(tracer, "anchor", None)
    if anchor is None or not rec.trace:
        return None
    base = anchor[1] + rec.trace["clock_offset_ns"]
    return sorted((base + round(e["ts"] * 1e3), base + round((e["ts"] + e["dur"]) * 1e3))
                  for e in tracer.events() if e["name"] == "proxy.decode")


def k1_start_lag_ms(rec: Record):
    """Median, over the traced K1 kernels, of a kernel's start minus the
    start of the latest ``proxy.decode`` span begun before it, in ms: the
    host and copy work before K1 runs, seen on the device's clock."""
    spans = decode_spans_ns(rec)
    if not spans or not rec.trace["k1_kernels"]:
        return None
    starts = [s for s, _ in spans]
    lags = []
    for s, _ in rec.trace["k1_kernels"]:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0:
            lags.append((s - starts[i]) / 1e6)
    return statistics.median(lags) if lags else None
