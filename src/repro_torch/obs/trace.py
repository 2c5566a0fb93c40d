"""Host span tracing.

Monotonic-clock spans with nested parents (thread-local stack), tagged with
compile-cache bucket keys and mesh shape by the call sites.  Spans are
recorded as Chrome ``trace_event`` complete events ("X", ts/dur in
microseconds) so :func:`write_trace` output loads directly in
``chrome://tracing`` / Perfetto; :func:`aggregate` gives per-span-name
count/total/mean/max tables for quick terminal triage.

Spans, instant marks and complete events record while
:func:`repro_torch.obs.state.tracing` is true: under ``REPRO_OBS=1`` or while
a ``torch.profiler`` session runs.  Otherwise entering a span is an
environment read, an attribute read and a truth test — safe to leave on hot
paths.  The tracer's clock anchor (:attr:`Tracer.anchor`) maps its monotonic
times onto the wall clock, and from there onto the profiler's clock.
:func:`device_mark` and :func:`mark_ms` time work on the device's own clock.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
import warnings

import torch

from repro_torch.obs.state import tracing


def write_trace_doc(path: str, events: list) -> str:
    """Serialize a Chrome ``trace_event`` list as a loadable trace document.

    The writer behind :meth:`Tracer.write_trace` (wallclock spans), kept
    separate so the simulated-clock flight recorder
    (:mod:`repro_torch.obs.flight`) can share it: a
    ``{"traceEvents": [...]}`` JSON envelope that Perfetto /
    ``chrome://tracing`` load directly. Returns the path."""
    doc = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


class Tracer:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list = []
        self._tls = threading.local()
        w0 = time.time_ns()
        self._epoch = time.monotonic()
        self._epoch_wall_ns = (w0 + time.time_ns()) // 2
        #: Spans entered but not yet exited; write_trace() auto-closes them.
        self._open: dict = {}
        self._warned_incomplete = False

    @property
    def anchor(self) -> tuple[float, int]:
        """The tracer's epoch on ``time.monotonic()`` (seconds) and on
        ``time.time_ns()``, taken together: an event at ``ts`` µs lies at
        ``anchor[1] + ts * 1000`` ns of the wall clock."""
        return self._epoch, self._epoch_wall_ns

    # ---- recording --------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **tags) -> "_Span":
        """Context manager for one span; tags must be JSON-serializable."""
        return _Span(self, name, tags)

    def traced(self, name: str | None = None, **tags):
        """Decorator form of :meth:`span`."""

        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(label, **tags):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    def instant(self, name: str, **tags) -> None:
        """Record a zero-duration instant mark (Chrome "i" phase event) —
        used for SLO breach / convergence events so they line up with the
        compile/launch spans on the same timeline.  No-op unless tracing."""
        if not tracing():
            return
        ev = {
            "name": name,
            "ph": "i",
            "cat": "repro",
            "s": "t",
            "ts": round((time.monotonic() - self._epoch) * 1e6, 3),
            "pid": os.getpid(),
            "tid": threading.get_ident() % 2**31,
            "args": tags,
        }
        with self._lock:
            self._events.append(ev)

    def complete(self, name: str, t0: float, t1: float, **tags) -> None:
        """Record an interval measured elsewhere, ``time.monotonic()``
        seconds at both ends, as a complete event on the calling thread.

        Meant for a life no ``with`` block can hold (a proxy read crosses the
        submitting thread, a connection and the admission thread). It records
        unconditionally: the caller decides from :func:`tracing` when the
        interval began, so an interval begun while tracing is recorded whole
        even if it ends after tracing stopped."""
        self._record(name, t0, t1, tags)

    def _record(self, name, t0, t1, args) -> dict:
        ev = {
            "name": name,
            "ph": "X",
            "cat": "repro",
            "ts": round((t0 - self._epoch) * 1e6, 3),
            "dur": round((t1 - t0) * 1e6, 3),
            "pid": os.getpid(),
            "tid": threading.get_ident() % 2**31,
            "args": args,
        }
        with self._lock:
            self._events.append(ev)
        return ev

    # ---- export -----------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def events_between(self, t0: float, t1: float) -> list:
        """The events that began in ``[t0, t1)``, ``time.monotonic()``
        seconds, in the order recorded."""
        lo, hi = (t0 - self._epoch) * 1e6, (t1 - self._epoch) * 1e6
        return [ev for ev in self.events() if lo <= ev["ts"] < hi]

    def aggregate(self) -> dict:
        """Per-span-name {count, total_us, mean_us, max_us}, by total desc.

        Instant marks (:meth:`instant`) carry no duration and are skipped."""
        agg: dict = {}
        for ev in self.events():
            if "dur" not in ev:
                continue
            a = agg.setdefault(ev["name"], {"count": 0, "total_us": 0.0, "max_us": 0.0})
            a["count"] += 1
            a["total_us"] += ev["dur"]
            a["max_us"] = max(a["max_us"], ev["dur"])
        for a in agg.values():
            a["mean_us"] = a["total_us"] / a["count"]
        return dict(sorted(agg.items(), key=lambda kv: -kv[1]["total_us"]))

    def format_table(self) -> str:
        rows = [("span", "count", "total_ms", "mean_us", "max_us")]
        for name, a in self.aggregate().items():
            rows.append(
                (
                    name,
                    str(a["count"]),
                    f"{a['total_us'] / 1e3:.2f}",
                    f"{a['mean_us']:.1f}",
                    f"{a['max_us']:.1f}",
                )
            )
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        return "\n".join(
            "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows
        )

    def _close_incomplete(self) -> None:
        """Auto-close spans still open (entered, never exited) as complete
        events tagged ``incomplete: true``, warning once.  The span's later
        real ``__exit__`` (if any) still pops the thread stack but won't
        record a second event."""
        with self._lock:
            stuck = list(self._open.values())
            self._open.clear()
        if not stuck:
            return
        if not self._warned_incomplete:
            self._warned_incomplete = True
            warnings.warn(
                f"{len(stuck)} span(s) left unclosed at write_trace(); "
                "auto-closing with incomplete=true "
                f"({', '.join(sorted({s.name for s in stuck}))})",
                RuntimeWarning,
                stacklevel=3,
            )
        t1 = time.monotonic()
        for sp in stuck:
            self._record(sp.name, sp._t0, t1, {"depth": sp._depth, "parent": sp._parent,
                                                **sp.tags, "incomplete": True})

    def write_trace(self, path: str, *, wall_clock: bool = False) -> str:
        """Write Chrome trace_event JSON; returns the path.

        With ``wall_clock`` the timestamps are µs of the wall clock
        (``time.time_ns`` / 1000), to lay beside a ``torch.profiler`` trace
        put on the same clock by its offset to it; otherwise µs since the
        tracer's epoch."""
        self._close_incomplete()
        events = self.events()
        if wall_clock:
            shift = self._epoch_wall_ns / 1e3
            events = [{**ev, "ts": ev["ts"] + shift} for ev in events]
        return write_trace_doc(path, events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._warned_incomplete = False


class _Span:
    __slots__ = ("_tracer", "name", "tags", "_t0", "_depth", "_parent", "_on", "_event")

    def __init__(self, tracer: Tracer, name: str, tags: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.tags = tags

    def __enter__(self) -> "_Span":
        self._on = tracing()
        self._event = None
        if not self._on:
            return self
        st = self._tracer._stack()
        self._parent = st[-1] if st else None
        self._depth = len(st)
        st.append(self.name)
        self._t0 = time.monotonic()
        with self._tracer._lock:
            self._tracer._open[id(self)] = self
        return self

    def __exit__(self, *exc) -> bool:
        if self._on:
            t1 = time.monotonic()
            self._tracer._stack().pop()
            with self._tracer._lock:
                live = self._tracer._open.pop(id(self), None) is not None
            if live:  # not already auto-closed by write_trace()
                self._event = self._tracer._record(
                    self.name, self._t0, t1,
                    {"depth": self._depth, "parent": self._parent, **self.tags})
        return False

    def tag(self, **tags) -> None:
        """Add tags known only after the span closed (a device time read
        once the stream has synced) to its recorded event."""
        if self._on:
            self.tags.update(tags)
            if self._event is not None:
                with self._tracer._lock:
                    self._event["args"].update(tags)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, **tags) -> _Span:
    return _TRACER.span(name, **tags)


def instant(name: str, **tags) -> None:
    return _TRACER.instant(name, **tags)


def complete(name: str, t0: float, t1: float, **tags) -> None:
    return _TRACER.complete(name, t0, t1, **tags)


def traced(name: str | None = None, **tags):
    return _TRACER.traced(name, **tags)


def write_trace(path: str, *, wall_clock: bool = False) -> str:
    return _TRACER.write_trace(path, wall_clock=wall_clock)


def aggregate() -> dict:
    return _TRACER.aggregate()


def reset_trace() -> None:
    return _TRACER.reset()


def device_mark(device: torch.device):
    """A point on the device's stream (a recorded CUDA event), or on the host
    clock for the CPU. Reading a CUDA mark needs the work before it done."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def mark_ms(a, b) -> float:
    """Milliseconds from mark ``a`` to mark ``b`` (:func:`device_mark`)."""
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3
