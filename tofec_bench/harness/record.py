"""What a run hands its metric readers, and the statistics they share."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Check:
    """One number the run compares with its limit: ``value <= limit`` or,
    with ``at_least``, ``value >= limit``."""

    name: str
    value: float
    limit: float
    at_least: bool = False

    @property
    def holds(self) -> bool:
        return self.value >= self.limit if self.at_least else self.value <= self.limit

    def line(self) -> str:
        op = ">=" if self.at_least else "<="
        return f"check {self.name} {self.value!r} {op} {self.limit!r} {'ok' if self.holds else 'FAILED'}"


@dataclasses.dataclass
class Record:
    """A run: its requests and rounds on the host's monotonic clock, and what
    the traced run read from the profiler."""

    setup_s: float = 0.0
    #: the window's start and end (the end of the last round a backlog cell
    #: started inside it)
    t0: float = 0.0
    t1: float = 0.0
    #: one dict per request due in the window: ``due``, ``done`` (None when
    #: it never came), ``ok``, and what the driver knows of it (``n``,
    #: ``k``, ``queue_s``, ``service_s``, ``round``)
    requests: list[dict] = dataclasses.field(default_factory=list)
    #: closed-loop cells: one dict per round started in the window:
    #: ``start``, ``end``, ``rows``, ``padded``, ``steps``, ``phase_ms``
    rounds: list[dict] = dataclasses.field(default_factory=list)
    checks: list[Check] = dataclasses.field(default_factory=list)
    #: the traced run's readings (``harness.trace.summarize``), else None
    trace: dict | None = None
    #: the cell's configuration and traffic, for readers that need a size
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    #: what a driver adds for its own readers (model FLOPs, K1 calls, ...)
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return len(self.requests)

    @property
    def failed(self) -> int:
        return sum(1 for r in self.requests if not r["ok"])

    def latencies_ms(self) -> list[float]:
        """Every request's delay from its due time to its answer, in ms; a
        failed request counts with the time its failure was known."""
        return [(r["done"] - r["due"]) * 1e3 for r in self.requests if r["done"] is not None]


def percentile(values, p: float) -> float | None:
    """The ``p``-th percentile (0-100) over all values, linear between
    order statistics (numpy's default), or None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
