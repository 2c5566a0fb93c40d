"""Shared compile/retrace accounting.

Every jitted engine used to carry its own counter dataclass
(``FleetSweep.stats`` / ``SchedSweep`` / ``TaskqSweep``'s ``SweepStats``,
the codec's ``CodecStats``, and the bare ``traces`` ints on
``FusedServingStep`` / ``ClosedLoopServer``).  :class:`CompileStats` is the
one implementation: the old names stay importable as thin aliases and the
attribute APIs (``.traces``, ``.launches``, ``.cases``, ``.by_mesh``,
``.calls``, ``.items``, ``.reset()``) are unchanged, so existing tests and
compile-count pins keep passing.

Instances constructed with a ``label`` self-register in a process-wide weak
registry; :func:`compile_snapshot` aggregates it into one dict so "where
did every retrace go" is a single call across engines.
"""
from __future__ import annotations

import dataclasses
import weakref


@dataclasses.dataclass(eq=False)
class CompileStats:
    """Uniform trace/launch/case accounting (asserted in tests).

    ``by_mesh`` splits the trace count by the mesh shape the compilation
    was built for — ``()`` for the single-device path, ``(D,)`` for a
    D-device grid mesh — so the mesh-keyed bucket rule is pinnable.
    ``calls``/``items`` serve the codec's per-launch batching claim.
    """

    label: str = ""
    traces: int = 0  # distinct compilations (incremented at trace time)
    launches: int = 0
    cases: int = 0
    calls: int = 0
    items: int = 0
    by_mesh: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.label:
            register_stats(self)

    def reset(self) -> None:
        self.traces = self.launches = self.cases = self.calls = self.items = 0
        self.by_mesh.clear()

    def snapshot(self) -> dict:
        return {
            "traces": self.traces,
            "launches": self.launches,
            "cases": self.cases,
            "calls": self.calls,
            "items": self.items,
            "by_mesh": {str(k): v for k, v in self.by_mesh.items()},
        }


_REGISTRY: "weakref.WeakSet[CompileStats]" = weakref.WeakSet()


def register_stats(stats: CompileStats) -> CompileStats:
    _REGISTRY.add(stats)
    return stats


def compile_snapshot() -> dict:
    """Aggregate every labeled live CompileStats, summed per label."""
    out: dict = {}
    for s in sorted(_REGISTRY, key=lambda s: s.label):
        agg = out.setdefault(s.label, {"traces": 0, "launches": 0, "cases": 0, "calls": 0, "items": 0, "by_mesh": {}})
        snap = s.snapshot()
        for k in ("traces", "launches", "cases", "calls", "items"):
            agg[k] += snap[k]
        for mk, mv in snap["by_mesh"].items():
            agg["by_mesh"][mk] = agg["by_mesh"].get(mk, 0) + mv
    return out
