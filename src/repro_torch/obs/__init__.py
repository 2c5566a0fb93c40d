"""repro_torch.obs — the host-side telemetry planes the codec, proxy and
sweeps use.

Shared compile accounting (:class:`CompileStats`) and host span tracing
(:func:`span`), copied from the reference package; both are gated on
``REPRO_OBS=1`` (or :func:`set_enabled`) exactly as there. Artifact
metadata (:func:`run_meta`) names the card. The device planes (metrics,
timeline, SLO, flight, dashboards, profiler) are not ported yet.
"""
from repro_torch.obs.state import enabled, set_enabled
from repro_torch.obs.compile import CompileStats, compile_snapshot, register_stats
from repro_torch.obs.meta import SCHEMA_VERSION, git_rev, run_meta
from repro_torch.obs.trace import (
    Tracer,
    aggregate,
    get_tracer,
    instant,
    reset_trace,
    span,
    traced,
    write_trace,
    write_trace_doc,
)

__all__ = [
    "enabled",
    "set_enabled",
    "CompileStats",
    "compile_snapshot",
    "register_stats",
    "SCHEMA_VERSION",
    "git_rev",
    "run_meta",
    "Tracer",
    "span",
    "traced",
    "instant",
    "get_tracer",
    "write_trace",
    "write_trace_doc",
    "aggregate",
    "reset_trace",
]
