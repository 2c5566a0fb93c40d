"""repro_torch.obs — unified telemetry across the serving tower and the
sweep engines; the port of the reference package's ``repro.obs``.

Layers:

* device-resident metrics — :class:`MetricsBuf` of counters, fixed-bucket
  histograms and high-water marks as tensors, threaded through the sweeps
  and the closed loop and folded per chunk (no host syncs);
* time-resolved timelines — :class:`TimelineBuf` ring/windowed buffers of
  per-round / per-window series (arrival rate, backlog, pick, served) and
  delay-histogram deltas; windowed percentiles are recoverable host-side;
* SLO / convergence monitoring — :class:`SLOSpec` burn rates and
  pick-settling over timeline snapshots, with structured NDJSON events
  (:class:`EventLog`) mirrored into the span trace as instant marks;
* host span tracing — :func:`span` / :func:`traced` around bucket first
  uses, launches, uploads and folds, exported as Chrome trace JSON via
  :func:`write_trace` and aggregate tables via :func:`aggregate`; device
  marks (:func:`device_mark`, :func:`mark_ms`) time work on the device's
  stream;
* shared compile accounting — :class:`CompileStats` behind every engine's
  ``stats`` object, queryable in one shot via :func:`compile_snapshot`;
* launch profiling — :func:`profile_launch` counted work + wall-time
  records on H100 peaks, registered into the same registry;
* dashboards — :func:`ascii_dashboard` / :func:`html_report` over the
  timeline snapshots, SLO reports and profiler tables;
* per-request flight recorder — :class:`FlightLog` over the exact engine's
  ``flight=True`` records and :class:`FlightRing` for the serving loop's
  per-round phase breakdown.

Everything is gated on ``REPRO_OBS=1`` (or :func:`set_enabled`); disabled,
the layer costs one branch per site and changes no primary output. The
host span tracer alone also records while a ``torch.profiler`` session runs
(:func:`tracing`), which flips no engine's collection.
Artifact metadata (:func:`run_meta`) names the card.
"""
from repro_torch.obs.state import enabled, set_enabled, tracing
from repro_torch.obs.compile import CompileStats, compile_snapshot, register_stats
from repro_torch.obs.metrics import (
    PICK_BINS,
    MetricsBuf,
    sweep_point_metrics,
    to_prometheus,
    valid_mask,
)
from repro_torch.obs.timeline import (
    DELAY_BINS,
    TIMELINE_SLOTS,
    TimelineBuf,
    delay_bucket,
    hist_percentile,
    rolling_percentile,
    sweep_timeline,
    timeline_window,
)
from repro_torch.obs.slo import (
    EventLog,
    SLOSpec,
    burn_rate,
    convergence,
    slo_report,
)
from repro_torch.obs.profile import (
    count_work,
    format_profile,
    profile_launch,
    profile_snapshot,
    reset_profiles,
)
from repro_torch.obs.dashboard import ascii_dashboard, html_report, sparkline
from repro_torch.obs.flight import (
    FLIGHT_SCHEMA,
    FlightLog,
    FlightRing,
    exemplar_panel,
    oracle_task_rows,
)
from repro_torch.obs.trace import (
    Tracer,
    aggregate,
    complete,
    device_mark,
    get_tracer,
    instant,
    mark_ms,
    reset_trace,
    span,
    traced,
    write_trace,
    write_trace_doc,
)
from repro_torch.obs.meta import SCHEMA_VERSION, git_rev, run_meta

__all__ = [
    "enabled",
    "set_enabled",
    "tracing",
    "CompileStats",
    "compile_snapshot",
    "register_stats",
    "MetricsBuf",
    "PICK_BINS",
    "sweep_point_metrics",
    "valid_mask",
    "to_prometheus",
    "TimelineBuf",
    "TIMELINE_SLOTS",
    "DELAY_BINS",
    "delay_bucket",
    "hist_percentile",
    "rolling_percentile",
    "sweep_timeline",
    "timeline_window",
    "SLOSpec",
    "EventLog",
    "burn_rate",
    "convergence",
    "slo_report",
    "count_work",
    "profile_launch",
    "profile_snapshot",
    "format_profile",
    "reset_profiles",
    "ascii_dashboard",
    "html_report",
    "sparkline",
    "FLIGHT_SCHEMA",
    "FlightLog",
    "FlightRing",
    "exemplar_panel",
    "oracle_task_rows",
    "Tracer",
    "span",
    "traced",
    "instant",
    "complete",
    "device_mark",
    "mark_ms",
    "get_tracer",
    "write_trace",
    "write_trace_doc",
    "aggregate",
    "reset_trace",
    "SCHEMA_VERSION",
    "git_rev",
    "run_meta",
]
