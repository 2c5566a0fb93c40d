"""SLO and controller-convergence monitoring over timeline snapshots.

A copy of the reference package's ``repro/obs/slo.py`` (numpy only, over
snapshots), its imports pointed at :mod:`repro_torch.obs`.

The paper's headline claim is temporal — "the adaptation mechanism
converges to an appropriate code" — so this module turns the time-resolved
plane (:mod:`repro_torch.obs.timeline`) into first-class measurements:

* :class:`SLOSpec` — a declarative delay objective: percentile target plus
  an error budget (the fraction of requests allowed past the target).
* :func:`burn_rate` — the windowed violation fraction over the timeline's
  delay-histogram deltas, divided by the budget: burn >= 1 means the
  window is eating budget faster than allowed (the breach condition).
* :func:`convergence` — pick-settling slot (first slot after which the
  rounded (n, k) pick never changes again) and per-code dwell fractions —
  the paper's Fig.-style convergence story as numbers.
* :func:`slo_report` — one dict tying it together, emitting breach /
  converge events both as instant marks into the span trace
  (:meth:`repro_torch.obs.trace.Tracer.instant`) and as structured NDJSON lines
  through :class:`EventLog`.

Everything here is host-side numpy over :meth:`TimelineBuf.snapshot`
output — the device work already happened in the timeline fold.

Event-log schema (one JSON object per line)::

    {"schema": "repro.obs/event/v1", "ts": <unix seconds>,
     "kind": "slo_breach" | "slo_recovered" | "controller_converged",
     "label": <run label>, ...kind-specific fields}
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from repro_torch.obs import trace as _trace
from repro_torch.obs.timeline import bucket_edges, rolling_percentile

EVENT_SCHEMA = "repro.obs/event/v1"
REPORT_SCHEMA = "repro.obs/slo_report/v1"


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declarative delay objective for one timeline.

    ``percentile`` of delays must stay under ``target_s``; equivalently at
    most ``error_budget`` = 1 - percentile of requests may exceed it.  An
    explicit ``error_budget`` decouples the budget from the reported
    percentile (e.g. watch p99 against a 5% budget).  ``window`` is the
    trailing slot count burn rate / percentiles are judged over."""

    target_s: float
    percentile: float = 0.99
    error_budget: float | None = None
    window: int = 8

    @property
    def budget(self) -> float:
        if self.error_budget is not None:
            return float(self.error_budget)
        return max(1.0 - float(self.percentile), 1e-9)

    def to_dict(self) -> dict:
        return {
            "target_s": self.target_s,
            "percentile": self.percentile,
            "error_budget": self.budget,
            "window": self.window,
        }


class EventLog:
    """Structured NDJSON event sink (breach / converge / custom marks)."""

    def __init__(self, label: str = "run"):
        self.label = label
        self.events: list[dict] = []

    def emit(self, kind: str, **fields) -> dict:
        ev = {"schema": EVENT_SCHEMA, "ts": time.time(), "kind": kind,
              "label": self.label, **fields}
        self.events.append(ev)
        # Mirror into the span trace as an instant mark so breaches line up
        # with the compile/launch spans on the Perfetto timeline.
        _trace.get_tracer().instant(f"obs.{kind}", label=self.label, **fields)
        return ev

    def write(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            for ev in self.events:
                fh.write(json.dumps(ev) + "\n")
        return path


def violation_fraction(hist_rows, target_s: float) -> np.ndarray:
    """Per-row fraction of observations strictly past ``target_s``.

    Only buckets whose LOWER edge clears the target count, so the estimate
    is conservative by at most one bucket (~9%); rows with no observations
    report 0 (no traffic burns no budget)."""
    h = np.asarray(hist_rows, np.float64)
    edges = bucket_edges()
    cut = int(np.searchsorted(edges, target_s, side="left")) + 1
    tot = h.sum(axis=-1)
    bad = h[..., cut:].sum(axis=-1)
    return np.where(tot > 0, bad / np.maximum(tot, 1.0), 0.0)


def burn_rate(hist_rows, spec: SLOSpec) -> np.ndarray:
    """Windowed budget burn: violation fraction over the trailing
    ``spec.window`` slots divided by the error budget (>= 1 = breach).

    Windows with zero observations are NaN — "no data", never a breach or
    a recovery: an idle stretch must not trip the monitor either way, and
    NaN propagates as a gap through the dashboards' NaN-aware renderers
    (same convention as :func:`repro_torch.obs.timeline.hist_percentile`)."""
    h = np.asarray(hist_rows, np.float64)
    c = h.cumsum(axis=0)
    if spec.window < len(c):
        lo = np.concatenate([np.zeros_like(c[: spec.window]),
                             c[: -spec.window]], axis=0)
    else:
        lo = np.zeros_like(c)
    win = c - lo
    rate = violation_fraction(win, spec.target_s) / spec.budget
    return np.where(win.sum(axis=-1) > 0, rate, np.nan)


def convergence(pick_n, pick_k) -> dict:
    """Pick-settling slot + per-code dwell fractions from pick series.

    Picks are rounded to integer codes (sweep timelines carry per-window
    means).  ``settle_slot`` is the first slot from which the code never
    changes again (0 = settled immediately); ``dwell`` maps ``"n/k"`` to
    the fraction of slots spent at that code."""
    n = np.rint(np.asarray(pick_n, np.float64)).astype(int)
    k = np.rint(np.asarray(pick_k, np.float64)).astype(int)
    S = len(n)
    if S == 0:
        return {"settle_slot": 0, "settled": False, "final_code": None,
                "dwell": {}, "dwell_final": 0.0}
    same = (n == n[-1]) & (k == k[-1])
    # First index of the trailing all-final run.
    settle = S - 1
    while settle > 0 and same[settle - 1]:
        settle -= 1
    codes, counts = np.unique(
        np.stack([n, k], axis=1), axis=0, return_counts=True)
    dwell = {f"{int(cn)}/{int(ck)}": float(c) / S
             for (cn, ck), c in zip(codes, counts)}
    final = f"{int(n[-1])}/{int(k[-1])}"
    return {
        "settle_slot": int(settle),
        "settled": True,
        "final_code": [int(n[-1]), int(k[-1])],
        "dwell": dwell,
        "dwell_final": dwell[final],
    }


def slo_report(snap: dict, spec: SLOSpec, *, label: str = "serve",
               hist: str = "delay", events: EventLog | None = None,
               exemplars: list | None = None) -> dict:
    """The SLO/convergence report for one timeline snapshot.

    Emits ``slo_breach`` / ``slo_recovered`` edges (burn rate crossing 1)
    and one ``controller_converged`` event into ``events`` (a fresh
    :class:`EventLog` when None — returned under ``"events"`` either way).
    NaN burn slots (no-data windows) are skipped: they neither open nor
    close a breach.

    ``exemplars``: optional anatomies from
    :meth:`repro_torch.obs.flight.FlightLog.exemplars` — breach events then carry
    the offending exemplar request ids (``exemplar_reqs``) so a breach line
    links straight to the per-request flight records, and the report
    summarizes them under ``"exemplars"``."""
    if events is None:
        events = EventLog(label)
    ex_reqs = [int(ex["req"]) for ex in (exemplars or [])]
    rows = np.asarray(snap["hists"][hist])
    burn = burn_rate(rows, spec)
    p_series = rolling_percentile(rows, spec.percentile, spec.window)
    conv = convergence(snap["series"]["pick_n"], snap["series"]["pick_k"])

    breached = False
    for slot, b in enumerate(burn):
        if not np.isfinite(b):
            continue  # no data: hold the current breach state
        if b >= 1.0 and not breached:
            breached = True
            events.emit("slo_breach", slot=slot, burn_rate=float(b),
                        target_s=spec.target_s, percentile=spec.percentile,
                        exemplar_reqs=ex_reqs)
        elif b < 1.0 and breached:
            breached = False
            events.emit("slo_recovered", slot=slot, burn_rate=float(b))
    if conv["settled"] and conv["final_code"] is not None:
        events.emit("controller_converged", slot=conv["settle_slot"],
                    code=conv["final_code"],
                    dwell_final=conv["dwell_final"])

    finite = p_series[np.isfinite(p_series)]
    finite_burn = burn[np.isfinite(burn)]
    report_exemplars = [
        {"req": int(ex["req"]), "total_s": float(ex["total_s"]),
         "queue_s": float(ex["queue_s"]), "n": int(ex["n"]),
         "k": int(ex["k"])}
        for ex in (exemplars or [])
    ]
    return {
        "schema": REPORT_SCHEMA,
        "label": label,
        "spec": spec.to_dict(),
        "slots": int(len(burn)),
        "window_arrivals": int(snap.get("window", 1)),
        "burn_rate": [float(b) for b in burn],
        "max_burn_rate": (
            float(finite_burn.max()) if len(finite_burn) else 0.0),
        "breach_slots": int((finite_burn >= 1.0).sum()),
        "exemplars": report_exemplars,
        "percentile_series_s": [float(p) for p in p_series],
        "percentile_last_s": float(finite[-1]) if len(finite) else None,
        "convergence": conv,
        "events": events,
    }
