"""Per-request flight recorder over the exact task-level engine.

A copy of the reference package's ``repro/obs/flight.py`` (numpy only);
:class:`FlightLog` takes the port's tensors and converts them to numpy once,
at construction.

Everything else in :mod:`repro_torch.obs` is an aggregate; this plane keeps the
*individual* request anatomies the paper's §II-A dynamics are made of.  The
device side is :func:`repro_torch.taskq.engine.taskq_scan_core`'s static
``flight=True`` flag (riding jit cache keys like ``collect``), which emits
per-lane start / tentative-completion times, the pass-2 assigned-thread id
and the departure instant for every request.  This module is the host side:

* :class:`FlightLog` — reconstructs the raw arrays into per-task records
  (cancel kind won / cancelled-in-queue / cancelled-in-service derived from
  the same ``C ≤ D`` / ``S < D`` classification the engine's counters use),
  exports them as an NDJSON stream (:data:`FLIGHT_SCHEMA`) and as Chrome
  ``trace_event`` JSON on a **simulated** clock — one Perfetto track per
  pool thread, cancellations as slices truncated at the departure hairline,
  flow arrows tying each request's first task to its winning k-th one.
* :meth:`FlightLog.task_rows` / :func:`oracle_task_rows` — the two sides of
  the event-level parity pin: device flight rows vs the
  :func:`repro_torch.core.simulator.simulate` ``event_log`` hook, row for row.
* :meth:`FlightLog.exemplars` + :func:`exemplar_panel` — the top-K slowest
  valid requests and their task-race anatomy as an ASCII breakdown (the
  HTML twin renders in :func:`repro_torch.obs.dashboard.html_report`).
* :class:`FlightRing` — the serving loop's per-round flight recorder:
  admit → decode → generate phase durations on a compacted simulated round
  clock (rounds butt against each other, no inter-round idle), so serve
  dashboards show where breached rounds spent their budget.

Clock convention: :class:`repro_torch.obs.trace.Tracer` spans are **wallclock**
(monotonic µs since tracer epoch); flight traces are **simulated seconds**
scaled to µs (``ts = sim_s * 1e6``).  Both serialize through the shared
:func:`repro_torch.obs.trace.write_trace_doc` writer, so either file loads in
Perfetto — they are different timelines, not different formats.

NDJSON record schema (one JSON object per line)::

    {"schema": "repro.obs/flight/v1", "label": <run label>,
     "req": <arrival index>, "lane": <task lane>, "thread": <pool thread
     id, -1 if never started>, "kind": "won" | "cancel_queue" |
     "cancel_service", "arrival": <s>, "start": <s | null>, "end": <s |
     null>, "depart": <s>, "n": ..., "k": ..., "queue_s": ...,
     "total_s": ...}

The rule of thumb the sweep engines follow: **aggregate engines stream,
flight replays one case** — a grid run keeps its streamed reductions, and
an anomalous cell is zoomed into via
:meth:`repro_torch.taskq.sweep.TaskqSweep.replay_flight`, which re-runs that one
point with ``flight=True`` and returns a :class:`FlightLog`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import deque

import numpy as np

from repro_torch.obs.trace import write_trace_doc

FLIGHT_SCHEMA = "repro.obs/flight/v1"

#: kind ids shared with the oracle's event_log rows: index = device/oracle
#: integer kind, value = the NDJSON kind string.
KINDS = ("won", "cancel_queue", "cancel_service")

#: Synthetic Perfetto track (tid) for the per-request arrival instants.
ARRIVAL_TID = 999


def _host(v, dtype) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array of ``dtype``."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


def _f(v) -> float | None:
    """float for JSON: NaN/inf → null."""
    v = float(v)
    return v if np.isfinite(v) else None


class FlightLog:
    """Host-side reconstruction of one ``flight=True`` scan output.

    ``out`` is the :func:`repro_torch.taskq.engine.taskq_scan` result dict (must
    carry the ``"flight"`` block); ``valid`` optionally masks padded
    arrivals (bucket-padded launches replay real + pad lanes — padding must
    never mine as an exemplar or export as a record)."""

    def __init__(self, out: dict, *, valid=None, label: str = "taskq"):
        fl = out["flight"]
        self.label = label
        self.arrival = _host(fl["arrival"], np.float64)
        self.depart = _host(fl["depart"], np.float64)
        self.start = _host(fl["start"], np.float64)
        self.tent = _host(fl["tent"], np.float64)
        self.thread = _host(fl["thread"], np.int64)
        self.n = _host(out["n"], np.int64)
        self.k = _host(out["k"], np.int64)
        self.total = _host(out["total"], np.float64)
        self.queueing = _host(out["queueing"], np.float64)
        T = self.arrival.shape[0]
        self.valid = (
            np.ones(T, bool) if valid is None else np.asarray(valid, bool)
        )
        if self.valid.shape != (T,):
            raise ValueError(
                f"valid mask shape {self.valid.shape} != ({T},)")

    def __len__(self) -> int:
        return int(self.valid.sum())

    # ---- per-task rows ----------------------------------------------------
    def _task(self, i: int, m: int) -> tuple[int, float, float]:
        """(kind_id, start, end) for request i's lane m (NaN = no event)."""
        started = self.thread[i, m] >= 0
        if not started:
            return 1, np.nan, np.nan
        if self.tent[i, m] <= self.depart[i]:  # winner: completed at C
            return 0, float(self.start[i, m]), float(self.tent[i, m])
        return 2, float(self.start[i, m]), float(self.depart[i])

    def task_rows(self) -> list[tuple]:
        """Valid per-task rows ``(req, lane, kind, start, end, depart)``
        sorted by (req, lane) — the exact layout of the oracle's
        ``event_log`` hook after :func:`oracle_task_rows`, the two sides of
        the event-level parity pin."""
        rows = []
        for i in np.nonzero(self.valid)[0]:
            for m in range(int(self.n[i])):
                kind, s, e = self._task(i, m)
                rows.append((int(i), m, kind, s, e, float(self.depart[i])))
        return rows

    def records(self) -> list[dict]:
        """One :data:`FLIGHT_SCHEMA` dict per valid (request, lane)."""
        recs = []
        for i in np.nonzero(self.valid)[0]:
            i = int(i)
            for m in range(int(self.n[i])):
                kind, s, e = self._task(i, m)
                recs.append({
                    "schema": FLIGHT_SCHEMA,
                    "label": self.label,
                    "req": i,
                    "lane": m,
                    "thread": int(self.thread[i, m]),
                    "kind": KINDS[kind],
                    "arrival": float(self.arrival[i]),
                    "start": _f(s),
                    "end": _f(e),
                    "depart": float(self.depart[i]),
                    "n": int(self.n[i]),
                    "k": int(self.k[i]),
                    "queue_s": float(self.queueing[i]),
                    "total_s": float(self.total[i]),
                })
        return recs

    def write_ndjson(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            for rec in self.records():
                fh.write(json.dumps(rec) + "\n")
        return path

    # ---- simulated-clock Chrome trace ------------------------------------
    def to_trace_events(self) -> list:
        """Chrome ``trace_event`` list on the simulated clock (sim seconds
        × 1e6 as µs): one track per pool thread carrying task-occupancy
        slices (cancelled-in-service slices truncate at the departure
        instant), an ``arrivals`` instant track, and one flow arrow per
        request from its first started task to the winning k-th one."""
        pid = 0
        events: list = [{
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": f"flight:{self.label} (simulated time)"},
        }, {
            "ph": "M", "name": "thread_name", "pid": pid,
            "tid": ARRIVAL_TID, "args": {"name": "arrivals"},
        }]
        threads = sorted(int(t) for t in np.unique(self.thread) if t >= 0)
        for j in threads:
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": j,
                "args": {"name": f"pool-thread-{j:02d}"},
            })
        for i in np.nonzero(self.valid)[0]:
            i = int(i)
            events.append({
                "name": f"req{i} arrive", "ph": "i", "cat": "flight",
                "s": "t", "ts": self.arrival[i] * 1e6,
                "pid": pid, "tid": ARRIVAL_TID,
                "args": {"req": i, "n": int(self.n[i]), "k": int(self.k[i])},
            })
            first = None  # (start, thread) of the earliest started task
            winner = None  # (start, thread) of the task completing at D
            for m in range(int(self.n[i])):
                kind, s, e = self._task(i, m)
                if kind == 1:
                    continue  # cancelled in queue: never held a thread
                tid = int(self.thread[i, m])
                events.append({
                    "name": f"req{i}/t{m}", "ph": "X", "cat": "flight",
                    "ts": s * 1e6, "dur": max(e - s, 0.0) * 1e6,
                    "pid": pid, "tid": tid,
                    "args": {"req": i, "lane": m, "kind": KINDS[kind],
                             "n": int(self.n[i]), "k": int(self.k[i])},
                })
                if first is None or s < first[0]:
                    first = (s, tid)
                if kind == 0 and e == float(self.depart[i]):
                    winner = (e, tid)
            if first is not None and winner is not None:
                # Flow binding: s/f events must sit inside slices on their
                # thread; nudge the finish arrow just before the slice end.
                events.append({
                    "name": f"req{i}", "ph": "s", "cat": "req", "id": i,
                    "ts": first[0] * 1e6, "pid": pid, "tid": first[1],
                })
                events.append({
                    "name": f"req{i}", "ph": "f", "bp": "e", "cat": "req",
                    "id": i, "ts": winner[0] * 1e6, "pid": pid,
                    "tid": winner[1],
                })
        return events

    def write_trace(self, path: str) -> str:
        """Write the simulated-clock Perfetto trace; returns the path."""
        return write_trace_doc(path, self.to_trace_events())

    # ---- exemplar mining --------------------------------------------------
    def anatomy(self, i: int) -> dict:
        """One request's task-race anatomy as a plain dict."""
        i = int(i)
        tasks = []
        for m in range(int(self.n[i])):
            kind, s, e = self._task(i, m)
            tasks.append({"lane": m, "thread": int(self.thread[i, m]),
                          "kind": KINDS[kind], "start": _f(s), "end": _f(e)})
        return {
            "req": i,
            "arrival": float(self.arrival[i]),
            "depart": float(self.depart[i]),
            "total_s": float(self.total[i]),
            "queue_s": float(self.queueing[i]),
            "n": int(self.n[i]),
            "k": int(self.k[i]),
            "tasks": tasks,
        }

    def exemplars(self, top_k: int = 3) -> list[dict]:
        """The ``top_k`` slowest VALID requests' anatomies, slowest first.

        Deterministic under padding and reordering: candidates are the
        valid arrivals only, ranked by (total delay desc, arrival index
        asc) — so bucket-padded replays of the same case mine identical
        exemplars."""
        idx = np.nonzero(self.valid)[0]
        order = sorted(idx, key=lambda i: (-self.total[i], int(i)))
        return [self.anatomy(i) for i in order[: int(top_k)]]


def oracle_task_rows(event_log: list) -> list[tuple]:
    """Normalize a :func:`repro_torch.core.simulator.simulate` ``event_log`` into
    the :meth:`FlightLog.task_rows` layout: tuples ``(req, lane, kind,
    start, end, depart)`` sorted by (req, lane).  The oracle appends rows
    in departure order (which under load differs from arrival order); the
    device log is arrival-ordered — sorting makes them row-for-row
    comparable."""
    rows = [(int(r), int(m), int(kd), float(s), float(e), float(d))
            for r, m, kd, s, e, d in event_log]
    rows.sort(key=lambda row: (row[0], row[1]))
    return rows


def exemplar_panel(exemplars: list[dict], width: int = 44) -> str:
    """ASCII task-race anatomy for mined exemplars (dashboard section).

    One block per request: a header line with the delay split and code,
    then one bar per task lane spanning [arrival, depart] — ``#`` while the
    task holds a thread, ``x`` marking a cancellation-in-service's
    truncation, ``.`` for queue wait before its start, blank for lanes
    cancelled in queue."""
    if not exemplars:
        return "(no exemplars)"
    lines = []
    for ex in exemplars:
        lines.append(
            f"req {ex['req']}  total={ex['total_s']:.4g}s "
            f"(queue {ex['queue_s']:.4g}s)  code=({ex['n']},{ex['k']})")
        t0, t1 = ex["arrival"], ex["depart"]
        span = max(t1 - t0, 1e-12)

        def col(t):
            return int(round((t - t0) / span * (width - 1)))

        for task in ex["tasks"]:
            row = [" "] * width
            if task["start"] is not None:
                lo, hi = col(task["start"]), col(task["end"])
                for c in range(0, lo):
                    row[c] = "."
                for c in range(lo, max(hi, lo) + 1):
                    row[c] = "#"
                if task["kind"] == "cancel_service":
                    row[min(hi, width - 1)] = "x"
            thr = (f"thr{task['thread']:02d}" if task["thread"] >= 0
                   else "  -  ")
            lines.append(
                f"  t{task['lane']:02d} {thr} |{''.join(row)}| "
                f"{task['kind']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Serving-loop flight ring
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundFlight:
    """One serving round's phase breakdown on the compacted round clock.

    ``t0`` is the round's start in simulated seconds (the cumulative sum of
    all prior rounds' phase durations — rounds butt against each other, so
    the trace shows budget *composition*, not host idle time).  ``phases``
    is the ordered (name, seconds) list: admit (proxy fetch), decode (the
    fused admission+decode+prefill launch) and generate (the token loop)."""

    round: int
    t0: float
    phases: tuple
    requested: int
    served: int
    code: tuple

    @property
    def total_s(self) -> float:
        return float(sum(d for _, d in self.phases))


class FlightRing:
    """Fixed-capacity host-side ring of :class:`RoundFlight` records.

    The serving twin of the taskq flight plane: the closed-loop server
    appends one record per collected round (obs-gated, like its timeline
    ring) and the last ``capacity`` rounds stay resident; older rounds fall
    off the front."""

    def __init__(self, capacity: int = 256, label: str = "serve"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.label = label
        self._rounds: deque[RoundFlight] = deque(maxlen=self.capacity)
        self._clock = 0.0
        self._count = 0

    def __len__(self) -> int:
        return len(self._rounds)

    def record(self, phases, *, requested: int, served: int,
               code: tuple) -> RoundFlight:
        """Append one round; ``phases`` is an ordered (name, seconds) list."""
        rf = RoundFlight(
            round=self._count, t0=self._clock,
            phases=tuple((str(n), float(d)) for n, d in phases),
            requested=int(requested), served=int(served), code=tuple(code),
        )
        self._rounds.append(rf)
        self._clock += rf.total_s
        self._count += 1
        return rf

    def rounds(self) -> list[RoundFlight]:
        return list(self._rounds)

    def records(self) -> list[dict]:
        """NDJSON-ready dicts, one per retained round (oldest first)."""
        return [{
            "schema": FLIGHT_SCHEMA,
            "label": self.label,
            "round": rf.round,
            "t0": rf.t0,
            "total_s": rf.total_s,
            "phases": {n: d for n, d in rf.phases},
            "requested": rf.requested,
            "served": rf.served,
            "code": list(rf.code),
        } for rf in self._rounds]

    def to_trace_events(self) -> list:
        """Round slices with nested phase slices on one simulated track."""
        pid = 0
        events: list = [{
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": f"flight:{self.label} (simulated round time)"},
        }, {
            "ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "serve rounds"},
        }]
        for rf in self._rounds:
            events.append({
                "name": f"round{rf.round}", "ph": "X", "cat": "flight",
                "ts": rf.t0 * 1e6, "dur": rf.total_s * 1e6,
                "pid": pid, "tid": 0,
                "args": {"requested": rf.requested, "served": rf.served,
                         "code": list(rf.code)},
            })
            t = rf.t0
            for name, dur in rf.phases:
                events.append({
                    "name": name, "ph": "X", "cat": "flight",
                    "ts": t * 1e6, "dur": dur * 1e6, "pid": pid, "tid": 0,
                    "args": {"round": rf.round},
                })
                t += dur
        return events

    def write_trace(self, path: str) -> str:
        return write_trace_doc(path, self.to_trace_events())
