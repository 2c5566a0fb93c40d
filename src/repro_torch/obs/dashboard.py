"""Dashboards over the time-resolved telemetry plane.

A copy of the reference package's ``repro/obs/dashboard.py`` (numpy only, over
snapshots), its imports pointed at :mod:`repro_torch.obs`.

Two renderers over :meth:`TimelineBuf.snapshot` dicts + an
:func:`repro_torch.obs.slo.slo_report` + :func:`repro_torch.obs.profile.
profile_snapshot`:

* :func:`ascii_dashboard` — a terminal live view: one unicode sparkline
  per series (λ, backlog, pick, served, windowed p99), the SLO burn line,
  convergence stats and the profiler table.
* :func:`html_report` — a single self-contained HTML file (inline SVG, no
  external assets): small-multiple line charts (one series per chart, so
  identity never leans on color), the windowed percentile chart with the
  SLO target as a labeled reference hairline, breach/convergence stat
  tiles, and the roofline table.  Hover shows a crosshair + tooltip; every
  chart ships a ``<details>`` table view; dark mode is its own selected
  set of steps via CSS custom properties, not an automatic flip.

Colors are the reference data-viz palette (categorical slot 1 blue
``#2a78d6``/``#3987e5``, status colors reserved for the breach badge),
validated for both surfaces as a set; values/labels wear text tokens,
never the series color.
"""
from __future__ import annotations

import html
import json
import os

import numpy as np

from repro_torch.obs.timeline import rolling_percentile

_SPARK = "▁▂▃▄▅▆▇█"


def _series_1d(v) -> np.ndarray:
    """Timeline series to one display row: per-case (G, S) arrays average
    across the case axis for the overview (per-case views stay in the
    snapshot)."""
    a = np.asarray(v, np.float64)
    if a.ndim == 2:
        a = a.mean(axis=0)
    return a


def _hist_rows(v) -> np.ndarray:
    """(S, B) delta rows; per-case (G, S, B) stacks sum across cases (the
    overview tail is the whole population's)."""
    a = np.asarray(v, np.float64)
    if a.ndim == 3:
        a = a.sum(axis=0)
    return a


def sparkline(values, width: int = 48) -> str:
    """Unicode sparkline; NaN renders as a gap."""
    a = _series_1d(values)
    if len(a) > width:  # bucket-mean downsample to the display width
        edge = np.linspace(0, len(a), width + 1).astype(int)

        def bucket_mean(lo, hi):
            sl = a[lo:hi]
            sl = sl[np.isfinite(sl)]
            return sl.mean() if len(sl) else np.nan

        a = np.array([bucket_mean(lo, hi)
                      for lo, hi in zip(edge[:-1], edge[1:])])
    finite = a[np.isfinite(a)]
    if not len(finite):
        return " " * len(a)
    lo, hi = float(finite.min()), float(finite.max())
    span = (hi - lo) or 1.0
    out = []
    for v in a:
        if not np.isfinite(v):
            out.append(" ")
        else:
            out.append(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))])
    return "".join(out)


def _fmt(v) -> str:
    if v is None or not np.isfinite(v):
        return "-"
    return f"{v:.4g}"


def ascii_dashboard(timelines: dict, slo: dict | None = None,
                    profile: dict | None = None,
                    exemplars: list | None = None) -> str:
    """Terminal view: sparkline per series + SLO + profiler sections, plus
    the p99 exemplar task-race anatomy when flight exemplars are passed
    (:meth:`repro_torch.obs.flight.FlightLog.exemplars`)."""
    lines = []
    for name, snap in timelines.items():
        lines.append(f"== timeline: {name} "
                     f"(window={snap.get('window', 1)} arrivals/slot) ==")
        rows = []
        for sname, vals in snap.get("series", {}).items():
            a = _series_1d(vals)
            rows.append((sname, sparkline(a),
                         _fmt(a[-1] if len(a) else np.nan),
                         _fmt(np.nanmax(a) if len(a) else np.nan)))
        for hname, hv in snap.get("hists", {}).items():
            p99 = rolling_percentile(_hist_rows(hv), 0.99, 8)
            rows.append((f"{hname}_p99_s", sparkline(p99),
                         _fmt(p99[-1] if len(p99) else np.nan),
                         _fmt(np.nanmax(p99) if len(p99) else np.nan)))
        w = max((len(r[0]) for r in rows), default=0)
        for sname, spark, last, peak in rows:
            lines.append(f"  {sname.ljust(w)}  {spark}  last={last} max={peak}")
    if slo:
        conv = slo.get("convergence", {})
        lines.append("== slo ==")
        lines.append(
            f"  p{slo['spec']['percentile'] * 100:g} target "
            f"{slo['spec']['target_s']}s  burn "
            f"{sparkline(slo['burn_rate'])}  max={_fmt(slo['max_burn_rate'])} "
            f"breach_slots={slo['breach_slots']}")
        lines.append(
            f"  pick settled at slot {conv.get('settle_slot')} on "
            f"{conv.get('final_code')} "
            f"(dwell {_fmt(conv.get('dwell_final'))})")
    if exemplars:
        from repro_torch.obs.flight import exemplar_panel

        lines.append("== p99 exemplars (task-race anatomy) ==")
        lines.extend("  " + ln for ln in exemplar_panel(exemplars).splitlines())
    if profile:
        from repro_torch.obs.profile import format_profile

        lines.append("== launch profile ==")
        lines.extend("  " + ln for ln in format_profile(profile).splitlines())
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# HTML report
# ---------------------------------------------------------------------------

_CSS = """
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --text-primary: #0b0b0b; --text-secondary: #52514e; --muted: #898781;
  --grid: #e1e0d9; --baseline: #c3c2b7;
  --series-1: #2a78d6; --critical: #d03b3b; --good: #0ca30c;
  --ring: rgba(11,11,11,0.10);
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --page: #0d0d0d;
    --text-primary: #ffffff; --text-secondary: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --baseline: #383835;
    --series-1: #3987e5; --critical: #d03b3b; --good: #0ca30c;
    --ring: rgba(255,255,255,0.10);
  }
}
:root[data-theme="dark"] .viz-root {
  color-scheme: dark;
  --surface-1: #1a1a19; --page: #0d0d0d;
  --text-primary: #ffffff; --text-secondary: #c3c2b7; --muted: #898781;
  --grid: #2c2c2a; --baseline: #383835;
  --series-1: #3987e5; --critical: #d03b3b; --good: #0ca30c;
  --ring: rgba(255,255,255,0.10);
}
.viz-root { background: var(--page); color: var(--text-primary);
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  margin: 0; padding: 24px; }
.viz-root h1 { font-size: 20px; margin: 0 0 4px; }
.viz-root h2 { font-size: 15px; margin: 24px 0 8px; }
.viz-root .meta { color: var(--text-secondary); font-size: 12px; }
.tiles { display: flex; gap: 12px; flex-wrap: wrap; margin: 16px 0; }
.tile { background: var(--surface-1); border: 1px solid var(--ring);
  border-radius: 8px; padding: 10px 14px; min-width: 120px; }
.tile .v { font-size: 22px; }
.tile .l { font-size: 11px; color: var(--text-secondary); }
.tile .badge { font-size: 12px; }
.badge.bad { color: var(--critical); }
.badge.ok { color: var(--good); }
.charts { display: grid; gap: 12px;
  grid-template-columns: repeat(auto-fill, minmax(320px, 1fr)); }
.chart { background: var(--surface-1); border: 1px solid var(--ring);
  border-radius: 8px; padding: 10px 12px; position: relative; }
.chart .t { font-size: 12px; color: var(--text-secondary);
  margin-bottom: 4px; }
.chart svg { display: block; width: 100%; height: auto; }
.chart .tip { position: absolute; display: none; pointer-events: none;
  background: var(--surface-1); border: 1px solid var(--ring);
  border-radius: 4px; padding: 2px 6px; font-size: 11px;
  color: var(--text-primary); white-space: nowrap; z-index: 2; }
.chart details { font-size: 11px; color: var(--text-secondary);
  margin-top: 4px; }
.chart table, .prof table { border-collapse: collapse; font-size: 11px; }
.chart td, .chart th, .prof td, .prof th { padding: 1px 8px 1px 0;
  text-align: right; font-variant-numeric: tabular-nums; }
.prof th { color: var(--text-secondary); font-weight: 600; }
.prof { background: var(--surface-1); border: 1px solid var(--ring);
  border-radius: 8px; padding: 10px 14px; overflow-x: auto; }
.axis { fill: var(--muted); font-size: 9px;
  font-variant-numeric: tabular-nums; }
.refline-label { fill: var(--text-secondary); font-size: 9px; }
"""

_JS = """
document.querySelectorAll('.chart[data-v]').forEach(function (c) {
  var vals = JSON.parse(c.dataset.v), svg = c.querySelector('svg'),
      cross = c.querySelector('.cross'), dot = c.querySelector('.dot'),
      tip = c.querySelector('.tip'),
      x0 = +c.dataset.x0, x1 = +c.dataset.x1,
      y0 = +c.dataset.y0, y1 = +c.dataset.y1,
      lo = +c.dataset.lo, hi = +c.dataset.hi;
  svg.addEventListener('mousemove', function (e) {
    var r = svg.getBoundingClientRect(),
        fx = (e.clientX - r.left) / r.width * 560;
    var i = Math.round((fx - x0) / (x1 - x0) * (vals.length - 1));
    i = Math.max(0, Math.min(vals.length - 1, i));
    var v = vals[i];
    if (v === null) { cross.style.display = dot.style.display =
        tip.style.display = 'none'; return; }
    var px = x0 + (x1 - x0) * (vals.length > 1 ? i / (vals.length - 1) : 0),
        py = y1 - (y1 - y0) * ((v - lo) / ((hi - lo) || 1));
    cross.setAttribute('x1', px); cross.setAttribute('x2', px);
    cross.style.display = 'block';
    dot.setAttribute('cx', px); dot.setAttribute('cy', py);
    dot.style.display = 'block';
    tip.textContent = 'slot ' + i + ' \\u00b7 ' + (+v.toPrecision(4));
    tip.style.display = 'block';
    tip.style.left = (e.clientX - r.left + 12) + 'px';
    tip.style.top = (e.clientY - r.top - 10) + 'px';
  });
  svg.addEventListener('mouseleave', function () {
    cross.style.display = dot.style.display = tip.style.display = 'none';
  });
});
"""

_W, _H = 560, 120
_PAD_L, _PAD_R, _PAD_T, _PAD_B = 44, 8, 8, 16


def _svg_chart(title: str, values, *, target: float | None = None,
               target_label: str = "SLO target") -> str:
    a = _series_1d(values)
    finite = a[np.isfinite(a)]
    lo = float(finite.min()) if len(finite) else 0.0
    hi = float(finite.max()) if len(finite) else 1.0
    if target is not None:
        lo, hi = min(lo, target), max(hi, target)
    if hi == lo:
        hi = lo + 1.0
    x0, x1 = _PAD_L, _W - _PAD_R
    y0, y1 = _PAD_T, _H - _PAD_B

    def px(i):
        return x0 + (x1 - x0) * (i / (len(a) - 1) if len(a) > 1 else 0.0)

    def py(v):
        return y1 - (y1 - y0) * (v - lo) / (hi - lo)

    # NaN-aware polyline segments (gaps where a window had no data).
    segs, cur = [], []
    for i, v in enumerate(a):
        if np.isfinite(v):
            cur.append(f"{px(i):.1f},{py(v):.1f}")
        elif cur:
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    grid = "".join(
        f'<line x1="{x0}" y1="{py(lo + f * (hi - lo)):.1f}" x2="{x1}" '
        f'y2="{py(lo + f * (hi - lo)):.1f}" stroke="var(--grid)" '
        f'stroke-width="1"/>' for f in (0.5,)
    )
    ref = ""
    if target is not None:
        ty = py(target)
        ref = (
            f'<line x1="{x0}" y1="{ty:.1f}" x2="{x1}" y2="{ty:.1f}" '
            f'stroke="var(--baseline)" stroke-width="1" '
            f'stroke-dasharray="4 3"/>'
            f'<text class="refline-label" x="{x1}" y="{ty - 3:.1f}" '
            f'text-anchor="end">{html.escape(target_label)} '
            f'{target:g}s</text>'
        )
    lines = "".join(
        f'<polyline fill="none" stroke="var(--series-1)" stroke-width="2" '
        f'stroke-linejoin="round" stroke-linecap="round" '
        f'points="{" ".join(seg)}"/>' for seg in segs if len(seg) > 1
    )
    dots = "".join(
        f'<circle cx="{seg[0].split(",")[0]}" cy="{seg[0].split(",")[1]}" '
        f'r="2" fill="var(--series-1)"/>'
        for seg in segs if len(seg) == 1
    )
    last = f"{finite[-1]:.4g}" if len(finite) else "-"
    tablerows = "".join(
        f"<tr><td>{i}</td><td>{_fmt(v)}</td></tr>" for i, v in enumerate(a)
    )
    data = json.dumps([None if not np.isfinite(v) else float(v) for v in a])
    return (
        f'<div class="chart" data-v=\'{data}\' data-x0="{x0}" data-x1="{x1}" '
        f'data-y0="{y0}" data-y1="{y1}" data-lo="{lo}" data-hi="{hi}">'
        f'<div class="t">{html.escape(title)} · last {last}</div>'
        f'<svg viewBox="0 0 {_W} {_H}" role="img" '
        f'aria-label="{html.escape(title)}">'
        f'<line x1="{x0}" y1="{y1}" x2="{x1}" y2="{y1}" '
        f'stroke="var(--baseline)" stroke-width="1"/>'
        f"{grid}{ref}{lines}{dots}"
        f'<text class="axis" x="{x0 - 4}" y="{y1}" '
        f'text-anchor="end">{lo:.3g}</text>'
        f'<text class="axis" x="{x0 - 4}" y="{y0 + 8}" '
        f'text-anchor="end">{hi:.3g}</text>'
        f'<line class="cross" x1="0" y1="{y0}" x2="0" y2="{y1}" '
        f'stroke="var(--muted)" stroke-width="1" style="display:none"/>'
        f'<circle class="dot" r="4" fill="var(--series-1)" '
        f'stroke="var(--surface-1)" stroke-width="2" style="display:none"/>'
        f"</svg>"
        f'<div class="tip"></div>'
        f"<details><summary>data</summary><table>"
        f"<tr><th>slot</th><th>value</th></tr>{tablerows}</table></details>"
        f"</div>"
    )


def _tiles(slo: dict) -> str:
    conv = slo.get("convergence", {})
    breach = slo.get("breach_slots", 0)
    badge = (
        '<div class="badge bad">&#9650; breach</div>' if breach
        else '<div class="badge ok">&#10003; within budget</div>'
    )
    code = conv.get("final_code")
    tiles = [
        (f"{_fmt(slo.get('percentile_last_s'))}s",
         f"p{slo['spec']['percentile'] * 100:g} (windowed)", ""),
        (_fmt(slo.get("max_burn_rate")), "max burn rate", badge),
        (str(conv.get("settle_slot", "-")), "pick settle slot", ""),
        (f"({code[0]},{code[1]})" if code else "-",
         f"final code · dwell {_fmt(conv.get('dwell_final'))}", ""),
    ]
    return '<div class="tiles">' + "".join(
        f'<div class="tile"><div class="v">{v}</div>'
        f'<div class="l">{html.escape(l)}</div>{b}</div>'
        for v, l, b in tiles
    ) + "</div>"


_EX_H = 18  # px per task row in the exemplar anatomy SVG


def _exemplar_html(exemplars: list) -> str:
    """Per-request task-race anatomy charts: one horizontal bar per task
    lane on the request's [arrival, depart] axis — winners in the series
    color, cancellations-in-service truncated in the critical color, queue
    wait as a muted leader line, lanes cancelled in queue as hollow
    markers.  Labels wear text tokens, never the series color."""
    blocks = []
    for ex in exemplars:
        t0, t1 = ex["arrival"], ex["depart"]
        span = max(t1 - t0, 1e-12)
        x0, x1 = _PAD_L, _W - _PAD_R

        def px(t):
            return x0 + (x1 - x0) * (t - t0) / span

        h = _PAD_T + _EX_H * len(ex["tasks"]) + _PAD_B
        rows = []
        for r, task in enumerate(ex["tasks"]):
            y = _PAD_T + _EX_H * r + _EX_H / 2
            thr = (f"t{task['lane']:02d}·thr{task['thread']:02d}"
                   if task["thread"] >= 0 else f"t{task['lane']:02d}·queued")
            rows.append(
                f'<text class="axis" x="{x0 - 4}" y="{y + 3:.1f}" '
                f'text-anchor="end">{html.escape(thr)}</text>')
            if task["start"] is None:
                rows.append(
                    f'<circle cx="{x1:.1f}" cy="{y:.1f}" r="3" fill="none" '
                    f'stroke="var(--muted)" stroke-width="1.5"/>')
                continue
            cancelled = task["kind"] == "cancel_service"
            color = "var(--critical)" if cancelled else "var(--series-1)"
            rows.append(
                f'<line x1="{px(t0):.1f}" y1="{y:.1f}" '
                f'x2="{px(task["start"]):.1f}" y2="{y:.1f}" '
                f'stroke="var(--muted)" stroke-width="1" '
                f'stroke-dasharray="2 3"/>')
            rows.append(
                f'<rect x="{px(task["start"]):.1f}" y="{y - 5:.1f}" '
                f'width="{max(px(task["end"]) - px(task["start"]), 1):.1f}" '
                f'height="10" rx="2" fill="{color}"/>')
        # Departure hairline: where the k-th completion cut the race.
        rows.append(
            f'<line x1="{x1:.1f}" y1="{_PAD_T}" x2="{x1:.1f}" '
            f'y2="{h - _PAD_B}" stroke="var(--baseline)" stroke-width="1" '
            f'stroke-dasharray="4 3"/>')
        title = (f"req {ex['req']} · total {ex['total_s']:.4g}s "
                 f"(queue {ex['queue_s']:.4g}s) · code "
                 f"({ex['n']},{ex['k']})")
        blocks.append(
            f'<div class="chart"><div class="t">{html.escape(title)}</div>'
            f'<svg viewBox="0 0 {_W} {h}" role="img" '
            f'aria-label="{html.escape(title)}">{"".join(rows)}'
            f'<text class="axis" x="{x0}" y="{h - 4}">0s</text>'
            f'<text class="axis" x="{x1}" y="{h - 4}" '
            f'text-anchor="end">{span:.4g}s</text></svg></div>')
    return '<div class="charts">' + "".join(blocks) + "</div>"


def _profile_table(profile: dict) -> str:
    head = ("fn", "flops", "bytes", "wall ms", "gflop/s", "gb/s", "bound",
            "peak %")
    rows = []
    for label, r in sorted(profile.items()):
        rows.append((
            html.escape(label), f"{r['flops']:.3g}", f"{r['bytes']:.3g}",
            f"{r['wall_s'] * 1e3:.3f}", f"{r['gflops']:.2f}",
            f"{r['gbps']:.2f}", r["bound"], f"{r['frac_peak'] * 100:.2f}",
        ))
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
        for row in rows
    )
    return (
        '<div class="prof"><table><tr>'
        + "".join(f"<th>{h}</th>" for h in head)
        + f"</tr>{body}</table></div>"
    )


def html_report(path: str, timelines: dict, *, slo: dict | None = None,
                profile: dict | None = None, meta: dict | None = None,
                exemplars: list | None = None,
                title: str = "repro.obs — time-resolved telemetry") -> str:
    """Write the self-contained HTML dashboard; returns the path.

    ``exemplars`` (optional flight-recorder anatomies,
    :meth:`repro_torch.obs.flight.FlightLog.exemplars`) adds the per-request
    task-race breakdown section."""
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<style>{_CSS}</style></head>",
        "<body class='viz-root'>",
        f"<h1>{html.escape(title)}</h1>",
    ]
    if meta:
        parts.append(
            f'<div class="meta">{html.escape(json.dumps(meta))}</div>')
    if slo:
        parts.append(_tiles(slo))
    for name, snap in timelines.items():
        parts.append(
            f"<h2>{html.escape(name)} "
            f'<span class="meta">window={snap.get("window", 1)} '
            f"arrivals/slot</span></h2>")
        parts.append('<div class="charts">')
        for sname, vals in snap.get("series", {}).items():
            parts.append(_svg_chart(sname, vals))
        for hname, hv in snap.get("hists", {}).items():
            spec = (slo or {}).get("spec", {})
            p = spec.get("percentile", 0.99)
            win = spec.get("window", 8)
            p99 = rolling_percentile(_hist_rows(hv), p, win)
            parts.append(_svg_chart(
                f"{hname} p{p * 100:g} (windowed, s)", p99,
                target=spec.get("target_s")))
        parts.append("</div>")
    if exemplars:
        parts.append("<h2>p99 exemplars "
                     '<span class="meta">task-race anatomy, simulated '
                     "time</span></h2>")
        parts.append(_exemplar_html(exemplars))
    if profile:
        parts.append("<h2>launch profile</h2>")
        parts.append(_profile_table(profile))
    parts.append(f"<script>{_JS}</script></body></html>")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("".join(parts))
    return path
