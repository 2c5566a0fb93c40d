"""The arithmetic of the metric readers. Each file under ``metrics/`` binds
one of these functions as its ``read``; a reader returns None where its run
holds nothing to read, and the metric is then left out of the line.

End-to-end metrics are taken over every request (or round) of the window;
the closed-loop per-layer metrics read the rounds before the profiler
started, which slows every launch once it is loaded.
"""

from __future__ import annotations

from tofec_bench.harness import yardstick
from tofec_bench.harness.record import Record, percentile


def setup_s(rec: Record):
    return rec.setup_s


def latency_p50_ms(rec: Record):
    return percentile(rec.latencies_ms(), 50)


def latency_p95_ms(rec: Record):
    return percentile(rec.latencies_ms(), 95)


def gen_tokens_per_s(rec: Record):
    """Generated tokens of the window's rounds (every round started before
    the close, so the window ends at a round boundary) over the window."""
    if not rec.rounds:
        return None
    served = sum(1 for r in rec.requests if r["ok"])
    return served * rec.rounds[0]["steps"] / (rec.t1 - rec.t0)


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def proxy_queue_ms(rec: Record):
    return _mean(r["queue_s"] * 1e3 for r in rec.requests if "queue_s" in r)


def proxy_service_ms(rec: Record):
    return _mean(r["service_s"] * 1e3 for r in rec.requests if "service_s" in r)


def mean_k(rec: Record):
    return _mean(r["k"] for r in rec.requests if "k" in r)


def useful_chunk_share(rec: Record):
    """Σk / Σn over the window's reads, in %: the share of issued tasks whose
    chunk was needed."""
    ks = [(r["k"], r["n"]) for r in rec.requests if "k" in r]
    return 100.0 * sum(k for k, _ in ks) / sum(n for _, n in ks) if ks else None


def k1_roofline(rec: Record):
    """Σ of each traced K1 call's bound over Σ of its device time, in %.

    Each K1 kernel of the trace is paired with the last codec call into K1
    made before it started (the calls' wall-clock times moved onto the
    profiler's clock by the offset read at the traced range's start): the proxy's
    admission thread makes these calls one at a time, milliseconds apart,
    and each launches one kernel.
    """
    import bisect

    tr, calls = rec.trace, rec.extra.get("k1_calls", [])
    if not tr or not calls or not tr["k1_kernels"]:
        return None
    starts = [t + tr["clock_offset_ns"] for t, _, _ in calls]
    bound = busy = 0.0
    used = set()
    for s, e in tr["k1_kernels"]:
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or i in used:
            continue
        used.add(i)
        _, b, d = calls[i]
        bound += yardstick.k1_bound_s(b[0], b[1], b[2], d[2])
        busy += (e - s) / 1e9
    return 100.0 * bound / busy if busy > 0 else None


def device_idle(rec: Record):
    """The share of the traced window in which no operation ran on the
    device, in %."""
    if not rec.trace or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])


def _rounds(rec: Record):
    return [r for r in rec.rounds if not r["after_profiler"]]


def prompt_p50_ms(rec: Record):
    """The median delay of the requests served by the rounds before the
    profiler started: a steadier statistic beside the window's tail."""
    before = {i for i, r in enumerate(rec.rounds) if not r["after_profiler"]}
    return percentile([(r["done"] - r["due"]) * 1e3 for r in rec.requests
                       if r["done"] is not None and r.get("round") in before], 50)


def fetch_ms(rec: Record):
    return _mean(r["phase_ms"]["fetch"] for r in _rounds(rec))


def launch_ms_per_row(rec: Record):
    rs = _rounds(rec)
    return sum(r["phase_ms"]["launch"] for r in rs) / sum(r["padded"] for r in rs) if rs else None


def decode_step_ms(rec: Record):
    """The generate phase's device time over its decode steps (a round of
    s tokens runs s − 1 decode steps after the prefill's token)."""
    rs = [r for r in _rounds(rec) if r["steps"] > 1]
    return (sum(r["phase_ms"]["generate"] for r in rs) / sum(r["steps"] - 1 for r in rs)
            if rs else None)


def mfu(rec: Record):
    """Model FLOPs of the rows the rounds served (not the padding their
    batch bucket adds) over the rounds' wall time at the bfloat16 peak,
    in %."""
    rs = _rounds(rec)
    if not rs:
        return None
    model = rec.config["model"]
    flops = sum(yardstick.hybrid_flops(model, r["rows"], r["prompt"], r["steps"]) for r in rs)
    wall = sum(r["end"] - r["start"] for r in rs)
    return 100.0 * flops / (wall * yardstick.PEAK_BF16_FLOPS)
