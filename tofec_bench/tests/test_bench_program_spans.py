"""The readers of the program's own trace (``harness/program_spans.py``): the
window's reads and their tasks, None where the program recorded nothing, the
K1 lag on a known clock offset, and the stages against the service time on a
traced CPU run of the read cell."""

import statistics
import time

import pytest
import torch

from repro_torch import obs
from tofec_bench.harness import program_spans, readers, spec
from tofec_bench.harness.record import Record

READERS = ["store_wait_ms", "decode_wait_ms", "decode_ms", "conn_busy_share",
           "abandoned_conn_share", "pick_backlog", "k1_start_lag_ms"]


@pytest.fixture
def tracer(monkeypatch):
    t = obs.Tracer()
    monkeypatch.setattr(program_spans, "_tracer", lambda: t)
    return t


def _read(t, rid, t0, stages, tasks, q, raw=False):
    """One read arriving at ``t0`` with its stages (ms), tasks as (start,
    length, outcome) and the backlog at its pick."""
    obs.set_enabled(True)
    try:
        t.instant("proxy.pick", rid=rid, op="read", q=q, idle=0, n=2, k=1, cls_id=0)
    finally:
        obs.set_enabled(None)
    t._events[-1]["ts"] = (t0 - t.anchor[0]) * 1e6
    t.complete("proxy.read", t0, t0 + sum(stages.values()) / 1e3, rid=rid, n=2, k=1, ok=True,
               raw=raw, **stages)
    for i, (s, d, outcome) in enumerate(tasks):
        t.complete("proxy.task", s, s + d, rid=rid, op="read", chunk=i, outcome=outcome)


def _rec(t, **kw):
    e = t.anchor[0]
    return Record(t0=e + 10.0, t1=e + 20.0, config={"deployment": {"L": 4}}, **kw)


def test_the_window_keeps_its_reads_and_their_tasks(tracer):
    e = tracer.anchor[0]
    st = {"queue_ms": 5.0, "store_ms": 200.0, "decode_wait_ms": 2.0, "decode_ms": 3.0}
    _read(tracer, 0, e + 9.9, st, [(e + 9.95, 0.2, "used")], q=9)  # before the window
    _read(tracer, 1, e + 10.0, st, [(e + 10.005, 0.2, "used"), (e + 10.005, 0.3, "abandoned")],
          q=2)
    _read(tracer, 2, e + 19.9, {**st, "store_ms": 100.0},
          [(e + 19.905, 0.1, "used"), (e + 19.91, 0.0, "skipped")], q=4)  # ends past t1
    _read(tracer, 3, e + 20.0, st, [(e + 20.01, 0.5, "abandoned")], q=7)  # after it
    rec = _rec(tracer)
    w = program_spans.window(rec)
    assert [r["args"]["rid"] for r in w.reads] == [1, 2]
    assert sorted(x["args"]["rid"] for x in w.tasks) == [1, 1, 2, 2]
    assert program_spans.store_wait_ms(rec) == pytest.approx(150.0)
    assert program_spans.decode_wait_ms(rec) == pytest.approx(2.0)
    assert program_spans.decode_ms(rec) == pytest.approx(3.0)
    assert program_spans.pick_backlog(rec) == pytest.approx(3.0)
    assert program_spans.conn_busy_share(rec) == pytest.approx(100.0 * 0.6 / (4 * 10.0))
    assert program_spans.abandoned_conn_share(rec) == pytest.approx(100.0 * 0.3 / 0.6)


@pytest.mark.parametrize("name", READERS)
def test_no_events_read_none(tracer, name):
    rec = _rec(tracer, trace={"k1_kernels": [(1, 2)], "clock_offset_ns": 0})
    assert getattr(program_spans, name)(rec) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_proxys_events_reads_none(monkeypatch, name):
    """The parent's tracer: events and no window or anchor accessors."""

    class Older:
        def events(self):
            return [{"name": "proxy.read_many", "ph": "X", "ts": 0.0, "dur": 1.0, "args": {}}]

    monkeypatch.setattr(program_spans, "_tracer", Older)
    rec = Record(t0=0.0, t1=1.0, config={"deployment": {"L": 4}},
                 trace={"k1_kernels": [(1, 2)], "clock_offset_ns": 0})
    assert getattr(program_spans, name)(rec) is None


def test_the_k1_lag_on_a_known_clock_offset(tracer):
    e, wall0 = tracer.anchor
    offset = 123_456_789  # the profiler's clock minus the wall clock, ns
    for t in (1.0, 2.0, 3.0):  # decode spans of 2 ms at 1, 2 and 3 s
        tracer.complete("proxy.decode", e + t, e + t + 0.002, reads=1, rids=[0],
                        bitmat=[1, 48, 48], data=[1, 6, 524288])

    def on_profiler(t):
        return wall0 + round(t * 1e9) + offset

    kernels = [(on_profiler(0.5), on_profiler(0.6)),  # before any decode: not counted
               (on_profiler(1.0005), on_profiler(1.0007)),
               (on_profiler(2.001), on_profiler(2.0012)),
               (on_profiler(3.0015), on_profiler(3.0017))]
    rec = Record(trace={"k1_kernels": kernels, "clock_offset_ns": offset})
    assert program_spans.k1_start_lag_ms(rec) == pytest.approx(1.0, abs=1e-3)
    spans = program_spans.decode_spans_ns(rec)
    assert spans[0] == pytest.approx((on_profiler(1.0), on_profiler(1.002)), abs=2)
    rec.trace["k1_kernels"] = []
    assert program_spans.k1_start_lag_ms(rec) is None


def test_the_stages_of_a_traced_cpu_run_add_up_to_the_service_time(small):
    cell = spec.load_cell("read3mb-poisson", small)
    obs.reset_trace()
    try:
        rec = spec.driver(cell).run(cell, seed=2**31 + 7, seconds=1.5, traced=True,
                                    device=torch.device("cpu"), process_start=time.monotonic())
        assert all(c.holds for c in rec.checks if c.name != "k1_launches_in_window")
        got = {name: getattr(program_spans, name)(rec) for name in READERS}
        assert got["k1_start_lag_ms"] is None  # no K1 kernel on the CPU
        assert all(v is not None for k, v in got.items() if k != "k1_start_lag_ms")
        stages = got["store_wait_ms"] + got["decode_wait_ms"] + got["decode_ms"]
        assert stages == pytest.approx(readers.proxy_service_ms(rec), rel=0.02)
        assert 0 < got["conn_busy_share"] <= 100 and 0 <= got["abandoned_conn_share"] < 100
        assert statistics.mean(r["k"] for r in rec.requests) > 0
        assert len(program_spans.window(rec).picks) == len(rec.requests)
    finally:
        obs.reset_trace()
