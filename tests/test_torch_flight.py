"""The port's per-request flight recorder on the CPU: mirrors of
``tests/test_flight.py`` — event-level oracle parity at the pinned parity
grid points, flight-off bit-identity, exemplar-miner determinism under
padding, one-case replay equality with the sweep cell, the serving
FlightRing, the window/no-data guards — plus the port's flight log held
against the reference's on the same inputs.

Tolerances: the reference test's own. Device flight rows against the
event oracle (which keeps time in float64): the same (req, lane, kind)
triples, start/end/depart within rtol 1e-3 / atol 2e-3. The replay against
its sweep cell: within 1e-6. The port's flight arrays against the
reference's: element for element (the engine is).
"""

import json

import numpy as np
import pytest
import torch

from repro.core.traces import TraceStore as RefTraceStore
from repro.obs.flight import FlightLog as RefFlightLog
from repro.taskq import taskq_scan as ref_taskq_scan
from repro_torch import obs
from repro_torch.core import PAPER_READ_3MB, RequestClass, StaticPolicy
from repro_torch.core.simulator import simulate
from repro_torch.core.traces import TraceStore
from repro_torch.fleet import PolicySpec, grid_cases
from repro_torch.obs.flight import (
    FLIGHT_SCHEMA,
    KINDS,
    FlightLog,
    FlightRing,
    exemplar_panel,
    oracle_task_rows,
)
from repro_torch.taskq import TaskqSweep, taskq_scan, taskq_streams, write_taskq_artifact

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
SIZES = tuple(CLS.file_mb / k for k in range(1, CLS.k_max + 1))
CPU = "cpu"


def make_pools(correlation: float, seed: int = 3, samples: int = 2048):
    store = TraceStore.generate(PAPER_READ_3MB, SIZES, threads=CLS.n_max, samples=samples,
                                correlation=correlation, seed=seed)
    return store, store.device_pools(n_max=CLS.n_max, device=CPU)


@pytest.fixture(scope="module")
def small():
    """One static-code grid point swept and flight-replayed once."""
    _, dp = make_pools(correlation=0.14)
    sweep = TaskqSweep(chunk=4, device=CPU)
    case = grid_cases([30.0], [PolicySpec.static(6, 3)], [7], CLS, L)[0]
    res = sweep.run([case], 300, dp)
    log = sweep.replay_flight(res, dp, 0)
    return dp, sweep, case, res, log


def _cfg_row(res, i=0):
    return {name: np.asarray(v[i]) for name, v in res.cfg.items() if name != "obs_count"}


# ---------------------------------------------------------------------------
# Event-level oracle parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,k,lam,correlation",
    [
        (1, 1, 8.0, 0.0),
        (6, 3, 30.0, 0.0),
        (12, 6, 20.0, 0.14),
        (4, 2, 45.0, 0.14),
    ],
)
def test_flight_records_match_oracle_event_log(n, k, lam, correlation):
    """Device flight records equal the discrete-event oracle's task event
    log ROW FOR ROW: identical (req, lane, kind) triples, start/end/depart
    within float32 tolerance (NaN-equal for tasks cancelled in queue)."""
    _, dp = make_pools(correlation)
    count = 1200
    case = grid_cases([lam], [PolicySpec.static(n, k)], [7], CLS, L)[0]
    sweep = TaskqSweep(chunk=4, device=CPU)
    res = sweep.run([case], count, dp)
    log = sweep.replay_flight(res, dp, 0)

    inter, idx = taskq_streams(case, count, dp.n_rows)
    arrivals = np.cumsum(inter.astype(np.float64))
    ev: list = []
    simulate(StaticPolicy(n, k), arrivals, dp.host_sampler(CLS.file_mb, idx), L=L,
             warmup_frac=0.0, event_log=ev)

    dev = log.task_rows()
    orc = oracle_task_rows(ev)
    assert len(dev) == count * n and len(orc) == len(dev)
    assert [r[:3] for r in dev] == [r[:3] for r in orc]
    d = np.array([r[3:] for r in dev], np.float64)
    o = np.array([r[3:] for r in orc], np.float64)
    np.testing.assert_allclose(d, o, rtol=1e-3, atol=2e-3)


def test_oracle_event_log_off_by_default():
    _, dp = make_pools(correlation=0.0)
    case = grid_cases([10.0], [PolicySpec.static(2, 1)], [1], CLS, L)[0]
    inter, idx = taskq_streams(case, 64, dp.n_rows)
    arrivals = np.cumsum(inter.astype(np.float64))
    sampler = dp.host_sampler(CLS.file_mb, idx)
    a = simulate(StaticPolicy(2, 1), arrivals, sampler, L=L, warmup_frac=0.0)
    ev: list = []
    b = simulate(StaticPolicy(2, 1), arrivals, sampler, L=L, warmup_frac=0.0, event_log=ev)
    np.testing.assert_array_equal(a.totals(), b.totals())
    assert len(ev) == 64 * 2


def test_flight_log_equals_reference_flight_log():
    """The same case through both engines' ``flight=True`` entry points:
    the same per-task rows, records and exemplars."""
    store = TraceStore.generate(PAPER_READ_3MB, SIZES, threads=CLS.n_max, samples=512,
                                correlation=0.14, seed=3)
    ref_store = RefTraceStore.generate(PAPER_READ_3MB, SIZES, threads=CLS.n_max, samples=512,
                                       correlation=0.14, seed=3)
    dp, rdp = store.device_pools(n_max=12, device=CPU), ref_store.device_pools(n_max=12)
    case = grid_cases([35.0], [PolicySpec.tofec()], [4], CLS, L)[0]
    res = TaskqSweep(chunk=4, device=CPU).run([case], 400, dp)
    cfg = _cfg_row(res)
    inter, idx = taskq_streams(case, 400, dp.n_rows)
    inter, idx = np.asarray(inter, np.float32), np.asarray(idx, np.int32)
    got = FlightLog(taskq_scan(cfg, inter, idx, dp.pools, dp.sizes_mb, L=L, collect=False,
                               flight=True), label="x")
    want = RefFlightLog(ref_taskq_scan(cfg, inter, idx, rdp.pools, rdp.sizes_mb, L=L,
                                       collect=False, flight=True), label="x")
    assert got.task_rows() == want.task_rows()
    assert got.records() == want.records()
    assert got.exemplars(4) == want.exemplars(4)


# ---------------------------------------------------------------------------
# Flight off: bit-identical outputs, untouched sweep buckets
# ---------------------------------------------------------------------------


def test_flight_off_outputs_bit_identical(small):
    dp, sweep, case, res, _ = small
    cfg = _cfg_row(res)
    inter, idx = taskq_streams(case, 300, dp.n_rows)
    inter = np.asarray(inter, np.float32)
    idx = np.asarray(idx, np.int32)
    kw = dict(L=case.L, q_cap=sweep.q_cap, collect=False)
    off = taskq_scan(cfg, inter, idx, dp.pools, dp.sizes_mb, **kw)
    on = taskq_scan(cfg, inter, idx, dp.pools, dp.sizes_mb, flight=True, **kw)
    assert "flight" not in off and "flight" in on
    for name in ("total", "queueing", "service", "n", "k"):
        np.testing.assert_array_equal(off[name].numpy(), on[name].numpy())


def test_replay_does_not_touch_sweep_compile_cache(small):
    """The zoom replay runs through ``taskq_scan``, not a sweep bucket: the
    sweep's bucket counter must not move."""
    dp, sweep, _, res, _ = small
    traces = sweep.stats.traces
    sweep.replay_flight(res, dp, 0)
    assert sweep.stats.traces == traces


def test_replay_flight_validates_case_index(small):
    dp, sweep, _, res, _ = small
    with pytest.raises(ValueError):
        sweep.replay_flight(res, dp, 1)
    with pytest.raises(ValueError):
        sweep.replay_flight(res, dp, -1)


# ---------------------------------------------------------------------------
# Replay equality + exemplar determinism
# ---------------------------------------------------------------------------


def test_replay_flight_matches_sweep_cell_delays(small):
    _, _, _, res, log = small
    out = res.to_numpy()
    np.testing.assert_allclose(log.total, out["total"][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(log.queueing, out["queueing"][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(log.n, out["n"][0])
    np.testing.assert_array_equal(log.k, out["k"][0])


def test_exemplar_miner_deterministic_under_padding(small):
    dp, sweep, case, res, _ = small
    cfg = _cfg_row(res)
    inter, idx = taskq_streams(case, 360, dp.n_rows)
    inter = np.asarray(inter, np.float32)
    idx = np.asarray(idx, np.int32)
    kw = dict(L=case.L, q_cap=sweep.q_cap, collect=False, flight=True)
    out = taskq_scan(cfg, inter[:300], idx[:300], dp.pools, dp.sizes_mb, **kw)
    out_pad = taskq_scan(cfg, inter, idx, dp.pools, dp.sizes_mb, **kw)
    plain = FlightLog(out)
    padded = FlightLog(out_pad, valid=np.arange(360) < 300)
    assert len(plain) == len(padded) == 300
    assert plain.exemplars(5) == padded.exemplars(5)
    assert max(r[0] for r in padded.task_rows()) < 300
    assert max(r["req"] for r in padded.records()) < 300


def test_flight_log_validates_mask_shape(small):
    dp, sweep, case, res, log = small
    out = taskq_scan(_cfg_row(res), *map(np.asarray, taskq_streams(case, 300, dp.n_rows)),
                     dp.pools, dp.sizes_mb, L=case.L, q_cap=sweep.q_cap, collect=False,
                     flight=True)
    with pytest.raises(ValueError, match="valid mask"):
        FlightLog(out, valid=np.ones(7, bool))


# ---------------------------------------------------------------------------
# Exports: NDJSON stream, Perfetto trace, dashboards, artifact
# ---------------------------------------------------------------------------


def test_flight_ndjson_records_schema(small, tmp_path):
    _, _, _, _, log = small
    path = log.write_ndjson(str(tmp_path / "flight_records.ndjson"))
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    assert len(recs) == len(log.records()) > 0
    for rec in recs:
        assert rec["schema"] == FLIGHT_SCHEMA
        assert rec["kind"] in KINDS
        if rec["kind"] == "cancel_queue":
            assert rec["start"] is None and rec["thread"] == -1
        else:
            assert rec["thread"] >= 0
            assert rec["end"] <= rec["depart"] + 1e-9
        if rec["kind"] == "cancel_service":
            assert rec["end"] == pytest.approx(rec["depart"])
    by_req: dict = {}
    for rec in recs:
        by_req.setdefault(rec["req"], []).append(rec)
    for rows in by_req.values():
        assert len(rows) == rows[0]["n"]
        assert sum(r["kind"] == "won" for r in rows) >= rows[0]["k"]


def test_flight_trace_loads_and_tracks_per_thread(small, tmp_path):
    _, _, _, _, log = small
    path = log.write_trace(str(tmp_path / "flight_trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    assert isinstance(events, list) and all("ph" in e for e in events)
    names = [e for e in events if e["ph"] == "M" and e["name"] == "thread_name"]
    tids = {e["tid"] for e in names}
    held = {int(t) for t in np.unique(log.thread) if t >= 0}
    assert tids == held | {999}
    slices = [e for e in events if e["ph"] == "X"]
    assert slices and all(e["dur"] >= 0 and e["tid"] in held for e in slices)
    starts = [e for e in events if e["ph"] == "s"]
    finishes = [e for e in events if e["ph"] == "f"]
    assert len(starts) == len(finishes) == len(log)


def test_exemplar_panel_and_dashboards_render(small, tmp_path):
    _, _, _, _, log = small
    ex = log.exemplars(3)
    assert len(ex) == 3
    assert ex[0]["total_s"] >= ex[1]["total_s"] >= ex[2]["total_s"]
    panel = exemplar_panel(ex)
    assert f"req {ex[0]['req']}" in panel and "#" in panel
    assert exemplar_panel([]) == "(no exemplars)"

    text = obs.ascii_dashboard({}, exemplars=ex)
    assert "p99 exemplars" in text and f"req {ex[0]['req']}" in text
    html_path = obs.html_report(str(tmp_path / "dash.html"), {}, exemplars=ex)
    html = open(html_path).read()
    assert "p99 exemplars" in html and f"req {ex[0]['req']}" in html
    assert "<svg" in html


def test_slo_report_links_exemplars(small):
    _, _, _, _, log = small
    ex = log.exemplars(2)
    rows = np.zeros((4, obs.DELAY_BINS))
    rows[1, -1] = 8
    snap = {"hists": {"delay": rows}, "window": 1,
            "series": {"pick_n": [6.0] * 4, "pick_k": [3.0] * 4}}
    spec = obs.SLOSpec(target_s=0.05, percentile=0.99, window=1)
    report = obs.slo_report(snap, spec, exemplars=ex)
    assert [e["req"] for e in report["exemplars"]] == [e["req"] for e in ex]
    breach = [e for e in report["events"].events if e["kind"] == "slo_breach"]
    assert breach and breach[0]["exemplar_reqs"] == [e["req"] for e in ex]


def test_taskq_artifact_flight_block(small, tmp_path):
    """``write_taskq_artifact(flight=...)`` adds the replayed cell's
    structural counts."""
    _, _, _, res, log = small
    art = write_taskq_artifact(str(tmp_path / "BENCH_taskq.json"), res, flight=log)
    block = json.loads((tmp_path / "BENCH_taskq.json").read_text())["flight"]
    assert block == art["flight"]
    assert block["label"] == log.label == "taskq[0]:static(6,3)"
    assert block["requests"] == 300 and block["records"] == len(log.records())
    assert block["exemplar_reqs"] == [ex["req"] for ex in log.exemplars(3)]


# ---------------------------------------------------------------------------
# Serving FlightRing
# ---------------------------------------------------------------------------


def test_flight_ring_compacted_clock_and_eviction(tmp_path):
    ring = FlightRing(capacity=2, label="serve")
    ring.record([("admit", 0.1), ("decode", 0.2)], requested=4, served=4, code=(8, 4))
    ring.record([("admit", 0.3)], requested=4, served=3, code=(8, 4))
    ring.record([("admit", 0.5)], requested=4, served=4, code=(12, 6))
    assert len(ring) == 2
    r1, r2 = ring.rounds()
    assert (r1.round, r2.round) == (1, 2)
    assert r1.t0 == pytest.approx(0.3) and r2.t0 == pytest.approx(0.6)
    assert r1.total_s == pytest.approx(0.3)

    recs = ring.records()
    assert all(r["schema"] == FLIGHT_SCHEMA for r in recs)
    assert recs[-1]["code"] == [12, 6] and recs[-1]["phases"] == {"admit": 0.5}

    path = ring.write_trace(str(tmp_path / "serve_flight.json"))
    doc = json.load(open(path))
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in slices} == {"round1", "round2", "admit"}

    with pytest.raises(ValueError):
        FlightRing(capacity=0)


# ---------------------------------------------------------------------------
# Window guards + no-data NaN contracts
# ---------------------------------------------------------------------------


def test_taskq_scan_window_zero_raises(small):
    dp, sweep, case, res, _ = small
    inter, idx = taskq_streams(case, 300, dp.n_rows)
    with pytest.raises(ValueError, match="window"):
        taskq_scan(_cfg_row(res), np.asarray(inter, np.float32), np.asarray(idx, np.int32),
                   dp.pools, dp.sizes_mb, L=case.L, q_cap=sweep.q_cap, window=0)


def test_sweep_timeline_window_zero_raises():
    from repro_torch.obs.timeline import sweep_timeline

    with pytest.raises(ValueError, match="window"):
        sweep_timeline({"total": torch.zeros(8)}, torch.ones(8), window=0)


def test_rolling_percentile_window_zero_raises():
    with pytest.raises(ValueError, match="window"):
        obs.rolling_percentile(np.zeros((4, obs.DELAY_BINS)), 0.99, 0)


def test_hist_percentile_all_zero_is_nan():
    rows = np.zeros((3, obs.DELAY_BINS))
    rows[1, 5] = 4
    p = obs.hist_percentile(rows, 0.99)
    assert np.isnan(p[0]) and np.isfinite(p[1]) and np.isnan(p[2])
    series = obs.rolling_percentile(rows, 0.99, 1)
    assert np.isnan(series[0]) and np.isfinite(series[1])


def test_burn_rate_no_data_is_nan_not_breach():
    spec = obs.SLOSpec(target_s=0.05, percentile=0.99, window=1)
    rows = np.zeros((5, obs.DELAY_BINS))
    rows[1, -1] = 10
    burn = obs.burn_rate(rows, spec)
    assert np.isnan(burn[0]) and burn[1] >= 1.0
    assert np.all(np.isnan(burn[2:]))

    snap = {"hists": {"delay": rows}, "window": 1,
            "series": {"pick_n": [1.0] * 5, "pick_k": [1.0] * 5}}
    report = obs.slo_report(snap, spec)
    kinds = [e["kind"] for e in report["events"].events]
    assert kinds.count("slo_breach") == 1
    assert kinds.count("slo_recovered") == 0
    assert report["breach_slots"] == 1
    assert np.isfinite(report["max_burn_rate"])
