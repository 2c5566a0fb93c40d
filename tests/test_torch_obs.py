"""The port's telemetry planes (``repro_torch.obs``) on the CPU: mirrors of
``tests/test_obs.py`` (all but its two tests of ``benchmarks/gate.py``, a
file of the reference only), and the port's collected outputs held against
the reference's on the same inputs.

Tolerances. Integer counters and histograms are held exactly. Float32
timeline series are held within 1e-6 relative where the scans' outputs are
equal: the port sums each window as a pairwise tree of adds (so a case's
slots never depend on its chunk), XLA in an order of its own. The fluid
scan's backlog series inherits that scan's own agreement with the
reference (rtol 1e-4 / atol 1e-6, ``tests/test_torch_fleet.py``): the port
takes Δ̃·J and Ψ̃·J rounded from float64. Streamed and materialized runs of
the port are held bit for bit.
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
from repro import obs as ref_obs
from repro.core import PAPER_READ_3MB as REF_READ_3MB
from repro.core import RequestClass as RefRequestClass
from repro.core.traces import TraceStore as RefTraceStore
from repro.sched import DisciplineSpec as RefDisciplineSpec
from repro.sched import SchedSweep as RefSchedSweep
from repro.sched import sched_cases as ref_sched_cases
from repro.taskq import TaskqSweep as RefTaskqSweep
from repro_torch import obs
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.core.traces import TraceStore
from repro_torch.fleet import FleetSweep, PolicySpec, TenantMix, grid_cases
from repro_torch.models import get, params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import Arch
from repro_torch.sched import DisciplineSpec, SchedSweep, sched_cases
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.storage import MemoryStore, Proxy
from repro_torch.taskq import TaskqSweep, taskq_streams

CPU = torch.device("cpu")
CODEC = Codec("kernel", device=CPU)
CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
SIZES = tuple(CLS.file_mb / k for k in range(1, CLS.k_max + 1))
PROMPT_LEN = 16


@pytest.fixture
def obs_on():
    obs.set_enabled(True)
    obs.reset_trace()
    yield
    obs.set_enabled(None)
    obs.reset_trace()


@pytest.fixture
def obs_off():
    obs.set_enabled(False)
    yield
    obs.set_enabled(None)


@contextlib.contextmanager
def both_collecting(on: bool = True):
    """Collection on (or off) in the port and in the reference at once."""
    obs.set_enabled(on)
    ref_obs.set_enabled(on)
    try:
        yield
    finally:
        obs.set_enabled(None)
        ref_obs.set_enabled(None)


def _pools(seed=3, samples=512):
    store = TraceStore.generate(PAPER_READ_3MB, SIZES, threads=CLS.n_max, samples=samples,
                                correlation=0.0, seed=seed)
    return store.device_pools(n_max=CLS.n_max, device=CPU)


def _ref_pools(seed=3, samples=512):
    store = RefTraceStore.generate(REF_READ_3MB, SIZES, threads=CLS.n_max, samples=samples,
                                   correlation=0.0, seed=seed)
    return store.device_pools(n_max=CLS.n_max)


def _grid(n_seeds=2):
    return grid_cases([10.0, 25.0], [PolicySpec.tofec(), PolicySpec.static(12, 6)],
                      list(range(n_seeds)), CLS, L)


def _ref_grid(n_seeds=2):
    return ref_fleet.grid_cases(
        [10.0, 25.0], [ref_fleet.PolicySpec.tofec(), ref_fleet.PolicySpec.static(12, 6)],
        list(range(n_seeds)), REF_CLS, L)


def _fleet(**kw) -> FleetSweep:
    return FleetSweep(device=CPU, **kw)


def _taskq(**kw) -> TaskqSweep:
    return TaskqSweep(device=CPU, **kw)


def _snap_equal(got: dict, want: dict):
    """Two MetricsBuf snapshots equal: counters and histograms exactly,
    highs to float32 (the same value, read from two frameworks)."""
    assert got["counters"] == want["counters"]
    assert got["hists"] == want["hists"]
    assert got["highs"].keys() == want["highs"].keys()
    for name, v in want["highs"].items():
        assert got["highs"][name] == pytest.approx(v, rel=1e-6), name


def _timelines_close(got: dict, want: dict, *, skip=()):
    """Two timeline snapshots: the same slotting and delay histograms, the
    float32 series within 1e-6 relative (``skip``: held elsewhere)."""
    for key in ("window", "capacity", "slots", "pos"):
        assert got[key] == want[key], key
    assert set(got["series"]) == set(want["series"])
    for name, v in want["series"].items():
        if name not in skip:
            np.testing.assert_allclose(got["series"][name], v, rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(got["hists"]["delay"], want["hists"]["delay"])


# ---------------------------------------------------------------------------
# MetricsBuf: host-visible semantics of the device folds
# ---------------------------------------------------------------------------


def test_metricsbuf_count_observe_high_snapshot():
    buf = obs.MetricsBuf.zeros(counters=("c",), hists={"h": 4}, highs=("hi",), device=CPU)
    buf = buf.count("c", 3).count("c")
    buf = buf.observe("h", torch.tensor([0, 1, 1, 9]))  # 9 clips to last bucket
    buf = buf.observe("h", torch.tensor([2, 2]), weight=torch.tensor([1, 0]))
    buf = buf.high("hi", torch.tensor([1.5, 7.25, 0.0])).high("hi", 2.0)
    snap = buf.snapshot()
    assert snap["counters"]["c"] == 4
    assert snap["hists"]["h"] == [1, 2, 1, 1]
    assert snap["highs"]["hi"] == 7.25


def test_metricsbuf_reduce_rows_drops_tail_padding():
    buf = obs.MetricsBuf(
        counters={"c": torch.tensor([1, 2, 99], dtype=torch.int32)},
        hists={"h": torch.tensor([[1, 0], [0, 1], [5, 5]], dtype=torch.int32)},
        highs={"hi": torch.tensor([1.0, 3.0, 9.0])},
    )
    snap = buf.reduce_rows(2).snapshot()
    assert snap["counters"]["c"] == 3
    assert snap["hists"]["h"] == [1, 1]
    assert snap["highs"]["hi"] == 3.0


def test_metricsbuf_merge_unions_disjoint_and_adds_shared():
    a = obs.MetricsBuf.zeros(counters=("x",), highs=("hi",), device=CPU).count("x", 2)
    b = obs.MetricsBuf.zeros(counters=("x", "y"), highs=("hi",), device=CPU)
    b = b.count("x", 5).count("y", 1).high("hi", 4.0)
    snap = a.merge(b).snapshot()
    assert snap["counters"] == {"x": 7, "y": 1}
    assert snap["highs"]["hi"] == 4.0


def test_prometheus_exposition_shape():
    buf = obs.MetricsBuf.zeros(counters=("reqs",), hists={"q": 3}, highs=("q_hi",), device=CPU)
    buf = buf.count("reqs", 2).observe("q", torch.tensor([0, 2, 2])).high("q_hi", 2.0)
    text = buf.to_prometheus(prefix="t")
    assert "# TYPE t_reqs_total counter" in text
    assert "t_reqs_total 2" in text
    assert 't_q_bucket{le="0"} 1' in text
    assert 't_q_bucket{le="+Inf"} 3' in text
    assert "t_q_count 3" in text
    assert "t_q_hi 2.0" in text


def test_metricsbuf_batched_rows_equal_the_reference_vmapped_buf():
    """A buffer with one row per case (the sweeps' form) reduces to the
    reference's vmapped buffer, reduced: per-row observe, high and count."""
    rng = np.random.default_rng(0)
    vals = rng.integers(-2, 40, size=(5, 30))
    wts = rng.integers(0, 2, size=(5, 30))
    hi = rng.exponential(1.0, size=(5, 30)).astype(np.float32)

    def ref_one(v, w, h):
        b = ref_obs.MetricsBuf.zeros(counters=("c",), hists={"h": 33}, highs=("hi",))
        return b.count("c", w.sum()).observe("h", v, weight=w).high("hi", h)

    want = jax.vmap(ref_one)(jnp.asarray(vals), jnp.asarray(wts), jnp.asarray(hi))
    got = obs.MetricsBuf.zeros(counters=("c",), hists={"h": 33}, highs=("hi",), batch=(5,),
                               device=CPU)
    w = torch.from_numpy(wts)
    got = got.count("c", w.sum(1)).observe("h", torch.from_numpy(vals), weight=w)
    got = got.high("hi", torch.from_numpy(hi))
    _snap_equal(got.reduce_rows(4).snapshot(), want.reduce_rows(4).snapshot())


# ---------------------------------------------------------------------------
# Sweep collection: invariance, padding masks, host recounts
# ---------------------------------------------------------------------------


def test_fleet_collection_invariant_and_histograms_match_host_recount():
    cases, count = _grid(), 300  # the slots cover a larger pow2 time bucket
    try:
        obs.set_enabled(False)
        base = _fleet(chunk=4).run(cases, count)
        obs.set_enabled(True)
        res = _fleet(chunk=4).run(cases, count)
    finally:
        obs.set_enabled(None)
    for name in base.out:  # primary outputs bit-identical with collection on
        np.testing.assert_array_equal(base.out[name].numpy(), res.out[name].numpy())
    assert res.compiles == base.compiles  # the collect flag is in the key
    assert base.metrics is None and res.metrics is not None
    snap = res.metrics.snapshot()
    G = len(cases)
    assert snap["counters"]["fleet_requests"] == G * count
    ks = res.out["k"].numpy().astype(int)
    ns = res.out["n"].numpy().astype(int)
    assert snap["counters"]["fleet_tasks"] == int(ns.sum())
    np.testing.assert_array_equal(snap["hists"]["fleet_pick_k"],
                                  np.bincount(ks.ravel(), minlength=obs.PICK_BINS))
    np.testing.assert_array_equal(snap["hists"]["fleet_pick_n"],
                                  np.bincount(ns.ravel(), minlength=obs.PICK_BINS))
    assert snap["highs"]["fleet_delay_hi"] == pytest.approx(
        float(res.out["total"].numpy().max()), rel=1e-6)


def test_fleet_collection_matches_reference():
    """The port's fleet metrics and timeline against the reference's on the
    same grid: the same counts and histograms, the series within 1e-6
    (backlog within the scan's own tolerance)."""
    count = 300
    with both_collecting():
        res = _fleet(chunk=4).run(_grid(), count)
        ref = ref_fleet.FleetSweep(chunk=4).run(_ref_grid(), count)
    np.testing.assert_array_equal(res.out["n"].numpy(), np.asarray(ref.out["n"]))
    np.testing.assert_array_equal(res.out["k"].numpy(), np.asarray(ref.out["k"]))
    _snap_equal(res.metrics.snapshot(), ref.metrics.snapshot())
    got, want = res.timeline.snapshot(), ref.timeline.snapshot()
    _timelines_close(got, want, skip=("backlog",))
    np.testing.assert_allclose(got["series"]["backlog"], want["series"]["backlog"],
                               rtol=1e-4, atol=1e-6)


def test_taskq_collection_invariant_with_exact_cancellations(obs_on):
    cases, count = _grid(n_seeds=1), 200
    dp = _pools()
    obs.set_enabled(False)
    base = _taskq(chunk=4).run(cases, count, dp)
    obs.set_enabled(True)
    res = _taskq(chunk=4).run(cases, count, dp)
    for name in base.out:
        np.testing.assert_array_equal(base.out[name].numpy(), res.out[name].numpy())
    assert res.compiles == base.compiles == 1
    snap = res.metrics.snapshot()
    G = len(cases)
    assert snap["counters"]["taskq_requests"] == G * count
    ns = res.out["n"].numpy().astype(int)
    ks = res.out["k"].numpy().astype(int)
    c = snap["counters"]
    assert c["taskq_cancelled"] == c["taskq_cancel_queue"] + c["taskq_cancel_service"]
    assert 0 < c["taskq_cancelled"] <= int((ns - ks).sum())
    assert sum(snap["hists"]["taskq_idle"]) == G * count
    assert len(snap["hists"]["taskq_idle"]) == L + 1
    assert snap["highs"]["taskq_q_hi"] >= 0.0


def test_taskq_collection_matches_reference():
    """The exact engine equals the reference's element for element, so its
    telemetry does too: every counter and histogram, the backlog series."""
    count = 200
    with both_collecting():
        res = _taskq(chunk=4).run(_grid(n_seeds=1), count, _pools())
        ref = RefTaskqSweep(chunk=4).run(_ref_grid(n_seeds=1), count, _ref_pools())
    np.testing.assert_array_equal(res.out["total"].numpy(), np.asarray(ref.out["total"]))
    _snap_equal(res.metrics.snapshot(), ref.metrics.snapshot())
    _timelines_close(res.timeline.snapshot(), ref.timeline.snapshot())


def test_taskq_scan_entry_point_collect_arg(obs_off):
    from repro.taskq.engine import taskq_scan as ref_taskq_scan
    from repro_torch.taskq.engine import taskq_scan
    from repro_torch.taskq.policies import encode_policy

    case = _grid(n_seeds=1)[0]
    dp = _pools()
    enc = encode_policy(PolicySpec.static(12, 6), CLS, L, CLS.k_max + 1, CLS.n_max + 1, None)
    cfg = {"J": CLS.file_mb, "alpha": enc.alpha, "r_max": enc.r_max, "pol": enc.pol,
           "gk_max": enc.gk_max, "h_k": enc.h_k, "h_n": enc.h_n}
    inter, idx = taskq_streams(case, 64, dp.n_rows)
    off = taskq_scan(cfg, inter, idx, dp.pools, dp.sizes_mb, L=L)
    on = taskq_scan(cfg, inter, idx, dp.pools, dp.sizes_mb, L=L, collect=True, window=8)
    assert "obs" not in off and "obs" in on
    for name in off:
        np.testing.assert_array_equal(off[name].numpy(), on[name].numpy())
    rp = _ref_pools()
    ref = ref_taskq_scan(cfg, inter, idx, rp.pools, rp.sizes_mb, L=L, collect=True, window=8)
    _snap_equal(on["obs"].snapshot(), ref["obs"].snapshot())
    _timelines_close(on["timeline"].snapshot(), ref["timeline"].snapshot())


def test_sched_collection_invariant_and_matches_reference():
    """The joint scan's rate, pick and delay series (no backlog) and its
    pick histograms, with collection leaving the outputs bit-identical."""
    lo = RequestClass("read1mb", 1.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
    ref_lo = RefRequestClass("read1mb", 1.0, REF_READ_3MB, k_max=4, r_max=2.0, n_max=8)
    cases = sched_cases([TenantMix(20.0, (CLS, lo), (0.5, 0.5))],
                        [DisciplineSpec.fifo(), DisciplineSpec.priority(0, 1)], [0], L=L)
    ref_cases = ref_sched_cases(
        [ref_fleet.TenantMix(20.0, (REF_CLS, ref_lo), (0.5, 0.5))],
        [RefDisciplineSpec.fifo(), RefDisciplineSpec.priority(0, 1)], [0], L=L)
    count = 300
    with both_collecting(False):
        base = SchedSweep(chunk=4, device=CPU).run(cases, count)
    with both_collecting():
        res = SchedSweep(chunk=4, device=CPU).run(cases, count)
        ref = RefSchedSweep(chunk=4).run(ref_cases, count)
    for name in base.out:
        np.testing.assert_array_equal(base.out[name].numpy(), res.out[name].numpy())
    assert base.metrics is None and res.compiles == base.compiles
    snap = res.metrics.snapshot()
    assert snap["counters"]["sched_requests"] == len(cases) * count
    np.testing.assert_array_equal(res.out["n"].numpy(), np.asarray(ref.out["n"]))
    _snap_equal(snap, ref.metrics.snapshot())
    got = res.timeline.snapshot()
    assert "backlog" not in got["series"]
    _timelines_close(got, ref.timeline.snapshot())


def test_streamed_and_rechunked_collection_equal_materialized(obs_on):
    """Metrics and timelines do not depend on how the grid was chunked, nor
    on whether the run streamed: bit for bit."""
    cases, count = _grid(), 333
    mat = _fleet(chunk=8).run(cases, count)
    for other in (_fleet(chunk=2).run(cases, count),
                  _fleet(chunk=4).run(cases, count, stream=True)):
        assert other.metrics.snapshot() == mat.metrics.snapshot()
        a, b = mat.timeline.snapshot(), other.timeline.snapshot()
        for name in a["series"]:
            np.testing.assert_array_equal(a["series"][name], b["series"][name])
        np.testing.assert_array_equal(a["hists"]["delay"], b["hists"]["delay"])


# ---------------------------------------------------------------------------
# Closed-loop serving: device metrics ride the round
# ---------------------------------------------------------------------------


def _serve_tokens(rounds=2, steps=2):
    arch = get("qwen1.5-0.5b", smoke=True)
    params = arch.init(torch.Generator().manual_seed(2))
    eng = ServingEngine(arch, params, max_seq=64)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store = MemoryStore()
    rng = np.random.default_rng(6)
    keys = []
    for i in range(3):
        toks = rng.integers(0, arch.cfg.vocab, size=(PROMPT_LEN,)).astype(np.int32)
        ServingEngine.store_prompt(store, f"p/{i}", layout, toks, codec=CODEC)
        keys.append(f"p/{i}")
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=CODEC,
                  write_policy=FeedbackPolicy(layout.N, layout.K))
    step = FusedServingStep.for_policy(ServePolicy.tofec(), CLS, L, codec=CODEC)
    server = ClosedLoopServer(eng, proxy, layout, step, prompt_len=PROMPT_LEN)
    try:
        results = [server.serve_round(keys, steps=steps) for _ in range(rounds)]
        return [r.tokens for r in results], server
    finally:
        proxy.close()


def test_closed_loop_metrics_invariant_and_exact(tmp_path):
    obs.set_enabled(False)
    try:
        toks_off, server_off = _serve_tokens()
    finally:
        obs.set_enabled(None)
    obs.set_enabled(True)
    obs.reset_trace()
    try:
        toks_on, server_on = _serve_tokens()
        for a, b in zip(toks_off, toks_on):
            np.testing.assert_array_equal(a, b)
        assert server_on.traces == server_off.traces == 1
        assert server_off.metrics is None
        snap = server_on.metrics.snapshot()
        c = snap["counters"]
        assert c["serve_rounds"] == 2
        assert c["serve_requested"] == 2 * 3
        assert c["serve_served"] == 2 * 3
        assert c["serve_decode_errors"] == 0
        assert sum(snap["hists"]["serve_batch"]) == 2
        assert sum(snap["hists"]["serve_pick_n"]) == 2
        assert snap["highs"]["serve_q_hi"] >= 0.0
        names = {ev["name"] for ev in obs.get_tracer().events()}
        assert {"serve.round", "serve.fetch", "serve.launch", "serve.generate"} <= names
        path = obs.write_trace(str(tmp_path / "serve_trace.json"))
        doc = json.load(open(path))
        assert any(ev["name"] == "serve.round" for ev in doc["traceEvents"])
        assert "repro_serve_rounds_total 2" in obs.to_prometheus(snap)
    finally:
        obs.set_enabled(None)
        obs.reset_trace()


def _float32_archs(seed=2):
    """The reference's smoke qwen in float32 and the port's with the same
    parameters."""
    from repro.models import get as ref_get
    from repro.models.registry import Arch as RefArch

    ref = ref_get("qwen1.5-0.5b", smoke=True)
    cfg = dataclasses.replace(ref.cfg, dtype="float32")
    ref = RefArch(cfg=cfg, module=ref.module)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(cfg)),
                module=get("qwen1.5-0.5b", smoke=True).module)
    rp = ref.init(jax.random.key(seed))
    return ref, rp, port, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


def test_closed_loop_telemetry_matches_reference():
    """Both closed loops, 3 rounds over the same stored prompts with
    collection on: the same counters, q / batch / pick histograms, pick,
    served and backlog series and delay-histogram row sums (the delays
    themselves are wall times)."""
    from repro.coding.codec import Codec as RefCodec
    from repro.coding.layout import SharedKeyLayout as RefSharedKeyLayout
    from repro.core import FeedbackPolicy as RefFeedbackPolicy
    from repro.core import StaticPolicy as RefStaticPolicy
    from repro.serve.engine import ClosedLoopServer as RefClosedLoopServer
    from repro.serve.engine import FusedServingStep as RefFusedServingStep
    from repro.serve.engine import ServePolicy as RefServePolicy
    from repro.serve.engine import ServingEngine as RefServingEngine
    from repro.storage import MemoryStore as RefMemoryStore
    from repro.storage import Proxy as RefProxy

    ref, rp, port, pp = _float32_archs()
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    ref_layout = RefSharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store, ref_store = MemoryStore(), RefMemoryStore()
    rng = np.random.default_rng(6)
    keys = [f"p/{i}" for i in range(3)]
    for key in keys:
        toks = rng.integers(0, port.cfg.vocab, size=(PROMPT_LEN,)).astype(np.int32)
        ServingEngine.store_prompt(store, key, layout, toks, codec=CODEC)
        RefServingEngine.store_prompt(ref_store, key, ref_layout, toks)
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=CODEC,
                  write_policy=FeedbackPolicy(layout.N, layout.K))
    ref_proxy = RefProxy(ref_store, RefStaticPolicy(8, 4), L=8,
                         write_policy=RefFeedbackPolicy(ref_layout.N, ref_layout.K))
    server = ClosedLoopServer(ServingEngine(port, pp, max_seq=64), proxy, layout,
                              FusedServingStep.for_policy(ServePolicy.tofec(), CLS, L,
                                                          codec=CODEC),
                              prompt_len=PROMPT_LEN)
    ref_server = RefClosedLoopServer(
        RefServingEngine(ref, rp, max_seq=64), ref_proxy, ref_layout,
        RefFusedServingStep.for_policy(RefServePolicy.tofec(), REF_CLS, L,
                                       codec=RefCodec("jnp")),
        prompt_len=PROMPT_LEN)
    try:
        with both_collecting():
            for _ in range(3):
                server.serve_round(keys, steps=2)
                ref_server.serve_round(keys, steps=2)
    finally:
        proxy.close()
        ref_proxy.close()
    assert server.traces == ref_server.traces == 1
    _snap_equal(server.metrics.snapshot(), ref_server.metrics.snapshot())
    got, want = server.timeline.snapshot(), ref_server.timeline.snapshot()
    assert (got["slots"], got["pos"], got["capacity"]) == (want["slots"], want["pos"],
                                                           want["capacity"]) == (3, 3, 256)
    for name in ("pick_n", "pick_k", "served", "backlog"):
        np.testing.assert_array_equal(got["series"][name], want["series"][name], err_msg=name)
    np.testing.assert_array_equal(got["hists"]["delay"].sum(axis=1),
                                  want["hists"]["delay"].sum(axis=1))
    assert [r["code"] for r in server.flight.records()] == \
        [r["code"] for r in ref_server.flight.records()]
    assert [list(r["phases"]) for r in server.flight.records()] == \
        [["admit", "decode", "generate"]] * 3


# ---------------------------------------------------------------------------
# Span tracing
# ---------------------------------------------------------------------------


def test_span_nesting_and_chrome_trace_json(obs_on, tmp_path):
    tr = obs.get_tracer()
    with obs.span("outer", mesh=[1]):
        with obs.span("inner", bucket="(4, 64)"):
            pass
        with obs.span("inner"):
            pass
    by_name: dict = {}
    for ev in tr.events():
        by_name.setdefault(ev["name"], []).append(ev)
    (outer,), inners = by_name["outer"], by_name["inner"]
    assert outer["args"]["depth"] == 0
    assert outer["args"]["parent"] is None
    assert all(ev["args"]["depth"] == 1 for ev in inners)
    assert all(ev["args"]["parent"] == "outer" for ev in inners)
    assert inners[0]["args"]["bucket"] == "(4, 64)"
    path = obs.write_trace(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms"
    assert len(doc["traceEvents"]) == 3
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0 and "pid" in ev and "tid" in ev
    agg = obs.aggregate()
    assert agg["inner"]["count"] == 2
    assert agg["outer"]["total_us"] >= agg["outer"]["max_us"]
    assert "outer" in tr.format_table()


def test_spans_disabled_record_nothing():
    obs.set_enabled(False)
    obs.reset_trace()
    try:
        with obs.span("never"):
            pass
        assert obs.get_tracer().events() == []
    finally:
        obs.set_enabled(None)


def test_traced_decorator(obs_on):
    calls = []

    @obs.traced("deco.fn", tag=1)
    def fn(x):
        calls.append(x)
        return x + 1

    assert fn(1) == 2 and calls == [1]
    ev = [e for e in obs.get_tracer().events() if e["name"] == "deco.fn"]
    assert len(ev) == 1 and ev[0]["args"]["tag"] == 1


def test_sweep_run_emits_spans(obs_on):
    _fleet(chunk=4).run(_grid(n_seeds=1), 64)
    events = obs.get_tracer().events()
    names = {ev["name"] for ev in events}
    assert {"sweep.chunk", "sweep.launch", "sweep.trace"} <= names
    (first,) = [ev for ev in events if ev["name"] == "sweep.trace"]
    assert first["args"]["engine"] == "FleetSweep" and first["args"]["mesh"] == "()"


def test_codec_bucket_first_use_emits_build_span(obs_on):
    codec = Codec("kernel", device=CPU)
    data = np.arange(4 * 64, dtype=np.uint8).reshape(4, 64)
    codec.encode(data, n=6, k=4)
    codec.encode(data, n=6, k=4)
    builds = [ev for ev in obs.get_tracer().events() if ev["name"] == "codec.build"]
    assert len(builds) == codec.stats.traces == 1
    assert builds[0]["args"]["backend"] == "kernel"


# ---------------------------------------------------------------------------
# Shared compile accounting + run metadata
# ---------------------------------------------------------------------------


def test_compile_stats_registry_and_aliases():
    from repro_torch.coding.codec import CodecStats

    s = obs.CompileStats(label="test.engine")
    s.traces += 2
    s.launches += 5
    snap = obs.compile_snapshot()
    assert snap["test.engine"]["traces"] == 2
    assert snap["test.engine"]["launches"] == 5
    assert CodecStats is obs.CompileStats
    assert isinstance(_fleet().stats, obs.CompileStats)


def test_run_meta_fields():
    meta = obs.run_meta(mesh_shape=(2, 4))
    assert meta["schema_version"] == obs.SCHEMA_VERSION
    assert meta["host_cores"] >= 1
    assert meta["host_devices"] == torch.cuda.device_count()  # the port counts cards
    assert meta["mesh_shape"] == [2, 4]
    rev = meta["git_rev"]
    assert rev is None or (isinstance(rev, str) and len(rev) >= 7)


# ---------------------------------------------------------------------------
# TimelineBuf: ring semantics, windows, percentile recovery, buckets
# ---------------------------------------------------------------------------


def test_timeline_window_rule():
    assert obs.timeline_window(64) == 1
    assert obs.timeline_window(8) == 1
    assert obs.timeline_window(512) == 8
    assert obs.timeline_window(1024) == 16
    for t_b in (8, 64, 512, 4096, 1 << 20):
        assert obs.timeline_window(t_b) == ref_obs.timeline_window(t_b)


def test_timelinebuf_ring_wrap_restores_order():
    buf = obs.TimelineBuf.zeros(4, series=("x",), hists={"h": 3}, device=CPU)
    for i in range(6):
        buf = buf.append({"x": float(i)}, {"h": (torch.tensor([i % 3]), torch.tensor([1]))})
    snap = buf.snapshot()
    assert snap["slots"] == 4 and snap["pos"] == 6
    np.testing.assert_array_equal(snap["series"]["x"], [2.0, 3.0, 4.0, 5.0])
    np.testing.assert_array_equal(snap["hists"]["h"].sum(axis=1), [1, 1, 1, 1])
    np.testing.assert_array_equal(np.argmax(snap["hists"]["h"], axis=1), [2, 0, 1, 2])


def test_timelinebuf_concat_validates_slotting():
    a = obs.TimelineBuf.zeros(4, series=("x",), window=2, device=CPU)
    b = obs.TimelineBuf.zeros(8, series=("x",), window=2, device=CPU)
    with pytest.raises(ValueError, match="slotting"):
        a.concat(b)


def test_hist_percentile_and_rolling():
    from repro_torch.obs.timeline import bucket_edges

    edges = bucket_edges()
    h = np.zeros((2, obs.DELAY_BINS))
    h[0, 10] = 99
    h[0, 50] = 1
    p = obs.hist_percentile(h, 0.5)
    assert p[0] == edges[10]
    assert obs.hist_percentile(h, 0.999)[0] == edges[50]
    assert np.isnan(p[1])
    r = obs.rolling_percentile(h, 0.5, window=2)
    assert r[1] == edges[10]


def _ulps_around(v: np.float32, n: int) -> np.ndarray:
    bits = np.array([v], np.float32).view(np.int32)[0]
    return np.arange(bits - n, bits + n + 1, dtype=np.int32).view(np.float32)


def test_delay_bucket_equals_reference_at_every_edge():
    """Every bucket edge 2**((i - 48) / 8), i = -8 .. 104, ± 8 ulps, and a
    log-uniform sweep from 2**-8 to 2**8 s: the port's buckets equal
    ``repro.obs.delay_bucket``'s (XLA's float32 log2) exactly. The edge
    table itself is re-derived from the reference here: for each bucket the
    least float32 the reference puts in it, within 64 ulps of its edge,
    with the reference monotone across the window."""
    from repro_torch.obs.timeline import _EDGE_BITS

    vals = np.concatenate([_ulps_around(np.float32(2.0 ** ((i - 48) / 8)), 8)
                           for i in range(-8, 105)])
    rng = np.random.default_rng(0)
    sweep = np.float32(2.0) ** rng.uniform(-8, 8, 20000).astype(np.float32)
    odd = np.array([0.0, 1e-9, 60.0, 1e6, 3e38, -1.0, np.inf, -np.inf, np.nan], np.float32)
    vals = np.concatenate([vals, sweep, odd])
    want = np.asarray(ref_obs.delay_bucket(jnp.asarray(vals)))
    got = obs.delay_bucket(torch.from_numpy(vals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for i, bits in enumerate(_EDGE_BITS, start=1):
        win = _ulps_around(np.float32(2.0 ** ((i - 48) / 8)), 64)
        b = np.asarray(ref_obs.delay_bucket(jnp.asarray(win)))
        assert (np.diff(b) >= 0).all() and b[0] < i <= b[-1], i
        assert win[np.argmax(b >= i)].view(np.int32) == bits, i


def test_sweep_timeline_rejects_bad_window():
    out = {"total": torch.ones(10), "n": torch.ones(10), "k": torch.ones(10)}
    with pytest.raises(ValueError, match="not divisible"):
        obs.sweep_timeline(out, torch.ones(10), window=3)


def test_sweep_timeline_of_one_case_equals_reference():
    """One case's (T,) outputs and a (G, T) grid's rows give the
    reference's windowed timeline; ``horizon`` adds empty slots past T."""
    rng = np.random.default_rng(3)
    T, window = 96, 8
    out = {"total": rng.exponential(0.3, T).astype(np.float32),
           "n": rng.integers(1, 13, T).astype(np.int32),
           "k": rng.integers(1, 7, T).astype(np.int32)}
    inter = rng.exponential(0.05, T).astype(np.float32)
    backlog = rng.integers(0, 9, T).astype(np.float32)
    want = ref_obs.sweep_timeline({k: jnp.asarray(v) for k, v in out.items()},
                                  jnp.asarray(inter), window=window,
                                  backlog=jnp.asarray(backlog)).snapshot()
    got = obs.sweep_timeline({k: torch.from_numpy(v) for k, v in out.items()},
                             torch.from_numpy(inter), window=window,
                             backlog=torch.from_numpy(backlog)).snapshot()
    _timelines_close(got, want)
    padded = obs.sweep_timeline({k: torch.from_numpy(v)[None] for k, v in out.items()},
                                torch.from_numpy(inter)[None], window=window,
                                horizon=2 * T).snapshot()
    assert padded["capacity"] == 24 and padded["pos"] == [24]
    np.testing.assert_array_equal(padded["hists"]["delay"][0, :12], want["hists"]["delay"])
    assert padded["hists"]["delay"][0, 12:].sum() == 0
    assert (padded["series"]["served"][0, 12:] == 0).all()
    assert (padded["series"]["lam"][0, 12:] == 0).all()


# ---------------------------------------------------------------------------
# Sweep timelines: host recounts, stream invariance
# ---------------------------------------------------------------------------


def test_fleet_timeline_matches_host_recount(obs_on):
    cases, count = _grid(n_seeds=1), 300  # slots over the pow2 bucket
    res = _fleet(chunk=4).run(cases, count)
    assert res.timeline is not None
    snap = res.timeline.snapshot()
    G = len(cases)
    window, S = snap["window"], snap["capacity"]
    T_b = window * S
    assert T_b >= count and (window, S) == (8, 64)
    assert snap["series"]["pick_n"].shape == (G, S)
    np.testing.assert_array_equal(snap["series"]["served"].sum(axis=1), np.full(G, count))
    w = (np.arange(T_b) < count).astype(np.float32)
    cnt = w.reshape(S, window).sum(axis=1)
    ns = np.zeros((G, T_b), np.float32)
    ns[:, :count] = res.out["n"].numpy()
    num = (ns * w).reshape(G, S, window).sum(axis=2)
    expect = np.where(cnt > 0, num / np.maximum(cnt, 1.0), 0.0)
    np.testing.assert_allclose(snap["series"]["pick_n"], expect, rtol=1e-5)
    tot = np.ones((G, T_b), np.float32)
    tot[:, :count] = res.out["total"].numpy()
    idx = obs.delay_bucket(torch.from_numpy(tot)).numpy()
    win_idx = np.arange(T_b) // window
    for g in range(G):
        h = np.zeros((S, obs.DELAY_BINS), np.int64)
        np.add.at(h, (win_idx, idx[g]), w.astype(np.int64))
        np.testing.assert_array_equal(snap["hists"]["delay"][g], h)


def test_fleet_streamed_timeline_bit_exact(obs_on):
    cases, count = _grid(n_seeds=1), 256
    mat = _fleet(chunk=2).run(cases, count)
    st = _fleet(chunk=2).run(cases, count, stream=True)
    a, b = mat.timeline.snapshot(), st.timeline.snapshot()
    assert set(a["series"]) == set(b["series"])
    for name in a["series"]:
        np.testing.assert_array_equal(a["series"][name], b["series"][name])
    np.testing.assert_array_equal(a["hists"]["delay"], b["hists"]["delay"])


def test_taskq_timeline_backlog_series(obs_on):
    cases, count = _grid(n_seeds=1), 200
    res = _taskq(chunk=4).run(cases, count, _pools())
    snap = res.timeline.snapshot()
    G = len(cases)
    assert "backlog" in snap["series"]
    np.testing.assert_array_equal(snap["series"]["served"].sum(axis=1), np.full(G, count))
    assert (snap["series"]["backlog"] >= 0).all()
    assert snap["hists"]["delay"].sum() == G * count


# ---------------------------------------------------------------------------
# Serve timeline + SLO/convergence monitor
# ---------------------------------------------------------------------------


def test_serve_timeline_and_slo_report():
    obs.set_enabled(True)
    obs.reset_trace()
    try:
        toks, server = _serve_tokens(rounds=3)
        assert server.traces == 1  # the collecting server still counts one bucket
        snap = server.timeline.snapshot()
        assert snap["window"] == 1 and snap["slots"] == 3
        np.testing.assert_array_equal(snap["series"]["served"], [3, 3, 3])
        np.testing.assert_array_equal(snap["hists"]["delay"].sum(axis=1), [3, 3, 3])
        assert (snap["series"]["pick_n"] >= snap["series"]["pick_k"]).all()
        spec = obs.SLOSpec(target_s=60.0, percentile=0.99, window=2)
        report = obs.slo_report(snap, spec, label="t")
        conv = report["convergence"]
        assert conv["settled"] and 0 <= conv["settle_slot"] < 3
        assert conv["dwell_final"] > 0
        assert report["max_burn_rate"] == 0.0
        assert report["percentile_last_s"] > 0
        kinds = [e["kind"] for e in report["events"].events]
        assert "controller_converged" in kinds and "slo_breach" not in kinds
    finally:
        obs.set_enabled(None)
        obs.reset_trace()


def test_serve_timeline_absent_when_disabled(obs_off):
    _, server = _serve_tokens(rounds=1)
    assert server.timeline is None and server.flight is None


def test_slo_burn_rate_and_breach_events(obs_on, tmp_path):
    S = 8
    hist = np.zeros((S, obs.DELAY_BINS), int)
    hist[:4, 0] = 100
    hist[4:, obs.DELAY_BINS - 1] = 100
    snap = {"window": 1, "capacity": S, "slots": S, "pos": S,
            "series": {"pick_n": np.full(S, 8.0), "pick_k": np.full(S, 4.0)},
            "hists": {"delay": hist}}
    spec = obs.SLOSpec(target_s=1.0, percentile=0.99, window=2)
    events = obs.EventLog("synthetic")
    report = obs.slo_report(snap, spec, label="synthetic", events=events)
    burn = np.asarray(report["burn_rate"])
    assert (burn[:4] == 0).all() and (burn[4:] >= 1.0).all()
    assert report["breach_slots"] == 4
    kinds = [e["kind"] for e in events.events]
    assert kinds.count("slo_breach") == 1
    conv = report["convergence"]
    assert conv == {"settle_slot": 0, "settled": True, "final_code": [8, 4],
                    "dwell": {"8/4": 1.0}, "dwell_final": 1.0}
    path = events.write(str(tmp_path / "events.ndjson"))
    lines = [json.loads(ln) for ln in open(path)]
    assert all(ev["schema"] == "repro.obs/event/v1" for ev in lines)
    assert {ev["kind"] for ev in lines} == {"slo_breach", "controller_converged"}
    marks = [e for e in obs.get_tracer().events() if e.get("ph") == "i"]
    assert any(e["name"] == "obs.slo_breach" for e in marks)


def test_slo_recovery_edge():
    hist = np.zeros((6, obs.DELAY_BINS), int)
    hist[1, obs.DELAY_BINS - 1] = 100
    hist[2:, 0] = 100
    snap = {"window": 1, "capacity": 6, "slots": 6, "pos": 6,
            "series": {"pick_n": np.full(6, 4.0), "pick_k": np.full(6, 2.0)},
            "hists": {"delay": hist}}
    report = obs.slo_report(snap, obs.SLOSpec(target_s=1.0, window=1), label="edge")
    kinds = [e["kind"] for e in report["events"].events]
    assert kinds.count("slo_breach") == 1 and kinds.count("slo_recovered") == 1


# ---------------------------------------------------------------------------
# Prometheus exposition hygiene
# ---------------------------------------------------------------------------


def test_prometheus_help_type_and_label_escaping():
    buf = obs.MetricsBuf.zeros(counters=("reqs",), hists={"q": 2}, highs=("hi",), device=CPU)
    buf = buf.count("reqs", 1).observe("q", torch.tensor([0])).high("hi", 1.0)
    text = buf.to_prometheus(prefix="t", labels={"run": 'a"b\\c\nd'})
    assert "# HELP t_reqs_total Running count of 'reqs'." in text
    assert "# TYPE t_reqs_total counter" in text
    assert "# TYPE t_q histogram" in text
    assert "# TYPE t_hi gauge" in text
    esc = 'run="a\\"b\\\\c\\nd"'
    assert "t_reqs_total{" + esc + "} 1" in text
    assert "t_q_bucket{" + esc + ',le="0"} 1' in text
    assert "t_q_count{" + esc + "} 1" in text
    bare = buf.to_prometheus(prefix="t")
    assert "t_reqs_total 1" in bare and "# TYPE t_q histogram" in bare


# ---------------------------------------------------------------------------
# Trace hygiene: unclosed spans, instant marks
# ---------------------------------------------------------------------------


def test_unclosed_spans_autoclose_and_warn_once(obs_on, tmp_path):
    import warnings

    sp1 = obs.span("dangling.outer", tag=1)
    sp1.__enter__()
    sp2 = obs.span("dangling.inner")
    sp2.__enter__()
    with pytest.warns(RuntimeWarning, match="dangling"):
        path = obs.write_trace(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    bad = {e["name"]: e for e in doc["traceEvents"] if e["args"].get("incomplete")}
    assert set(bad) == {"dangling.outer", "dangling.inner"}
    assert bad["dangling.outer"]["args"]["tag"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sp2.__exit__(None, None, None)
        sp1.__exit__(None, None, None)
        sp3 = obs.span("dangling.late")
        sp3.__enter__()
        path2 = obs.write_trace(str(tmp_path / "t2.json"))
    doc2 = json.load(open(path2))
    names = [e["name"] for e in doc2["traceEvents"]]
    assert names.count("dangling.outer") == 1
    assert "dangling.late" in names


def test_instant_marks_export_and_skip_aggregate(obs_on, tmp_path):
    obs.instant("mark.one", detail="x")
    with obs.span("real"):
        pass
    doc = json.load(open(obs.write_trace(str(tmp_path / "t.json"))))
    marks = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert len(marks) == 1 and marks[0]["args"]["detail"] == "x"
    agg = obs.aggregate()
    assert "real" in agg and "mark.one" not in agg


# ---------------------------------------------------------------------------
# Launch profiler
# ---------------------------------------------------------------------------


def test_profile_launch_records_and_registers(obs_on):
    obs.reset_profiles()
    try:
        a = torch.ones((64, 64), dtype=torch.float32)
        rec = obs.profile_launch("mm", lambda x, y: x @ y, a, a, warmup=1, iters=2)
        assert rec["flops"] > 0 and rec["wall_s"] > 0
        assert rec["bound"] in ("compute", "memory")
        assert rec["gflops"] > 0 and rec["intensity"] > 0
        snap = obs.profile_snapshot()
        assert snap["mm"]["traces"] == 1
        assert snap["mm"]["launches"] == 3  # warmup + iters
        assert obs.compile_snapshot()["profile.mm"]["launches"] == 3
        table = obs.format_profile()
        assert "mm" in table and "bound" in table
        obs.profile_launch("mm", lambda x, y: x @ y, a, a, warmup=0, iters=1)
        assert obs.profile_snapshot()["mm"]["launches"] == 4
        assert obs.profile_snapshot()["mm"]["traces"] == 2  # one per call
    finally:
        obs.reset_profiles()


def test_profile_counts_equal_reference_and_kernel_reports():
    """A 64×64 float32 matmul counts the reference's FLOPs and bytes
    (XLA's cost analysis: 524,288 and 49,152); an opaque launch adds the
    analytic counts its wrapper reports."""
    from repro_torch.kernels.gf2mm.gf2mm import k1_counts
    from repro_torch.obs import profile

    ref_obs.reset_profiles()
    obs.reset_profiles()
    try:
        a = np.ones((64, 64), np.float32)
        want = ref_obs.profile_launch("mm", jax.jit(lambda x, y: x @ y), jnp.asarray(a),
                                      jnp.asarray(a), warmup=0, iters=1)
        t = torch.from_numpy(a)
        got = obs.profile_launch("mm", lambda x, y: x @ y, t, t, warmup=0, iters=1)
        assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"]) == (524288,
                                                                                  49152)
        assert got["intensity"] == want["intensity"]

        def opaque():
            profile.add_counts(*k1_counts(32, 64, 48, 1024))

        rec = obs.profile_launch("opaque", opaque, warmup=0, iters=1)
        assert (rec["flops"], rec["bytes"]) == k1_counts(32, 64, 48, 1024)
        profile.add_counts(1.0, 1.0)  # outside a count: no record moves
        assert obs.profile_snapshot()["opaque"]["flops"] == rec["flops"]
    finally:
        ref_obs.reset_profiles()
        obs.reset_profiles()


# ---------------------------------------------------------------------------
# Dashboard rendering
# ---------------------------------------------------------------------------


def _ring_snap(rounds=6, ring=obs, device=CPU):
    kw = {"device": device} if ring is obs else {}
    buf = ring.TimelineBuf.zeros(8, series=("lam", "pick_n", "pick_k", "served"),
                                 hists={"delay": ring.DELAY_BINS}, **kw)
    arr = torch.tensor if ring is obs else jnp.array
    for i in range(rounds):
        buf = buf.append({"lam": 1.0 + i, "pick_n": 8.0, "pick_k": 4.0, "served": 3.0},
                         {"delay": (arr([5, 20, 40]), arr([1, 1, 1]))})
    return buf.snapshot()


def test_ascii_dashboard_renders(obs_on):
    snap = _ring_snap()
    report = obs.slo_report(snap, obs.SLOSpec(target_s=10.0, window=2))
    text = obs.ascii_dashboard({"serve": snap}, slo=report)
    assert "timeline: serve" in text and "lam" in text
    assert "delay_p99_s" in text and "slo" in text


def test_sparkline_shapes():
    assert len(obs.sparkline([1.0, 2.0, 3.0])) == 3
    assert len(obs.sparkline(np.arange(200.0))) == 48
    assert obs.sparkline([np.nan, 1.0])[0] == " "


def test_html_report_self_contained(obs_on, tmp_path):
    snap = _ring_snap()
    report = obs.slo_report(snap, obs.SLOSpec(target_s=10.0, window=2))
    path = obs.html_report(str(tmp_path / "dash.html"), {"serve": snap}, slo=report,
                           meta={"run": "test"})
    html = open(path).read()
    assert "<svg" in html and "serve" in html
    assert "prefers-color-scheme: dark" in html
    assert "<script" in html
    assert "https://" not in html and "http://" not in html


def test_reports_and_dashboards_equal_reference_text(tmp_path):
    """The same ring (built by each package's TimelineBuf) renders to the
    same SLO report, ASCII dashboard, HTML report and Prometheus text."""
    snap, ref_snap = _ring_snap(), _ring_snap(ring=ref_obs)
    for name in ref_snap["series"]:
        np.testing.assert_array_equal(snap["series"][name], ref_snap["series"][name])
    np.testing.assert_array_equal(snap["hists"]["delay"], ref_snap["hists"]["delay"])
    spec = obs.SLOSpec(target_s=0.5, percentile=0.9, window=2)
    ref_spec = ref_obs.SLOSpec(target_s=0.5, percentile=0.9, window=2)
    report = obs.slo_report(snap, spec, label="r")
    ref_report = ref_obs.slo_report(ref_snap, ref_spec, label="r")

    def plain(rep):
        evs = [{k: v for k, v in e.items() if k != "ts"} for e in rep["events"].events]
        return {**{k: v for k, v in rep.items() if k != "events"}, "events": evs}

    assert json.dumps(plain(report), sort_keys=True) == \
        json.dumps(plain(ref_report), sort_keys=True)
    prof = {"k": {"label": "k", "flops": 2e9, "bytes": 3e8, "wall_s": 1e-3, "gflops": 2e3,
                  "gbps": 300.0, "intensity": 6.7, "bound": "memory", "frac_peak": 0.09,
                  "launches": 4}}
    assert obs.ascii_dashboard({"serve": snap}, slo=report, profile=prof) == \
        ref_obs.ascii_dashboard({"serve": ref_snap}, slo=ref_report, profile=prof)
    a = obs.html_report(str(tmp_path / "a.html"), {"serve": snap}, slo=report, profile=prof,
                        meta={"run": "x"})
    b = ref_obs.html_report(str(tmp_path / "b.html"), {"serve": ref_snap}, slo=ref_report,
                            profile=prof, meta={"run": "x"})
    assert open(a).read() == open(b).read()
    buf = obs.MetricsBuf.zeros(counters=("c",), hists={"h": 5}, highs=("hi",), device=CPU)
    buf = buf.count("c", 7).observe("h", torch.tensor([1, 3, 3, 9])).high("hi", 2.5)
    ref_buf = ref_obs.MetricsBuf.zeros(counters=("c",), hists={"h": 5}, highs=("hi",))
    ref_buf = ref_buf.count("c", 7).observe("h", jnp.array([1, 3, 3, 9])).high("hi", 2.5)
    assert buf.to_prometheus(labels={"e": "x"}) == ref_buf.to_prometheus(labels={"e": "x"})
