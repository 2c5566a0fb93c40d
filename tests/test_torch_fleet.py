"""The port's fleet package (``repro_torch.fleet``) on the CPU, mirroring
``tests/test_fleet.py``, plus the port held against the reference's
``repro.fleet``: workload streams draw for draw, the sweep engine's bucket
key, bucket uses and launches, its outputs, the shared reductions, and the
streamed run bit for bit against the materialized one.

Tolerances: host numpy streams, integer reductions and the copied host
code are exact. Scan outputs against the reference use the reference
regression test's bounds (picks equal on ≥ 0.999 of arrivals, delays
within rtol 1e-4 / atol 1e-6); frontier statistics computed from them,
rtol 1e-4. The event-oracle cross-checks keep the reference test's own
tolerances (the §IV-A approximation band).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
from repro.core import PAPER_READ_3MB as REF_READ_3MB
from repro.core import RequestClass as RefRequestClass
from repro.core import TofecTables as RefTofecTables
from repro.core import build_class_plan as ref_build_class_plan
from repro.core.jax_sim import JaxSimParams, simulate_tofec_scan as ref_scan
from repro.core.simulator import piecewise_poisson_arrivals as ref_piecewise
from repro.fleet import stats as ref_stats
from repro_torch import obs
from repro_torch.core import (
    PAPER_READ_3MB,
    PAPER_WRITE_3MB,
    FixedKAdaptivePolicy,
    RequestClass,
    StaticPolicy,
    TofecTables,
    TOFECPolicy,
    build_class_plan,
    tofec_threshold_step,
)
from repro_torch.core import queueing
from repro_torch.core.fluid_scan import FluidScanParams, simulate_tofec_scan
from repro_torch.core.simulator import piecewise_poisson_arrivals, poisson_arrivals, simulate
from repro_torch.core.traces import TraceSampler
from repro_torch.fleet import (
    DiurnalWorkload,
    FlashCrowdWorkload,
    FleetSweep,
    MMPPWorkload,
    PiecewiseWorkload,
    PoissonWorkload,
    PolicySpec,
    StreamSpec,
    TenantMix,
    capacity_estimates,
    convergence_stats,
    fixedk_tables,
    frontier_points,
    grid_cases,
    headline_ratios,
    static_tables,
    tenant_cases,
    write_fleet_artifact,
)
from repro_torch.fleet import stats

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
PLAN = build_class_plan(CLS, L)
SAMPLER = TraceSampler(PAPER_READ_3MB, CLS.file_mb)
CPU = "cpu"


def _sweep(**kw) -> FleetSweep:
    return FleetSweep(device=CPU, **kw)


def _ref_policy(spec: PolicySpec) -> ref_fleet.PolicySpec:
    return ref_fleet.PolicySpec(spec.kind, spec.n, spec.k, spec.alpha, spec.eq7_factor)


def _close_runs(got: dict, want: dict):
    for name in ("n", "k"):
        assert (got[name] == want[name]).mean() >= 0.999, name
    for name in ("total", "queueing", "service"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Workload generators
# ---------------------------------------------------------------------------

WORKLOADS = [
    (PoissonWorkload(20.0), ref_fleet.PoissonWorkload(20.0)),
    (MMPPWorkload(rates=(8.0, 40.0), dwell=(6.0, 2.0)),
     ref_fleet.MMPPWorkload(rates=(8.0, 40.0), dwell=(6.0, 2.0))),
    (DiurnalWorkload(base=20.0, amplitude=0.6, period=60.0),
     ref_fleet.DiurnalWorkload(base=20.0, amplitude=0.6, period=60.0)),
    (PiecewiseWorkload(((30.0, 10.0), (30.0, 40.0))),
     ref_fleet.PiecewiseWorkload(((30.0, 10.0), (30.0, 40.0)))),
    (FlashCrowdWorkload(base=10.0, peak=80.0, t_on=50.0, t_off=100.0),
     ref_fleet.FlashCrowdWorkload(base=10.0, peak=80.0, t_on=50.0, t_off=100.0)),
]


@pytest.mark.parametrize("wl,ref_wl", WORKLOADS, ids=lambda w: type(w).__name__)
def test_workload_streams_equal_reference_draw_for_draw(wl, ref_wl):
    count = 4000
    inter, exps = wl.device_arrays(np.random.default_rng(0), count, CLS.n_max)
    r_inter, r_exps = ref_wl.device_arrays(np.random.default_rng(0), count, CLS.n_max)
    np.testing.assert_array_equal(inter, r_inter)
    np.testing.assert_array_equal(exps, r_exps)
    np.testing.assert_array_equal(wl.arrival_times(np.random.default_rng(1), 120.0),
                                  ref_wl.arrival_times(np.random.default_rng(1), 120.0))
    assert inter.shape == (count,) and inter.dtype == np.float32
    assert exps.shape == (count, CLS.n_max) and exps.dtype == np.float32
    assert np.all(inter >= 0.0)


@pytest.mark.parametrize("wl", [w for w, _ in WORKLOADS[:4]], ids=lambda w: type(w).__name__)
def test_workload_mean_rate(wl):
    inter, _ = wl.device_arrays(np.random.default_rng(0), 4000, CLS.n_max)
    emp = 4000 / inter.sum()
    assert 0.85 * wl.mean_rate() < emp < 1.15 * wl.mean_rate(), (emp, wl)
    times = wl.arrival_times(np.random.default_rng(1), 120.0)
    assert np.all(np.diff(times) > 0.0) and times[-1] < 120.0
    assert 0.7 * wl.mean_rate() < len(times) / 120.0 < 1.3 * wl.mean_rate()


def test_mmpp_is_bursty_and_flash_crowd_steps():
    inter = MMPPWorkload(rates=(4.0, 80.0), dwell=(8.0, 2.0)).interarrivals(
        np.random.default_rng(2), 20_000)
    assert inter.std() / inter.mean() > 1.25
    wl = FlashCrowdWorkload(base=10.0, peak=80.0, t_on=50.0, t_off=100.0)
    times = wl.arrival_times(np.random.default_rng(3), 150.0)
    burst = np.sum((times >= 50.0) & (times < 100.0)) / 50.0
    calm = (np.sum(times < 50.0) + np.sum(times >= 100.0)) / 100.0
    assert burst > 4.0 * calm


def test_piecewise_wrapper_is_draw_for_draw_compatible():
    rates = [(200.0, 10.0), (200.0, 70.0), (200.0, 10.0)]
    a = piecewise_poisson_arrivals(np.random.default_rng(10), rates)
    b = PiecewiseWorkload(tuple(rates)).arrival_times(np.random.default_rng(10))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, ref_piecewise(np.random.default_rng(10), rates))
    assert a[-1] < 600.0 and np.sum((a > 200) & (a < 400)) > 10_000


def test_tenant_mix_split_and_cls_ids():
    small = RequestClass("read1mb", 1.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
    mix = TenantMix(lam=30.0, classes=(CLS, small), weights=(0.75, 0.25))
    ref_small = RefRequestClass("read1mb", 1.0, REF_READ_3MB, k_max=4, r_max=2.0, n_max=8)
    ref_mix = ref_fleet.TenantMix(lam=30.0, classes=(REF_CLS, ref_small), weights=(0.75, 0.25))
    ids = mix.cls_ids(np.random.default_rng(4), 8000)
    np.testing.assert_array_equal(ids, ref_mix.cls_ids(np.random.default_rng(4), 8000))
    assert 0.70 < (ids == 0).mean() < 0.80
    split = mix.split()
    assert [c.name for c, _ in split] == ["read3mb", "read1mb"]
    assert np.isclose(sum(w.lam for _, w in split), 30.0)
    with pytest.warns(UserWarning, match="quiet=True"):
        tenant_cases(mix, [PolicySpec.tofec()], [0], L)
    res = _sweep(chunk=8).run(tenant_cases(mix, [PolicySpec.tofec()], [0], L, quiet=True),
                              count=600)
    ks = res.out["k"]
    assert int(ks[0].max()) <= CLS.k_max and int(ks[1].max()) <= small.k_max


# ---------------------------------------------------------------------------
# Policy-as-tables encodings
# ---------------------------------------------------------------------------


def test_static_tables_pin_the_code():
    for n, k in [(1, 1), (2, 1), (6, 3), (12, 6), (5, 4)]:
        h_k, h_n, r_max = static_tables(n, k, CLS.k_max, CLS.n_max)
        for q in [0.0, 0.3, 7.0, 1e4]:
            _, n_j, k_j = tofec_threshold_step(torch.tensor(q), q, torch.tensor(h_k),
                                               torch.tensor(h_n), r_max, 0.99)
            assert (int(n_j), int(k_j)) == (n, k), (n, k, q)


def test_fixedk_tables_match_host_policy():
    k = 6
    h_k, h_n, r_max = fixedk_tables(CLS, L, k)
    pol = FixedKAdaptivePolicy(CLS, L, k=k)
    q_ewma = torch.tensor(0.0)
    for q in [0.0, 0.5, 1.0, 2.0, 4.0, 9.0, 30.0, 2.0, 0.0]:
        n_host, k_host = pol.select(q=q, idle=0)
        q_ewma, n_j, k_j = tofec_threshold_step(q_ewma, q, torch.tensor(h_k), torch.tensor(h_n),
                                                r_max, pol.alpha)
        assert (int(n_j), int(k_j)) == (n_host, k_host), q


# ---------------------------------------------------------------------------
# Sweep fidelity
# ---------------------------------------------------------------------------


def test_sweep_row_matches_single_scan():
    """A fleet grid row reproduces simulate_tofec_scan on the same draws —
    the port's scan and the reference's jitted scan both."""
    lam, seed, count = 18.0, 5, 1200
    res = _sweep(chunk=4).run(grid_cases([lam], [PolicySpec.tofec()], [seed], CLS, L), count)
    inter, exps = PoissonWorkload(lam).device_arrays(np.random.default_rng(seed), count,
                                                     CLS.n_max)
    one = simulate_tofec_scan(FluidScanParams.from_class(CLS, L),
                              TofecTables.from_plan(PLAN, device=CPU), inter, exps)
    out = res.to_numpy()
    row = {name: v[0] for name, v in out.items()}
    for name in ("n", "k", "total", "queueing", "service"):  # same ops on one device
        np.testing.assert_array_equal(row[name], one[name].numpy())
    ref = ref_scan(JaxSimParams.from_class(REF_CLS, L),
                   RefTofecTables.from_plan(ref_build_class_plan(REF_CLS, L)),
                   jnp.asarray(inter), jnp.asarray(exps))
    _close_runs(row, {name: np.asarray(v) for name, v in ref.items()})


@pytest.mark.parametrize(
    "lam,policy,host_policy,tol",
    [
        (5.0, PolicySpec.tofec(), None, 0.30),
        (5.0, PolicySpec.static(1, 1), StaticPolicy(1, 1), 0.15),
        (25.0, PolicySpec.static(6, 3), StaticPolicy(6, 3), 0.15),
        (50.0, PolicySpec.tofec(), None, 0.30),
    ],
)
def test_sweep_cross_validates_against_event_oracle(lam, policy, host_policy, tol):
    """Fleet mean total delay within the §IV-A approximation band of the
    (copied) discrete-event simulator, as in the reference test."""
    count = 3000
    res = _sweep().run(grid_cases([lam], [policy], [3], CLS, L), count)
    fleet_mean = frontier_points(res)[0].mean
    arr = poisson_arrivals(np.random.default_rng(7), lam, count)
    host = host_policy if host_policy is not None else TOFECPolicy([PLAN])
    event_mean = float(simulate(host, arr, SAMPLER, L=L, seed=8).totals().mean())
    assert abs(fleet_mean - event_mean) / event_mean < tol, (fleet_mean, event_mean)


# ---------------------------------------------------------------------------
# Shape buckets / launches
# ---------------------------------------------------------------------------


def test_sweep_bucket_uses_bounded_on_heterogeneous_grid():
    """A 64-point heterogeneous grid uses ONE bucket; re-runs and same-bucket
    grids use none anew; only a different T bucket is a new one."""
    sweep = _sweep(chunk=16)
    lams = np.linspace(4.0, 64.0, 8)
    policies = [PolicySpec.tofec(), PolicySpec.static(1, 1),
                PolicySpec.static(12, 6), PolicySpec.fixedk(6)]
    cases = grid_cases(lams, policies, [0, 1], CLS, L)
    assert len(cases) == 64
    res = sweep.run(cases, count=500)
    assert res.compiles == 1 and res.launches == 4
    res2 = sweep.run(cases[:40], count=400)  # 500 and 400 both pad to 512
    assert res2.compiles == 0
    res3 = sweep.run(cases[:8], count=600)  # a new time bucket
    assert res3.compiles == 1
    assert sweep.stats.traces == 2 and sweep.stats.cases == 64 + 40 + 8
    assert sweep.stats.by_mesh == {(): 2}


def test_sweep_chunk_padding_keeps_results_exact():
    cases = grid_cases([6.0, 30.0, 55.0], [PolicySpec.tofec()], [0, 1], CLS, L)
    a = _sweep(chunk=4).run(cases, count=700).to_numpy()  # 6 = 4 + 2 (pad)
    b = _sweep(chunk=8).run(cases, count=700).to_numpy()  # one launch
    for name in ("total", "queueing", "service", "n", "k"):
        np.testing.assert_array_equal(a[name], b[name])


def test_port_sweep_matches_reference_sweep():
    """Same small grid through both engines: the same bucket key, bucket
    uses (the reference's compiles) and launches, and outputs within the
    regression tolerances."""
    lams = [6.0, 30.0, 60.0]
    specs = [PolicySpec.tofec(), PolicySpec.static(6, 3), PolicySpec.fixedk(6)]
    count = 900
    mine = _sweep(chunk=4)
    ref = ref_fleet.FleetSweep(chunk=4)
    res = mine.run(grid_cases(lams, specs, [2], CLS, L), count)
    ref_res = ref.run(ref_fleet.grid_cases(lams, [_ref_policy(s) for s in specs], [2],
                                           REF_CLS, L), count)
    assert mine.bucket_key(9, count, 12, 7, 13) == ref.bucket_key(9, count, 12, 7, 13)
    assert (res.compiles, res.launches) == (ref_res.compiles, ref_res.launches) == (1, 3)
    for name in ref_res.cfg:
        np.testing.assert_array_equal(res.cfg[name], ref_res.cfg[name])
    got, want = res.to_numpy(), ref_res.to_numpy()
    for g in range(len(res.cases)):
        _close_runs({k: v[g] for k, v in got.items()}, {k: v[g] for k, v in want.items()})
    pts, ref_pts = frontier_points(res), ref_fleet.frontier_points(ref_res)
    for p, q in zip(pts, ref_pts):
        assert (p.policy, p.lam, p.seed) == (q.policy, q.lam, q.seed)
        np.testing.assert_allclose([p.mean, p.p50, p.p99, p.mean_k, p.mean_usage],
                                   [q.mean, q.p50, q.p99, q.mean_k, q.mean_usage], rtol=1e-4)


def test_streamed_run_equals_materialized_bit_for_bit():
    cases = grid_cases([5.0, 40.0, 70.0], [PolicySpec.tofec(), PolicySpec.static(2, 1)], [0],
                       CLS, L)
    mat = _sweep(chunk=4).run(cases, count=800)
    strm = _sweep(chunk=4).run(cases, count=800, stream=StreamSpec(warmup_frac=0.05))
    assert strm.out == {} and strm.launches == mat.launches == 2
    assert [p.to_dict() for p in frontier_points(strm)] == \
        [p.to_dict() for p in frontier_points(mat)]
    assert convergence_stats(strm) == convergence_stats(mat)
    with pytest.raises(ValueError, match="warmup_frac"):
        frontier_points(strm, warmup_frac=0.2)


def test_sweep_refuses_what_is_not_ported():
    cases = grid_cases([5.0], [PolicySpec.tofec()], [0], CLS, L)
    obs.set_enabled(True)
    try:  # REPRO_OBS runs the sweep with its telemetry planes
        res = _sweep().run(cases, count=16)
        assert res.metrics.snapshot()["counters"]["fleet_requests"] == 16
        assert res.timeline.snapshot()["capacity"] == 64
    finally:
        obs.set_enabled(None)
    if torch.cuda.device_count() < 2:  # a mesh of two cards needs two cards
        with pytest.raises(ValueError, match="devices"):
            FleetSweep(mesh=2, device=CPU)
    # Greedy is not table-expressible; the refusal names the exact task
    # engine that runs it.
    with pytest.raises(ValueError, match=r"greedy.*repro_torch\.taskq\.TaskqSweep"):
        _sweep().run(grid_cases([5.0], [PolicySpec.greedy()], [0], CLS, L), count=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FleetSweep()  # the default device is the card


# ---------------------------------------------------------------------------
# Shared reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first,n", [(0, 70), (2, 2), (60, 9), (64, 64), (130, 1)])
def test_row_blocks_place_rows_by_grid_index(first, n):
    """Grid row g is reduced at place g % ROW_BLOCK of a full block whatever
    chunk it comes in (on the card a row's place sets its alignment, and so
    the order of its float sum), and the rows come back in order."""
    rows = {"g": torch.arange(first, first + n)}

    def places(blk):
        assert blk["g"].shape[0] == stats.ROW_BLOCK
        return {"g": blk["g"], "place": torch.arange(stats.ROW_BLOCK)}

    red = stats.reduce_row_blocks(places, rows, first=first)
    assert red["g"].tolist() == list(range(first, first + n))
    assert red["place"].tolist() == [g % stats.ROW_BLOCK for g in range(first, first + n)]


def test_reductions_equal_reference_reductions():
    rng = np.random.default_rng(11)
    G, T = 70, 300  # more rows than one reduction block
    x = rng.exponential(1.0, (G, T)).astype(np.float32)
    mask = rng.random((G, T)) < 0.3
    mask[3] = False  # an empty row: NaN
    mask[4] = False
    mask[4, 17] = True  # a single survivor
    qs = [0.0, 50.0, 90.0, 99.0, 100.0]
    for m in (None, mask):
        got = stats.masked_percentiles(torch.from_numpy(x), qs,
                                       None if m is None else torch.from_numpy(m))
        want = ref_stats.masked_percentiles(jnp.asarray(x), qs,
                                            None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k = rng.integers(1, 7, (G, T)).astype(np.int32)
    n = np.minimum(k * 2, 12).astype(np.int32)
    out = {"total": x, "queueing": x * 0.5, "n": n, "k": k}
    par = [rng.uniform(0.01, 0.2, G).astype(np.float32) for _ in range(4)]
    J = np.full(G, 3.0, np.float32)
    got = stats.frontier_block_reduce({n_: torch.from_numpy(v) for n_, v in out.items()},
                                      *(torch.from_numpy(p) for p in par), torch.from_numpy(J),
                                      w=15)
    want = ref_stats.frontier_block_reduce({n_: jnp.asarray(v) for n_, v in out.items()},
                                           *(jnp.asarray(p) for p in par), jnp.asarray(J), w=15)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5)
    got = stats.convergence_reduce(torch.from_numpy(k), w=15, bins=13)
    want = ref_stats.convergence_reduce(jnp.asarray(k), w=15, bins=13)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


# ---------------------------------------------------------------------------
# Frontier reductions + artifact
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frontier_sweep():
    lams = np.linspace(5.0, 65.0, 6)
    policies = [PolicySpec.tofec(), PolicySpec.static(1, 1), PolicySpec.static(2, 1),
                PolicySpec.static(6, 3), PolicySpec.static(12, 6)]
    return _sweep().run(grid_cases(lams, policies, [1], CLS, L), count=2500)


def test_frontier_artifact_reproduces_paper_ordering(frontier_sweep, tmp_path):
    path = tmp_path / "BENCH_fleet.json"
    art = write_fleet_artifact(str(path), frontier_sweep)
    on_disk = json.loads(path.read_text())
    assert on_disk["schema"] == "repro.fleet/BENCH_fleet/v1"
    assert on_disk["grid_size"] == 30 and len(on_disk["points"]) == 30
    assert on_disk["meta"]["host_devices"] == torch.cuda.device_count()
    h = art["headline"]
    assert h["delay_gain_vs_basic"] > 1.5
    assert h["capacity_gain_vs_latency_optimal"] > 1.5
    caps = art["capacity_req_s"]
    assert caps["tofec"] > caps["static(12,6)"]
    assert caps["static(1,1)"] > caps["static(6,3)"] > caps["static(12,6)"]
    assert h == headline_ratios(frontier_points(frontier_sweep))


def test_frontier_percentiles_and_k_adaptation(frontier_sweep):
    pts = frontier_points(frontier_sweep)
    for p in pts:
        assert p.p50 <= p.p90 <= p.p95 <= p.p99
        assert 1.0 <= p.mean_k <= CLS.k_max and p.mean_k <= p.mean_n
    tofec = sorted((p for p in pts if p.policy == "tofec"), key=lambda p: p.lam)
    assert tofec[0].mean_k > tofec[-1].mean_k + 1.0


def test_convergence_stats_static_settles_instantly(frontier_sweep):
    conv = convergence_stats(frontier_sweep)
    assert len(conv) == len(frontier_sweep.cases)
    for s in conv:
        if s["policy"].startswith("static("):
            assert s["settle_frac"] == 0.0 and s["modal_frac"] == 1.0
        assert 0.0 <= s["settle_frac"] <= 1.0


def test_capacity_estimates_match_queueing_theory(frontier_sweep):
    caps = capacity_estimates(frontier_points(frontier_sweep))
    for (n, k) in [(1, 1), (2, 1), (6, 3)]:
        want = queueing.capacity(PAPER_READ_3MB, CLS.file_mb, k, n / k, L)
        assert abs(caps[f"static({n},{k})"] - want) / want < 1e-3


def test_multi_class_grid_pads_tables_and_exps():
    wr = RequestClass("write1mb", 1.0, PAPER_WRITE_3MB, k_max=3, r_max=2.0, n_max=6)
    cases = grid_cases([8.0], [PolicySpec.tofec()], [0], CLS, L) + \
        grid_cases([8.0], [PolicySpec.tofec()], [0], wr, L)
    res = _sweep(chunk=2).run(cases, count=800)
    assert res.compiles == 1
    out = res.to_numpy()
    assert out["k"][0].max() <= CLS.k_max and out["n"][0].max() <= CLS.n_max
    assert out["k"][1].max() <= wr.k_max and out["n"][1].max() <= wr.n_max


@pytest.mark.parametrize("t_floor", [512, 2048])
def test_t_floor_keys_and_runs_as_the_reference(t_floor):
    """``t_floor=`` in the fleet and sched sweeps: the same bucket keys as
    the reference's at the same floor, the same bucket uses and launches; a
    floor of 2,048 moves a 700-arrival run from the 1,024 bucket to 2,048
    in both packages."""
    import repro.sched as ref_sched
    from repro_torch.sched import DisciplineSpec, SchedSweep, sched_cases

    want_t = 2048 if t_floor == 2048 else 1024
    mine, ref = _sweep(chunk=16, t_floor=t_floor), ref_fleet.FleetSweep(chunk=16, t_floor=t_floor)
    key = mine.bucket_key(4, 700, 12, 7, 13)
    assert key == ref.bucket_key(4, 700, 12, 7, 13) and key[1] == want_t
    cases = grid_cases([6.0, 30.0], [PolicySpec.tofec(), PolicySpec.static(6, 3)], [0], CLS, L)
    ref_cases = ref_fleet.grid_cases([6.0, 30.0], [_ref_policy(PolicySpec.tofec()),
                                                   _ref_policy(PolicySpec.static(6, 3))],
                                     [0], REF_CLS, L)
    res, ref_res = mine.run(cases, 700), ref.run(ref_cases, 700)
    assert (res.compiles, res.launches) == (ref_res.compiles, ref_res.launches) == (1, 1)

    sched, ref_s = (SchedSweep(chunk=16, t_floor=t_floor, device=CPU),
                    ref_sched.SchedSweep(chunk=16, t_floor=t_floor))
    key = sched.bucket_key(2, 700, 1, 12, 7, 13)
    assert key == ref_s.bucket_key(2, 700, 1, 12, 7, 13) and key[1] == want_t
    mix = TenantMix(20.0, (CLS,), (1.0,))
    ref_mix = ref_fleet.TenantMix(20.0, (REF_CLS,), (1.0,))
    got = sched.run(sched_cases([mix], [DisciplineSpec.fifo()], [0], L=L), 700)
    want = ref_s.run(ref_sched.sched_cases([ref_mix], [ref_sched.DisciplineSpec.fifo()], [0],
                                           L=L), 700)
    assert (got.compiles, got.launches) == (want.compiles, want.launches) == (1, 1)
    assert sched.stats.by_mesh == {(): 1}
