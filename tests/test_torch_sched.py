"""The port's joint shared-pool scheduler (``repro_torch.sched``) on the
CPU, mirroring ``tests/test_sched.py``, plus the port held against the
reference's ``repro.sched``.

Tolerances:

* A one-class mix equals the port's fluid scan bit for bit, under every
  discipline (both take Δ̃·J and Ψ̃·J rounded once from float64, and every
  other term reduces exactly for one class).
* Core against core: ``multiclass_scan_core`` against the reference's on
  the same draws, given the usage constants the reference computes (the
  float32 products Δ̃·J and Ψ̃·J): picks equal, delays within rtol 1e-4 /
  atol 1e-6 — the fluid-scan mirror's tolerance; the Exp-draw sum of the
  service delay may take another order than XLA's.
* Sweep against sweep: the port's sweep rounds Δ̃·J once from float64, the
  reference's takes the float32 product; a one-ulp difference in a usage
  can flip a pick where q̄ meets a threshold, and the run then drifts for a
  while. So picks agree on ≥ 0.999 of arrivals (the fleet mirror's bar) and
  per-class statistics agree within rtol 1e-3: one flipped request moves a
  class mean over ~1,000 requests by less than that.
* Against the event oracle, the reference test's own bands.
"""

import json
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
import repro.sched as ref_sched
from repro.core import PAPER_READ_3MB as REF_READ_3MB
from repro.core import PAPER_WRITE_3MB as REF_WRITE_3MB
from repro.core import RequestClass as RefRequestClass
from repro.sched.scan import multiclass_scan_core as ref_multiclass_scan_core
from repro_torch import obs
from repro_torch.core import (
    PAPER_READ_3MB,
    PAPER_WRITE_3MB,
    RequestClass,
    TOFECPolicy,
    build_class_plan,
)
from repro_torch.core.simulator import simulate_shared_pool
from repro_torch.core.traces import TraceSampler
from repro_torch.fleet import (
    FleetSweep,
    PoissonWorkload,
    PolicySpec,
    TenantMix,
    frontier_points,
    grid_cases,
    tenant_cases,
)
from repro_torch.sched import (
    DisciplineSpec,
    SchedCase,
    SchedSweep,
    by_discipline,
    interference_summary,
    jain_index,
    multiclass_points,
    multiclass_scan_core,
    sched_cases,
    write_multiclass_artifact,
)
from repro_torch.sched.scan import CLASS_FIELDS

R3 = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
R1 = RequestClass("read1mb", 1.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
W1 = RequestClass("write1mb", 1.0, PAPER_WRITE_3MB, k_max=3, r_max=2.0, n_max=6)
REF = {
    "read3mb": RefRequestClass("read3mb", 3.0, REF_READ_3MB, k_max=6, r_max=2.0, n_max=12),
    "read1mb": RefRequestClass("read1mb", 1.0, REF_READ_3MB, k_max=4, r_max=2.0, n_max=8),
    "write1mb": RefRequestClass("write1mb", 1.0, REF_WRITE_3MB, k_max=3, r_max=2.0, n_max=6),
}
L = 16
CPU = "cpu"


def _sweep(**kw) -> SchedSweep:
    return SchedSweep(device=CPU, **kw)


def _mix2(lam: float, w0: float = 0.6) -> TenantMix:
    return TenantMix(lam, (R3, R1), (w0, 1.0 - w0))


def _ref_case(case: SchedCase) -> "ref_sched.SchedCase":
    d = case.discipline
    mix = ref_fleet.TenantMix(case.mix.lam, tuple(REF[c.name] for c in case.mix.classes),
                              case.mix.weights)
    return ref_sched.SchedCase(mix=mix, discipline=ref_sched.DisciplineSpec(d.kind, d.prio,
                                                                            d.weights),
                               seed=case.seed, L=case.L)


# ---------------------------------------------------------------------------
# Degenerate equivalence: C = 1 is the fluid scan, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "disc",
    [DisciplineSpec.fifo(), DisciplineSpec.priority(0), DisciplineSpec.wfq(1.0)],
)
def test_single_class_mix_reproduces_fluid_scan(disc):
    """Every discipline degenerates to the single-class scan on the same
    draws: the FIFO drain is exactly max(w−dt, 0) for C = 1, priorities
    and weights have nothing to arbitrate."""
    lam, seed, count = 18.0, 5, 1200
    mix = TenantMix(lam=lam, classes=(R3,), weights=(1.0,))
    res = _sweep(chunk=4).run([SchedCase(mix=mix, discipline=disc, seed=seed, L=L)], count)
    fleet = FleetSweep(chunk=4, device=CPU).run(
        grid_cases([lam], [PolicySpec.tofec()], [seed], R3, L), count)
    out, want = res.to_numpy(), fleet.to_numpy()
    for name in ("total", "queueing", "service", "n", "k"):
        np.testing.assert_array_equal(out[name][0], want[name][0], err_msg=name)
    assert not out["cls_ids"].any()


def test_single_class_mix_device_arrays_draw_for_draw():
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    inter_a, exps_a = PoissonWorkload(12.0).device_arrays(rng_a, 500, R3.n_max)
    mix = TenantMix(12.0, (R3,), (1.0,))
    inter_b, exps_b, ids = mix.multiclass_device_arrays(rng_b, 500, R3.n_max)
    np.testing.assert_array_equal(inter_a, inter_b)
    np.testing.assert_array_equal(exps_a, exps_b)
    assert ids.dtype == np.int32 and not ids.any()


# ---------------------------------------------------------------------------
# Port against reference
# ---------------------------------------------------------------------------

CORE_CASES = [
    (_mix2(20.0), DisciplineSpec.fifo()),
    (_mix2(28.0), DisciplineSpec.priority(0, 1)),
    (TenantMix(30.0, (R3, R1), (0.5, 0.5)), DisciplineSpec.wfq(2.0, 1.0)),
    (TenantMix(35.0, (R3, R1, W1), (0.4, 0.3, 0.3)), DisciplineSpec.fifo()),
    (TenantMix(55.0, (R3, R1), (0.5, 0.5)), DisciplineSpec.priority(1, 0)),
]


@pytest.mark.parametrize("mix,disc", CORE_CASES)
def test_scan_core_equals_reference_core(mix, disc):
    """The port's multiclass_scan_core against the reference's on one row's
    config and draws, with the reference's own float32 usage products."""
    count = 1500
    case = SchedCase(mix=mix, discipline=disc, seed=3, L=L)
    C = len(mix.classes)
    n_max = max(c.n_max for c in mix.classes)
    cfg = _sweep()._stack_cfg([case], C, max(c.k_max for c in mix.classes) + 1, n_max + 1)
    cfg["delta_tilde_J"] = cfg["delta_tilde"] * cfg["J"]  # float32 products
    cfg["psi_tilde_J"] = cfg["psi_tilde"] * cfg["J"]
    inter, exps, ids = mix.multiclass_device_arrays(np.random.default_rng(3), count, n_max)
    t = {k: torch.from_numpy(v) for k, v in cfg.items()}
    p = types.SimpleNamespace(L=t["L"], **{f: t[f] for f in CLASS_FIELDS})
    got = multiclass_scan_core(p, t["h_k"], t["h_n"], t["disc"], t["prio"], t["wfq_w"],
                               torch.from_numpy(inter)[None], torch.from_numpy(ids)[None],
                               torch.from_numpy(exps)[None], n_max=n_max)
    ref_p = types.SimpleNamespace(L=jnp.asarray(cfg["L"][0]), **{
        f: jnp.asarray(cfg[f][0]) for f in ("delta_bar", "delta_tilde", "psi_bar", "psi_tilde",
                                            "J", "alpha", "r_max")})
    want = ref_multiclass_scan_core(
        ref_p, *(jnp.asarray(cfg[f][0]) for f in ("h_k", "h_n", "disc", "prio", "wfq_w")),
        jnp.asarray(inter), jnp.asarray(ids), jnp.asarray(exps), n_max=n_max)
    for name in ("n", "k"):
        np.testing.assert_array_equal(got[name][0].numpy(), np.asarray(want[name]))
    for name in ("total", "queueing", "service"):
        np.testing.assert_allclose(got[name][0].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_port_sweep_matches_reference_sweep():
    """A mixed-discipline grid with a 3-class mix through both sweeps: the
    same bucket key, bucket uses (the reference's compiles), launches,
    stacked config and class ids, and outputs and per-class statistics
    within the tolerances of the module docstring."""
    cases = [SchedCase(mix=m, discipline=d, seed=3, L=L) for m, d in CORE_CASES]
    count = 1500
    mine, ref = _sweep(chunk=4), ref_sched.SchedSweep(chunk=4)
    res = mine.run(cases, count)
    ref_res = ref.run([_ref_case(c) for c in cases], count)
    assert mine.bucket_key(5, count, 3, 12, 7, 13) == ref.bucket_key(5, count, 3, 12, 7, 13)
    assert (res.compiles, res.launches) == (ref_res.compiles, ref_res.launches) == (1, 2)
    for name in ref_res.cfg:
        np.testing.assert_array_equal(res.cfg[name], ref_res.cfg[name], err_msg=name)
    got, want = res.to_numpy(), ref_res.to_numpy()
    np.testing.assert_array_equal(got["cls_ids"], want["cls_ids"])
    for name in ("n", "k"):
        assert (got[name] == want[name][:, :count]).mean() >= 0.999, name
    for p, q in zip(multiclass_points(res), ref_sched.multiclass_points(ref_res)):
        assert (p.discipline, p.lam, p.mix_name) == (q.discipline, q.lam, q.mix_name)
        for c, d in zip(p.classes, q.classes):
            assert c["count"] == d["count"]
            np.testing.assert_allclose(
                [c[f] for f in ("mean", "p50", "p99", "mean_queueing", "mean_k")],
                [d[f] for f in ("mean", "p50", "p99", "mean_queueing", "mean_k")],
                rtol=1e-3, err_msg=f"{p.discipline} {c['name']}")


def test_streamed_run_equals_materialized_bit_for_bit():
    cases = sched_cases([_mix2(20.0), _mix2(45.0)],
                        [DisciplineSpec.fifo(), DisciplineSpec.wfq(1.0, 2.0)], [0], L=L)
    mat = _sweep(chunk=2).run(cases, 600)
    strm = _sweep(chunk=2).run(cases, 600, stream=True)
    assert strm.out == {} and strm.launches == mat.launches == 2
    assert [p.to_dict() for p in multiclass_points(strm)] == \
        [p.to_dict() for p in multiclass_points(mat)]
    with pytest.raises(ValueError, match="warmup_frac"):
        multiclass_points(strm, warmup_frac=0.2)


# ---------------------------------------------------------------------------
# Cross-validation against the event-sim shared-pool oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mix,disc,tol",
    [
        (_mix2(20.0), DisciplineSpec.fifo(), 0.20),
        (_mix2(28.0), DisciplineSpec.priority(0, 1), 0.30),
        (TenantMix(30.0, (R3, R1), (0.5, 0.5)), DisciplineSpec.wfq(2.0, 1.0), 0.35),
        (TenantMix(35.0, (R3, R1, W1), (0.4, 0.3, 0.3)), DisciplineSpec.fifo(), 0.25),
        (TenantMix(55.0, (R3, R1), (0.5, 0.5)), DisciplineSpec.priority(1, 0), 0.40),
    ],
)
def test_joint_scan_cross_validates_against_shared_pool_oracle(mix, disc, tol):
    """Joint grid points (mixed disciplines, mixed class sizes): the scan's
    aggregate mean delay lands in the event oracle's band, and both agree
    on the per-class delay ordering."""
    count = 3000
    res = _sweep().run([SchedCase(mix=mix, discipline=disc, seed=3, L=L)], count)
    pt = multiclass_points(res)[0]

    rng = np.random.default_rng(7)
    arr = np.cumsum(mix.interarrivals(rng, count).astype(np.float64))
    ids = mix.cls_ids(rng, count)
    pols = [TOFECPolicy([build_class_plan(c, L)]) for c in mix.classes]
    samp = [TraceSampler(c.params, c.file_mb) for c in mix.classes]
    kw = {}
    if disc.kind == "priority":
        kw["prio"] = disc.prio
    if disc.kind == "wfq":
        kw["weights"] = disc.weights
    ev = simulate_shared_pool(pols, arr, ids, samp, L=L, discipline=disc.kind, seed=8, **kw)
    ev_mean = float(ev.totals().mean())
    assert abs(pt.agg_mean - ev_mean) / ev_mean < tol, (pt.agg_mean, ev_mean)

    ev_cls = [np.mean([s.total for s in ev.stats if s.cls_id == c])
              for c in range(len(mix.classes))]
    scan_cls = [c["mean"] for c in pt.classes]
    for e, s in zip(ev_cls, scan_cls):
        assert abs(s - e) / e < 0.5, (scan_cls, ev_cls)
    if max(ev_cls) > 1.5 * min(ev_cls):
        assert int(np.argmax(scan_cls)) == int(np.argmax(ev_cls))
        assert int(np.argmin(scan_cls)) == int(np.argmin(ev_cls))


def test_shared_pool_oracle_validates_inputs():
    pols = [TOFECPolicy([build_class_plan(R3, L)])]
    arr, ids = np.arange(4.0), np.zeros(4, np.int64)
    samp = [TraceSampler(R3.params, R3.file_mb)]
    with pytest.raises(ValueError):
        simulate_shared_pool(pols, arr, ids, samp, discipline="lifo")
    with pytest.raises(ValueError):
        simulate_shared_pool(pols, arr, ids, samp, discipline="priority", prio=(1,))
    with pytest.raises(ValueError):
        simulate_shared_pool(pols, arr, ids, samp, discipline="wfq", weights=(0.0,))


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------


def test_sched_bucket_uses_bounded_on_heterogeneous_discipline_grid():
    """A 35-point grid mixing all three disciplines and class counts (2 and
    3) uses ONE bucket — disciplines and class mixes are data in a shared
    (chunk, T, C, n_max, tables) bucket."""
    sweep = _sweep(chunk=16)
    disciplines = [
        DisciplineSpec.fifo(),
        DisciplineSpec.priority(0, 1),
        DisciplineSpec.priority(1, 0),
        DisciplineSpec.wfq(3.0, 1.0),
    ]
    mixes = [_mix2(lam) for lam in (10.0, 20.0, 30.0, 40.0)]
    cases = sched_cases(mixes, disciplines, [0, 1], L=L)
    # A 3-class mix in the same run pads every case to C = 3 (shared bucket).
    cases += sched_cases(
        [TenantMix(25.0, (R3, R1, W1), (0.4, 0.3, 0.3))],
        [DisciplineSpec.fifo(), DisciplineSpec.priority(2, 0, 1),
         DisciplineSpec.wfq(1.0, 1.0, 2.0)],
        [0], L=L,
    )
    assert len(cases) == 35

    res = sweep.run(cases, count=500)
    assert res.compiles == 1, res.compiles
    assert res.launches == 3  # ceil(35 / 16) chunks

    # Same bucket: 400 pads to the same 512 T-bucket, and keeping a 3-class
    # case in the subset keeps the run's class padding at C = 3.
    res2 = sweep.run(cases[:10] + cases[32:], count=400)
    assert res2.compiles == 0
    res3 = sweep.run(cases[16:], count=600)  # a new time bucket
    assert res3.compiles == 1
    assert sweep.stats.traces == 2 and sweep.stats.cases == 35 + 13 + 19


def test_sched_chunk_padding_keeps_results_exact():
    cases = sched_cases(
        [_mix2(12.0), _mix2(35.0), _mix2(55.0)],
        [DisciplineSpec.fifo(), DisciplineSpec.priority(0, 1)],
        [0], L=L,
    )
    a = _sweep(chunk=4).run(cases, count=600).to_numpy()  # 6 = 4 + 2 (pad)
    b = _sweep(chunk=8).run(cases, count=600).to_numpy()  # one launch
    for name in ("total", "queueing", "service", "n", "k", "cls_ids"):
        np.testing.assert_array_equal(a[name], b[name])


def test_sweep_refuses_what_is_not_ported():
    cases = sched_cases([_mix2(20.0)], [DisciplineSpec.fifo()], [0], L=L)
    obs.set_enabled(True)
    try:  # REPRO_OBS runs the sweep with its telemetry planes
        res = _sweep().run(cases, count=16)
        assert res.metrics.snapshot()["counters"]["sched_requests"] == 16
        assert "backlog" not in res.timeline.snapshot()["series"]
    finally:
        obs.set_enabled(None)
    with pytest.raises(ValueError, match="permute"):
        _sweep().run(sched_cases([_mix2(20.0)], [DisciplineSpec.priority(0, 0)], [0]), 16)
    with pytest.raises(ValueError, match="positives"):
        _sweep().run(sched_cases([_mix2(20.0)], [DisciplineSpec.wfq(1.0)], [0]), 16)
    with pytest.raises(ValueError, match="per-class policies"):
        _sweep().run([SchedCase(_mix2(20.0), DisciplineSpec.fifo(),
                                policy=(PolicySpec.tofec(),))], 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SchedSweep()  # the default device is the card


# ---------------------------------------------------------------------------
# Cross-class interference: what the Poisson split cannot see
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def interference_setup():
    """High aggregate load, two identical-parameter classes, 50/50 split;
    the fleet's Poisson-split prediction vs the joint shared-pool scan."""
    lo = RequestClass("read3mb-lo", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
    mix = TenantMix(60.0, (R3, lo), (0.5, 0.5))
    count = 4000
    joint = _sweep().run(
        [
            SchedCase(mix=mix, discipline=DisciplineSpec.priority(0, 1), seed=3, L=L),
            SchedCase(mix=mix, discipline=DisciplineSpec.fifo(), seed=3, L=L),
            SchedCase(mix=mix, discipline=DisciplineSpec.wfq(1.0, 1.0), seed=3, L=L),
        ],
        count,
    )
    split = FleetSweep(device=CPU).run(
        tenant_cases(mix, [PolicySpec.tofec()], [3], L, quiet=True), count
    )
    split_p99 = {p.cls_name: p.p99 for p in frontier_points(split)}
    return multiclass_points(joint), split_p99, joint


def test_priority_starves_low_class_beyond_split_prediction(interference_setup):
    """Under strict priority at high λ the low-priority p99 strictly exceeds
    the fluid split's prediction while the high-priority class's p99 stays
    near its solo value."""
    points, split_p99, _ = interference_setup
    prio = next(p for p in points if p.discipline.startswith("priority"))
    hi, lo = prio.cls("read3mb"), prio.cls("read3mb-lo")
    assert lo["p99"] > 2.0 * split_p99["read3mb-lo"], (lo["p99"], split_p99)
    assert hi["p99"] < 1.3 * split_p99["read3mb"], (hi["p99"], split_p99)
    assert lo["mean_k"] < hi["mean_k"]


def test_fifo_and_wfq_share_pain_fairly(interference_setup):
    points, split_p99, _ = interference_setup
    for name in ("fifo", "wfq(1:1)"):
        pt = next(p for p in points if p.discipline == name)
        assert pt.jain_delay > 0.95, (name, pt.jain_delay)
        for c in pt.classes:
            assert c["p99"] > split_p99[c["name"]], (name, c)
    prio = next(p for p in points if p.discipline.startswith("priority"))
    assert prio.jain_delay < 0.8, prio.jain_delay


def test_interference_summary_and_artifact(interference_setup, tmp_path):
    points, split_p99, joint = interference_setup
    summary = interference_summary(points, split_p99)
    assert summary["priority(0,1)"]["p99_vs_split"]["read3mb-lo"] > 2.0
    assert summary["priority(0,1)"]["p99_spread"] > summary["fifo"]["p99_spread"]
    assert [p.discipline for p in by_discipline(points)["fifo"]] == ["fifo"]

    path = tmp_path / "BENCH_multiclass.json"
    art = write_multiclass_artifact(str(path), joint, points=points)
    on_disk = json.loads(path.read_text())
    assert on_disk["schema"] == "repro.sched/BENCH_multiclass/v1"
    assert on_disk["grid_size"] == 3 and len(on_disk["points"]) == 3
    assert art["compiles"] == joint.compiles
    for p in on_disk["points"]:
        assert {c["name"] for c in p["classes"]} == {"read3mb", "read3mb-lo"}


# ---------------------------------------------------------------------------
# Frontier reductions
# ---------------------------------------------------------------------------


def test_multiclass_points_percentiles_and_counts():
    mix = TenantMix(25.0, (R3, R1), (0.7, 0.3))
    res = _sweep().run(sched_cases([mix], [DisciplineSpec.fifo()], [0, 1], L=L), 2000)
    for pt in multiclass_points(res):
        counts = [c["count"] for c in pt.classes]
        assert sum(counts) == pytest.approx(2000 * 0.95, rel=0.01)
        assert counts[0] > counts[1]  # 70/30 split
        for c in pt.classes:
            assert c["p50"] <= c["p90"] <= c["p95"] <= c["p99"]
            assert 1.0 <= c["mean_k"] <= c["mean_n"]
        assert 0.0 < pt.jain_delay <= 1.0


def test_jain_index_bounds():
    assert jain_index([1.0, 1.0, 1.0]) == pytest.approx(1.0)
    assert jain_index([1.0, 0.0, 0.0]) == pytest.approx(1.0 / 3.0)
    assert jain_index([]) == 1.0
    assert jain_index([2.0, 2.0]) == ref_sched.jain_index([2.0, 2.0])


def test_tenant_cases_warns_and_quiet_flag():
    mix = _mix2(20.0)
    with pytest.warns(UserWarning, match="repro_torch.sched"):
        tenant_cases(mix, [PolicySpec.tofec()], [0], L)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cases = tenant_cases(mix, [PolicySpec.tofec()], [0], L, quiet=True)
    assert len(cases) == 2
