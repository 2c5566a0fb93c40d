"""The port's exact task engine (``repro_torch.taskq``) on the CPU,
mirroring ``tests/test_taskq.py``, plus the port held against the
reference's ``repro.taskq``.

Tolerances. Against the reference engine the outputs are held element for
element (``assert_array_equal``): every operation of a step is one float32
operation in the reference's order, and ``argmin`` takes the first minimum
on both sides. Against the event oracle the reference test's own bars:
static codes within rtol 1e-3 / atol 2e-3 (the oracle accumulates in
float64), adaptive picks equal on > 0.99 of arrivals and mean delay within
rtol 1e-2.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
from repro.core import PAPER_READ_3MB as REF_READ_3MB
from repro.core import RequestClass as RefRequestClass
from repro.core.traces import TraceStore as RefTraceStore
from repro.taskq import TaskqSweep as RefTaskqSweep
from repro.taskq import greedy_select as ref_greedy_select
from repro.taskq import taskq_scan as ref_taskq_scan
from repro_torch import obs
from repro_torch.core import (
    PAPER_READ_3MB,
    GreedyPolicy,
    RequestClass,
    StaticPolicy,
    TOFECPolicy,
    build_class_plan,
)
from repro_torch.core.simulator import simulate
from repro_torch.core.traces import TraceStore
from repro_torch.fleet import PolicySpec, frontier, frontier_points, grid_cases, policy_tables
from repro_torch.taskq import (
    TaskqSweep,
    greedy_select,
    taskq_scan,
    taskq_scan_core,
    taskq_streams,
    write_taskq_artifact,
)
from repro_torch.taskq.engine import CFG_FIELDS

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
SIZES = tuple(CLS.file_mb / k for k in range(1, CLS.k_max + 1))
CPU = "cpu"


def make_pools(correlation: float, seed: int = 3, samples: int = 2048):
    store = TraceStore.generate(
        PAPER_READ_3MB, SIZES, threads=CLS.n_max, samples=samples,
        correlation=correlation, seed=seed,
    )
    return store, store.device_pools(n_max=CLS.n_max, device=CPU)


def _sweep(**kw) -> TaskqSweep:
    return TaskqSweep(device=CPU, **kw)


def run_host(case, count, dp, policy, L=L):
    """The event oracle on the same draws a TaskqSweep point consumes."""
    inter, idx = taskq_streams(case, count, dp.n_rows)
    arrivals = np.cumsum(inter.astype(np.float64))
    return simulate(
        policy, arrivals, dp.host_sampler(CLS.file_mb, idx), L=L, warmup_frac=0.0
    )


def _ref_policy(spec: PolicySpec) -> ref_fleet.PolicySpec:
    return ref_fleet.PolicySpec(spec.kind, spec.n, spec.k, spec.alpha, spec.eq7_factor)


# ---------------------------------------------------------------------------
# Shared trace pools: device and host read identical values
# ---------------------------------------------------------------------------


def test_device_pools_and_host_sampler_read_identical_values():
    store, dp = make_pools(correlation=0.14)
    assert tuple(dp.pools.shape) == (len(SIZES), 2048, CLS.n_max)
    assert dp.pools.dtype == torch.float32 and dp.sizes_mb.dtype == torch.float32
    rng = np.random.default_rng(0)
    indices = rng.integers(dp.n_rows, size=64)
    sampler = dp.host_sampler(CLS.file_mb, indices)
    for i in [0, 7, 31, 63]:
        for k, n in [(1, 2), (3, 6), (6, 12)]:
            host = sampler.sample_indexed(i, k, n)
            s = dp.pool_index(CLS.file_mb, k)
            dev = dp.pools[s, indices[i], :n].numpy()
            np.testing.assert_array_equal(host.astype(np.float32), dev)
            np.testing.assert_array_equal(dev, store.pools[s][indices[i], :n].astype(np.float32))


def test_shared_key_correlation_survives_export():
    _, dp = make_pools(correlation=0.14)
    c = np.corrcoef(dp.pools[0].numpy().T)
    off = c[~np.eye(c.shape[0], dtype=bool)]
    assert off.mean() > 0.05, off.mean()


# ---------------------------------------------------------------------------
# Greedy parity: tensor select vs host GreedyPolicy (and the reference's)
# ---------------------------------------------------------------------------


def test_greedy_select_matches_host_policy_on_randomized_states():
    rng = np.random.default_rng(42)
    k_max = rng.integers(1, 9, size=200)
    r_max = rng.choice([1.5, 2.0, 2.5, 3.0], size=200)
    idle = rng.integers(-2, 2 * L + 1, size=200)
    q = rng.integers(0, 50, size=200)
    n_d, k_d = greedy_select(torch.tensor(q, dtype=torch.float32),
                             torch.tensor(idle, dtype=torch.int32),
                             torch.tensor(k_max, dtype=torch.int32),
                             torch.tensor(r_max, dtype=torch.float32))
    for i in range(200):
        host = GreedyPolicy(int(k_max[i]), float(r_max[i])).select(q=int(q[i]), idle=int(idle[i]))
        assert (int(n_d[i]), int(k_d[i])) == host, (q[i], idle[i], k_max[i], r_max[i])
        ref = ref_greedy_select(jnp.float32(q[i]), jnp.int32(idle[i]), jnp.int32(k_max[i]),
                                jnp.float32(r_max[i]))
        assert (int(ref[0]), int(ref[1])) == host
    # The 0-d form (one row) takes the same path.
    assert tuple(int(x) for x in greedy_select(0.0, torch.tensor(3, dtype=torch.int32),
                                               6, 2.0)) == (3, 3)


# ---------------------------------------------------------------------------
# Port against reference: the engine element for element
# ---------------------------------------------------------------------------


def _ref_pools(correlation: float, seed: int = 3, samples: int = 2048):
    store = RefTraceStore.generate(
        REF_READ_3MB, SIZES, threads=CLS.n_max, samples=samples,
        correlation=correlation, seed=seed,
    )
    return store.device_pools(n_max=CLS.n_max)


@pytest.mark.parametrize("L_run,lams", [(16, (10.0, 45.0)), (8, (15.0,))])
def test_engine_equals_reference_engine_element_for_element(L_run, lams):
    """Same cfg rows, streams and pools through the port's taskq_scan_core
    (one batched grid on the CPU) and the reference's taskq_scan (one row at
    a time), flight arrays included: every output is equal."""
    _, dp = make_pools(correlation=0.14)
    ref_dp = _ref_pools(correlation=0.14)
    np.testing.assert_array_equal(dp.pools.numpy(), np.asarray(ref_dp.pools))
    count = 500
    specs = [PolicySpec.tofec(), PolicySpec.greedy(), PolicySpec.static(12, 6),
             PolicySpec.static(4, 2), PolicySpec.fixedk(6)]
    cases = grid_cases(lams, specs, [7], CLS, L_run)
    sweep = _sweep(chunk=16)
    cfg = sweep._stack_cfg(cases, CLS.k_max + 1, CLS.n_max + 1)
    streams = [taskq_streams(c, count, dp.n_rows) for c in cases]
    inter = torch.from_numpy(np.stack([s[0] for s in streams]))
    idx = torch.from_numpy(np.stack([s[1] for s in streams]))
    rows = {f: torch.from_numpy(cfg[f]) for f in CFG_FIELDS}
    out = taskq_scan_core(rows, inter, idx, dp.pools, dp.sizes_mb, L=L_run, flight=True)
    for g in range(len(cases)):
        want = ref_taskq_scan({f: cfg[f][g] for f in CFG_FIELDS}, streams[g][0], streams[g][1],
                              ref_dp.pools, ref_dp.sizes_mb, L=L_run, collect=False,
                              flight=True)
        for name in ("total", "queueing", "service", "n", "k"):
            np.testing.assert_array_equal(out[name][g].numpy(), np.asarray(want[name]),
                                          err_msg=f"row {g} ({cases[g].policy.name}) {name}")
        for name in ("arrival", "depart", "start", "tent", "thread"):
            np.testing.assert_array_equal(out["flight"][name][g].numpy(),
                                          np.asarray(want["flight"][name]),
                                          err_msg=f"row {g} flight {name}")
    # The single-row entry point is the same engine.
    one = taskq_scan({f: cfg[f][1] for f in CFG_FIELDS}, streams[1][0], streams[1][1],
                     dp.pools, dp.sizes_mb, L=L_run)
    for name in ("total", "n", "k"):
        np.testing.assert_array_equal(one[name].numpy(), out[name][1].numpy())


def test_port_sweep_matches_reference_sweep():
    """A mixed threshold + greedy grid through both sweeps: the same bucket
    key, bucket uses (the reference's compiles), launches, stacked config
    and outputs, element for element."""
    _, dp = make_pools(correlation=0.0)
    ref_dp = _ref_pools(correlation=0.0)
    specs = [PolicySpec.tofec(), PolicySpec.greedy(), PolicySpec.static(6, 3)]
    lams, count = [8.0, 30.0, 50.0], 600
    mine, ref = _sweep(chunk=4), RefTaskqSweep(chunk=4)
    res = mine.run(grid_cases(lams, specs, [2], CLS, L), count, dp)
    ref_res = ref.run(ref_fleet.grid_cases(lams, [_ref_policy(s) for s in specs], [2],
                                           REF_CLS, L), count, ref_dp)
    shape = tuple(dp.pools.shape)
    assert mine.bucket_key(9, count, L, 7, 13, shape) == ref.bucket_key(9, count, L, 7, 13,
                                                                        shape)
    assert (res.compiles, res.launches) == (ref_res.compiles, ref_res.launches) == (1, 3)
    for name in ref_res.cfg:
        np.testing.assert_array_equal(res.cfg[name], ref_res.cfg[name])
    got, want = res.to_numpy(), ref_res.to_numpy()
    for name in ("total", "queueing", "service", "n", "k"):
        np.testing.assert_array_equal(got[name], want[name][:, :count])


# ---------------------------------------------------------------------------
# Exactness: engine vs event oracle on shared pools
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,k,lam,correlation",
    [
        (1, 1, 8.0, 0.0),    # basic code, unique-key placement
        (6, 3, 30.0, 0.0),   # mid code under load, unique-key
        (12, 6, 20.0, 0.14),  # latency-optimal code, shared-key copula
        (4, 2, 45.0, 0.14),  # heavy load, shared-key
    ],
)
def test_engine_matches_event_oracle_draw_for_draw(n, k, lam, correlation):
    _, dp = make_pools(correlation)
    count = 1200
    case = grid_cases([lam], [PolicySpec.static(n, k)], [7], CLS, L)[0]
    res = _sweep(chunk=4).run([case], count, dp)
    host = run_host(case, count, dp, StaticPolicy(n, k))
    assert len(host.stats) == count
    out = res.to_numpy()
    np.testing.assert_allclose(out["total"][0], host.totals(), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(out["queueing"][0], host.queueing(), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(out["service"][0], host.service(), rtol=1e-3, atol=2e-3)
    assert (out["n"][0] == n).all() and (out["k"][0] == k).all()


def test_engine_exact_when_n_exceeds_thread_count():
    """n > L: the excess tasks queue for threads freed by their own
    siblings' completions — the pass-1 feedback makes this exact too."""
    _, dp = make_pools(correlation=0.14)
    count = 800
    case = grid_cases([15.0], [PolicySpec.static(12, 6)], [9], CLS, 8)[0]
    res = _sweep(chunk=4).run([case], count, dp)
    host = run_host(case, count, dp, StaticPolicy(12, 6), L=8)
    out = res.to_numpy()
    np.testing.assert_allclose(out["total"][0], host.totals(), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(out["queueing"][0], host.queueing(), rtol=1e-3, atol=2e-3)


def test_engine_tracks_adaptive_trajectories_of_the_oracle():
    """TOFEC on the true queue length and Greedy on the true idle-thread
    count reproduce the oracle's per-request (n, k) sequence almost
    everywhere (float boundary ties at threshold crossings excepted)."""
    _, dp = make_pools(correlation=0.0)
    count = 1200
    case = grid_cases([35.0], [PolicySpec.tofec()], [5], CLS, L)[0]
    res = _sweep(chunk=4).run([case], count, dp)
    host = run_host(case, count, dp, TOFECPolicy([build_class_plan(CLS, L)]))
    out = res.to_numpy()
    assert (out["n"][0] == host.ns()).mean() > 0.99
    assert (out["k"][0] == host.ks()).mean() > 0.99
    np.testing.assert_allclose(out["total"][0].mean(), host.totals().mean(), rtol=1e-2)
    case = grid_cases([40.0], [PolicySpec.greedy()], [11], CLS, L)[0]
    res = _sweep(chunk=4).run([case], count, dp)
    host = run_host(case, count, dp, GreedyPolicy(CLS.k_max, CLS.r_max))
    out = res.to_numpy()
    assert (out["n"][0] == host.ns()).mean() > 0.99
    assert (out["k"][0] == host.ks()).mean() > 0.99


def test_chunk_padding_keeps_results_exact():
    """Different chunkings of the same grid are bit-identical (the tail
    padding holds for the shared-pool launch path too)."""
    _, dp = make_pools(correlation=0.14)
    cases = grid_cases([10.0, 30.0, 50.0], [PolicySpec.tofec()], [0, 1], CLS, L)
    a = _sweep(chunk=4).run(cases, 600, dp).to_numpy()  # 6 = 4 + 2 (pad)
    b = _sweep(chunk=8).run(cases, 600, dp).to_numpy()  # one launch
    for name in ("total", "queueing", "service", "n", "k"):
        np.testing.assert_array_equal(a[name], b[name])


def test_streamed_run_equals_materialized_bit_for_bit():
    _, dp = make_pools(correlation=0.14)
    cases = grid_cases([10.0, 40.0], [PolicySpec.tofec(), PolicySpec.greedy()], [0], CLS, L)
    mat = _sweep(chunk=2).run(cases, 500, dp)
    strm = _sweep(chunk=2).run(cases, 500, dp, stream=True)
    assert strm.out == {} and strm.launches == mat.launches == 2
    assert [p.to_dict() for p in frontier_points(strm)] == \
        [p.to_dict() for p in frontier_points(mat)]


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------


def test_heterogeneous_policy_sweep_uses_one_bucket():
    """A 32-case grid mixing threshold policies AND greedy uses ONE bucket;
    same-bucket re-runs use none anew; a new time bucket is one more."""
    _, dp = make_pools(correlation=0.0)
    sweep = _sweep(chunk=16)
    lams = np.linspace(6.0, 48.0, 4)
    policies = [PolicySpec.tofec(), PolicySpec.static(1, 1),
                PolicySpec.static(12, 6), PolicySpec.greedy()]
    cases = grid_cases(lams, policies, [0, 1], CLS, L)
    assert len(cases) == 32

    res = sweep.run(cases, count=400, pools=dp)
    assert res.compiles == 1, res.compiles
    assert res.launches == 2  # 32 points / chunk 16

    res2 = sweep.run(cases[:12], count=500, pools=dp)  # same 512 bucket
    assert res2.compiles == 0
    res3 = sweep.run(cases[:4], count=600, pools=dp)  # new time bucket
    assert res3.compiles == 1
    assert sweep.stats.traces == 2 and sweep.stats.cases == 32 + 12 + 4


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_greedy_rejected_by_fleet_tables():
    with pytest.raises(ValueError, match="taskq"):
        policy_tables(PolicySpec.greedy(), CLS, L)


def test_mixed_L_rejected():
    _, dp = make_pools(correlation=0.0)
    cases = grid_cases([10.0], [PolicySpec.tofec()], [0], CLS, L)
    cases += grid_cases([10.0], [PolicySpec.tofec()], [0], CLS, L=8)
    with pytest.raises(ValueError, match="share L"):
        _sweep().run(cases, 256, dp)


def test_sweep_refuses_what_is_not_ported(tmp_path):
    """Narrow pools raise; REPRO_OBS runs the sweep and the engine with
    their telemetry, the flight log replays a cell and the artifact carries
    its block; the default device is the card."""
    store, dp = make_pools(correlation=0.0, samples=128)
    cases = grid_cases([10.0], [PolicySpec.tofec()], [0], CLS, L)
    with pytest.raises(ValueError, match="pool width"):
        _sweep().run(cases, 64, store.device_pools(n_max=8, device=CPU))
    obs.set_enabled(True)
    try:
        snap = _sweep().run(cases, 64, dp).metrics.snapshot()
        assert snap["counters"]["taskq_requests"] == 64
        out = taskq_scan({"J": 3.0, "alpha": 0.99, "r_max": 2.0, "pol": 1, "gk_max": 6,
                          "h_k": np.zeros(7), "h_n": np.zeros(13)},
                         np.ones(4), np.zeros(4, np.int32), dp.pools, dp.sizes_mb, L=L)
        assert sum(out["obs"].snapshot()["hists"]["taskq_idle"]) == 4
    finally:
        obs.set_enabled(None)
    res = _sweep().run(cases, 64, dp)
    log = _sweep().replay_flight(res, dp, 0)
    assert len(log) == 64
    art = write_taskq_artifact(str(tmp_path / "a.json"), res, flight=log)
    assert art["flight"]["requests"] == 64
    with pytest.raises(ValueError, match="q_cap"):
        _sweep(q_cap=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TaskqSweep()  # the default device is the card


# ---------------------------------------------------------------------------
# Frontier reuse + artifact
# ---------------------------------------------------------------------------


def test_taskq_artifact_orders_policies_like_the_paper(tmp_path):
    """The exact engine's frontier reproduces the TOFEC-vs-static story and
    lands in BENCH_taskq.json via the fleet's reductions."""
    _, dp = make_pools(correlation=0.0)
    lams = np.linspace(6.0, 48.0, 4)
    policies = [PolicySpec.tofec(), PolicySpec.static(1, 1),
                PolicySpec.static(12, 6), PolicySpec.greedy()]
    res = _sweep(chunk=16).run(grid_cases(lams, policies, [1], CLS, L), 1500, dp)
    path = tmp_path / "BENCH_taskq.json"
    art = write_taskq_artifact(str(path), res)
    on_disk = json.loads(path.read_text())
    assert on_disk["schema"] == "repro.taskq/BENCH_taskq/v1"
    assert on_disk["grid_size"] == 16 and len(on_disk["points"]) == 16
    assert art["compiles"] == 1 and art["launches"] == 1

    by = frontier(frontier_points(res))
    assert set(by) == {"tofec", "static(1,1)", "static(12,6)", "greedy"}
    # Light load: high-chunk codes (static(12,6), TOFEC, greedy) all beat
    # the basic code's mean delay.
    light = {name: pts[0].mean for name, pts in by.items()}
    assert light["static(12,6)"] < light["static(1,1)"]
    assert light["tofec"] < light["static(1,1)"]
    assert light["greedy"] < light["static(1,1)"]
    for p in frontier_points(res):
        assert p.p50 <= p.p90 <= p.p95 <= p.p99
