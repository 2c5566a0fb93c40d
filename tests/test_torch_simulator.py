"""The port's event simulator (``repro_torch.core.simulator``) and trace
machinery, mirroring the host tests of ``tests/test_simulator.py``: against
the Eq. 2 / Eq. 4 analytics, the policies' behaviour under load, the trace
store, and the port's fluid scan (on the CPU) against the event simulator.
Bars, seeds and sizes are the reference tests' own.
"""

import numpy as np
import pytest

from repro_torch.core import (
    PAPER_READ_3MB,
    GreedyPolicy,
    RequestClass,
    StaticPolicy,
    TofecTables,
    TOFECPolicy,
    build_class_plan,
)
from repro_torch.core import queueing
from repro_torch.core.fluid_scan import run_tofec_scan
from repro_torch.core.simulator import piecewise_poisson_arrivals, poisson_arrivals, simulate
from repro_torch.core.traces import StoreSampler, TraceSampler, TraceStore

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
SAMPLER = TraceSampler(PAPER_READ_3MB, CLS.file_mb)


def _run(policy, lam, count=6000, seed=1):
    rng = np.random.default_rng(seed)
    arr = poisson_arrivals(rng, lam, count)
    return simulate(policy, arr, SAMPLER, L=L, seed=seed + 1)


@pytest.mark.parametrize("n,k", [(1, 1), (2, 1), (6, 3), (12, 6)])
def test_static_light_load_matches_eq2(n, k):
    """At light load, total ≈ service delay ≈ Eq. 2's exact form."""
    res = _run(StaticPolicy(n, k), lam=1.0, count=3000)
    want = queueing.service_delay_exact(PAPER_READ_3MB, 3.0, k, n)
    got = res.totals().mean()
    assert got == pytest.approx(want, rel=0.08), (n, k, got, want)


def test_static_moderate_load_queueing_positive_and_bounded():
    """At 60% load, simulated total ≈ D_s + D_q(M/M/1) within coarse bounds."""
    n, k = 1, 1
    U = queueing.usage(PAPER_READ_3MB, 3.0, k, n / k)
    lam = 0.6 * L / U
    res = _run(StaticPolicy(n, k), lam, count=12000)
    d_s = queueing.service_delay_exact(PAPER_READ_3MB, 3.0, k, n)
    d_q = queueing.queueing_delay(lam, U, L)
    got = res.totals().mean()
    assert d_s * 0.93 < got < d_s + 4 * d_q + 0.05
    assert res.queueing().mean() >= 0


def test_overload_queue_grows():
    U = queueing.usage(PAPER_READ_3MB, 3.0, 3, 2.0)
    lam = 1.4 * L / U
    res = _run(StaticPolicy(6, 3), lam, count=4000)
    d_s = queueing.service_delay_exact(PAPER_READ_3MB, 3.0, 3, 6)
    assert res.totals().mean() > 5 * d_s


def test_more_redundancy_cuts_light_load_delay():
    means = [_run(StaticPolicy(n, 3), lam=1.0, count=3000).totals().mean() for n in [3, 4, 5, 6]]
    assert np.all(np.diff(means) < 0)  # Fig. 5: extra coded chunks help


def test_tofec_tracks_light_and_heavy():
    light = _run(TOFECPolicy.for_classes([CLS], L), lam=2.0, count=4000)
    assert light.ks().mean() > 4.0  # high chunking at light load
    basic = _run(StaticPolicy(1, 1), lam=2.0, count=4000)
    assert light.totals().mean() < 0.55 * basic.totals().mean()
    U11 = queueing.usage(PAPER_READ_3MB, 3.0, 1, 1.0)
    heavy = _run(TOFECPolicy.for_classes([CLS], L), 0.9 * L / U11, count=12000)
    assert heavy.ks().mean() < 2.5  # converges toward (1,1)
    assert heavy.totals().mean() < 3.0


def test_greedy_vs_tofec_std():
    """Fig. 9: Greedy's all-or-nothing behaviour → higher delay std at mid load."""
    tofec = _run(TOFECPolicy.for_classes([CLS], L), 30.0, count=9000)
    greedy = _run(GreedyPolicy(CLS.k_max, CLS.r_max), 30.0, count=9000, seed=7)
    assert greedy.totals().std() > 1.2 * tofec.totals().std()


def test_greedy_composition_bimodal():
    """Fig. 8: Greedy round-robins k; k=1 and k=6 dominate at mid load."""
    comp = _run(GreedyPolicy(CLS.k_max, CLS.r_max), lam=30.0, count=9000).k_composition(
        CLS.k_max)
    assert comp[0] + comp[5] > 0.5


def test_piecewise_arrivals_shape():
    arr = piecewise_poisson_arrivals(np.random.default_rng(0),
                                     [(200.0, 10.0), (200.0, 70.0), (200.0, 10.0)])
    assert arr[0] > 0 and arr[-1] < 600.0
    assert np.sum((arr > 200) & (arr < 400)) > 10_000  # ~70/s for 200 s
    assert np.all(np.diff(arr) > 0)


def test_trace_store_fit_and_correlation():
    store = TraceStore.generate(
        PAPER_READ_3MB, [0.5, 1.0, 1.5, 3.0], samples=20_000, correlation=0.14, seed=3
    )
    assert 0.08 < store.cross_correlation(1.0) < 0.25  # §III-B(2): shared key
    store_uk = TraceStore.generate(PAPER_READ_3MB, [1.0], samples=20_000, correlation=0.0,
                                   seed=4)
    assert abs(store_uk.cross_correlation(1.0)) < 0.05  # unique key


def test_store_sampler_drives_simulation():
    store = TraceStore.generate(PAPER_READ_3MB, [0.5, 0.6, 0.75, 1.0, 1.5, 3.0], samples=5000)
    arr = poisson_arrivals(np.random.default_rng(0), 2.0, 1500)
    res = simulate(StaticPolicy(6, 3), arr, StoreSampler(store, CLS.file_mb), L=L)
    want = queueing.service_delay_exact(PAPER_READ_3MB, 3.0, 3, 6)
    assert res.totals().mean() == pytest.approx(want, rel=0.15)


def test_fluid_scan_close_to_event_sim():
    """The twin of the reference's jax-scan check: the port's fluid scan on
    the CPU against the event simulator, same regime."""
    plan = build_class_plan(CLS, L)
    tables = TofecTables.from_plan(plan, device="cpu")
    out = run_tofec_scan(CLS, tables, lam=5.0, count=4000, L=L, device="cpu")
    event = _run(TOFECPolicy([plan]), lam=5.0, count=4000)
    assert out["k"].mean() > 4.0
    assert out["total"].mean() == pytest.approx(event.totals().mean(), rel=0.3)
