"""The port's fluid scan (``repro_torch.core.fluid_scan``) against the
reference package's ``repro.core.jax_sim``, on the CPU, mirroring
``tests/test_scan_regression.py``.

Tolerances, those of the reference's own regression test: code picks equal
on ≥ 0.999 of arrivals (a stray flip at a threshold boundary from another
float32 operation order), delays within rtol 1e-4 / atol 1e-6. The copied
numpy oracle and the host policies are held bit for bit, and the batched
(G > 1) scan row by row against single-row runs: picks exact, delays within
rtol 1e-6 (a sum over n_max may take another order at another batch width).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PAPER_READ_3MB as REF_READ_3MB
from repro.core import RequestClass as RefRequestClass
from repro.core import TofecTables as RefTofecTables
from repro.core import build_class_plan as ref_build_class_plan
from repro.core import jax_sim
from repro_torch.core import (
    PAPER_READ_3MB,
    PAPER_WRITE_3MB,
    RequestClass,
    TofecTables,
    TOFECPolicy,
    build_class_plan,
    tofec_step,
    tofec_threshold_step,
)
from repro_torch.core.fluid_scan import (
    PARAM_FIELDS,
    FluidScanParams,
    run_tofec_scan,
    simulate_tofec_reference,
    simulate_tofec_scan,
    tofec_scan_core,
)
from repro_torch.core.simulator import poisson_arrivals, simulate
from repro_torch.core.traces import TraceSampler
from repro_torch.fleet import PolicySpec, policy_tables

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
PLAN = build_class_plan(CLS, L)
TABLES = TofecTables.from_plan(PLAN, device="cpu")
P = FluidScanParams.from_class(CLS, L)
REF_TABLES = RefTofecTables.from_plan(ref_build_class_plan(REF_CLS, L))
REF_P = jax_sim.JaxSimParams.from_class(REF_CLS, L)


def _fixed_trace(lam: float, count: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    inter = rng.exponential(1.0 / lam, size=count).astype(np.float32)
    exps = rng.exponential(1.0, size=(count, CLS.n_max)).astype(np.float32)
    return inter, exps


def _assert_close_runs(got: dict, want: dict):
    assert (got["n"] == want["n"]).mean() >= 0.999
    assert (got["k"] == want["k"]).mean() >= 0.999
    for field in ("total", "queueing", "service"):
        np.testing.assert_allclose(got[field], want[field], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("lam", [5.0, 40.0])
def test_scan_matches_host_reference_and_jax_scan_step_for_step(lam):
    inter, exps = _fixed_trace(lam, count=2000)
    out = {k: v.numpy() for k, v in simulate_tofec_scan(P, TABLES, inter, exps).items()}
    ref = simulate_tofec_reference(P, TABLES, inter, exps)
    # The copied numpy oracle is the reference's, bit for bit.
    ref_ref = jax_sim.simulate_tofec_reference(REF_P, REF_TABLES, inter, exps)
    for k in ref:
        np.testing.assert_array_equal(ref[k], ref_ref[k])
    _assert_close_runs(out, ref)
    jax_out = jax_sim.simulate_tofec_scan(REF_P, REF_TABLES, jnp.asarray(inter), jnp.asarray(exps))
    _assert_close_runs(out, {k: np.asarray(v) for k, v in jax_out.items()})


def test_scan_pinned_golden_head():
    """The reference's golden pin: the first decisions of the light-load trace."""
    inter, exps = _fixed_trace(5.0, count=64)
    out = simulate_tofec_scan(P, TABLES, inter, exps)
    np.testing.assert_array_equal(out["k"].numpy()[:8], [6, 6, 6, 6, 2, 6, 6, 6])
    np.testing.assert_array_equal(out["n"].numpy()[:8], [12, 12, 12, 12, 3, 12, 12, 12])


@pytest.mark.parametrize("lam,k_lo,k_hi", [(2.0, 4.0, 6.0), (50.0, 1.0, 2.8)])
def test_scan_adaptation_tracks_event_sim(lam, k_lo, k_hi):
    """The scan and the (copied) event oracle agree on WHICH codes load selects."""
    inter, exps = _fixed_trace(lam, count=4000)
    scan_k = float(simulate_tofec_scan(P, TABLES, inter, exps)["k"].float().mean())
    rng = np.random.default_rng(7)
    arr = poisson_arrivals(rng, lam, 4000)
    event = simulate(TOFECPolicy([PLAN]), arr, TraceSampler(PAPER_READ_3MB, CLS.file_mb),
                     L=L, seed=8)
    event_k = float(event.ks().mean())
    assert k_lo <= scan_k <= k_hi, (scan_k, event_k)
    assert k_lo <= event_k <= k_hi, (scan_k, event_k)
    assert abs(scan_k - event_k) < 1.2


def test_ewma_warmup_seeds_from_first_observation():
    """The reference's cold-start pin, on the port's host policy and tensor
    step: q̄ starts at exactly the first observation."""
    qs = [30, 30, 5, 0, 0, 0]
    pol = TOFECPolicy([PLAN], alpha=0.5)
    host_codes, host_qbar = [], []
    for q in qs:
        host_codes.append(pol.select(q=q, idle=0))
        host_qbar.append(float(pol.q_ewma))
    q_ewma = torch.tensor(-1.0)  # device cold-start sentinel
    dev_codes, dev_qbar = [], []
    for q in qs:
        q_ewma, n, k = tofec_step(q_ewma, torch.tensor(float(q)), TABLES, 0.5)
        dev_codes.append((int(n), int(k)))
        dev_qbar.append(float(q_ewma))
    assert host_codes == dev_codes == [(1, 1), (1, 1), (1, 1), (1, 1), (2, 1), (3, 2)]
    np.testing.assert_allclose(host_qbar, [30.0, 30.0, 17.5, 8.75, 4.375, 2.1875], rtol=1e-6)
    np.testing.assert_allclose(dev_qbar, host_qbar, rtol=1e-6)


def test_batched_threshold_step_counts_each_row_alone():
    """A (G,) batch of threshold updates equals G scalar updates, row by row:
    no row's thresholds leak into another's count."""
    rng = np.random.default_rng(3)
    specs = [PolicySpec.tofec(), PolicySpec.static(1, 1), PolicySpec.static(12, 6),
             PolicySpec.fixedk(3), PolicySpec.static(5, 4)]
    tabs = [policy_tables(s, CLS, L) for s in specs]
    h_k = torch.tensor(np.stack([t[0] for t in tabs]))
    h_n = torch.tensor(np.stack([t[1] for t in tabs]))
    r_max = torch.tensor([t[2] for t in tabs], dtype=torch.float32)
    alpha = torch.full((len(specs),), 0.7)
    q_ewma = torch.full((len(specs),), -1.0)
    q_rows = [torch.tensor(-1.0)] * len(specs)
    for q in rng.exponential(4.0, size=40).astype(np.float32):
        q_ewma, n, k = tofec_threshold_step(q_ewma, torch.full((len(specs),), float(q)),
                                            h_k, h_n, r_max, alpha)
        for g, (hk, hn, rm) in enumerate(tabs):
            q_rows[g], n_g, k_g = tofec_threshold_step(q_rows[g], float(q), torch.tensor(hk),
                                                       torch.tensor(hn), rm, 0.7)
            assert (int(n[g]), int(k[g])) == (int(n_g), int(k_g))
            assert float(q_ewma[g]) == float(q_rows[g])


def test_grid_scan_rows_equal_single_row_runs():
    """tofec_scan_core over a (G=4) grid of different classes, policies and
    loads equals four single-row runs, row by row."""
    wr = RequestClass("write1mb", 1.0, PAPER_WRITE_3MB, k_max=3, r_max=2.0, n_max=6)
    rows = [(CLS, PolicySpec.tofec(), 8.0), (CLS, PolicySpec.static(6, 3), 20.0),
            (wr, PolicySpec.tofec(), 30.0), (CLS, PolicySpec.fixedk(6), 12.0)]
    count, G = 600, len(rows)
    hk = np.zeros((G, CLS.k_max + 1), np.float32)
    hn = np.zeros((G, CLS.n_max + 1), np.float32)
    inter = np.zeros((G, count), np.float32)
    exps = np.zeros((G, count, CLS.n_max), np.float32)
    fields = {f: np.zeros(G, np.float32) for f in PARAM_FIELDS}
    r_max = np.zeros(G, np.float32)
    singles = []
    for g, (c, spec, lam) in enumerate(rows):
        h_k, h_n, rm = policy_tables(spec, c, L)
        hk[g, : len(h_k)], hn[g, : len(h_n)], r_max[g] = h_k, h_n, rm
        rng = np.random.default_rng(g)
        inter[g] = rng.exponential(1.0 / lam, count)
        exps[g, :, : c.n_max] = rng.exponential(1.0, (count, c.n_max))
        p = FluidScanParams.from_class(c, L, spec.alpha)
        for f in fields:
            fields[f][g] = getattr(p, f)
        singles.append((p, h_k, h_n, rm))
    t = torch.from_numpy
    grid = tofec_scan_core(types.SimpleNamespace(**{f: t(v) for f, v in fields.items()}),
                           t(hk), t(hn), t(r_max), t(inter), t(exps), n_max=CLS.n_max)
    for g, (p, h_k, h_n, rm) in enumerate(singles):
        one = tofec_scan_core(p.rows(1, "cpu"), t(hk[g : g + 1]), t(hn[g : g + 1]),
                              t(r_max[g : g + 1]), t(inter[g : g + 1]), t(exps[g : g + 1]),
                              n_max=CLS.n_max)
        for name in ("n", "k"):
            np.testing.assert_array_equal(grid[name][g].numpy(), one[name][0].numpy())
        for name in ("total", "queueing", "service"):
            np.testing.assert_allclose(grid[name][g].numpy(), one[name][0].numpy(), rtol=1e-6)


def test_run_tofec_scan_matches_reference_and_needs_a_device():
    got = run_tofec_scan(CLS, TABLES, 25.0, 800, seed=4, device="cpu")
    want = jax_sim.run_tofec_scan(REF_CLS, REF_TABLES, 25.0, 800, seed=4)
    _assert_close_runs(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_tofec_scan(CLS, TABLES, 25.0, 8)  # the default device is the card
