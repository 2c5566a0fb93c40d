"""End-to-end behaviour of the port, mirroring ``tests/test_system.py``: the
paper's headline claims through the port's controller → event oracle
(``repro_torch.core.simulator`` with ``repro_torch.core.traces``), the MPC
controller, and storage → proxy → erasure decode after chunk-read failures.

The event oracle and trace sampler are numpy copies of the reference's,
so the first test also holds them bit for bit against the reference's on
one run. Thresholds are the reference test's own.
"""

import numpy as np
import torch

from repro.core import PAPER_READ_3MB as REF_READ_3MB
from repro.core import TOFECPolicy as RefTOFECPolicy
from repro.core import RequestClass as RefRequestClass
from repro.core import StaticPolicy as RefStaticPolicy
from repro.core.simulator import simulate as ref_simulate
from repro.core.traces import TraceSampler as RefTraceSampler
from repro.core.traces import TraceStore as RefTraceStore
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import (
    PAPER_READ_3MB,
    RequestClass,
    StaticPolicy,
    TOFECPolicy,
)
from repro_torch.core import queueing
from repro_torch.core.controller import MPCPolicy
from repro_torch.core.simulator import poisson_arrivals, simulate
from repro_torch.core.traces import TraceSampler, TraceStore
from repro_torch.storage import FaultyStore, MemoryStore, Proxy, store_coded_object

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
SAMPLER = TraceSampler(PAPER_READ_3MB, 3.0, correlation=0.14)


def _run(policy, lam, count=5000, seed=11):
    rng = np.random.default_rng(seed)
    return simulate(policy, poisson_arrivals(rng, lam, count), SAMPLER, L=L, seed=seed)


def test_event_oracle_copy_equals_reference_event_for_event():
    """Same arrivals, policy and shared-key sampler seed: the copied oracle
    gives the reference's requests, codes and delays exactly, and the same
    per-task event log."""
    ref_cls = RefRequestClass("read3mb", 3.0, REF_READ_3MB, k_max=6, r_max=2.0, n_max=12)
    arr = poisson_arrivals(np.random.default_rng(3), 40.0, 1500)
    log, ref_log = [], []
    got = simulate(TOFECPolicy.for_classes([CLS], L), arr, SAMPLER, L=L, seed=5, event_log=log)
    want = ref_simulate(RefTOFECPolicy.for_classes([ref_cls], L), arr,
                        RefTraceSampler(REF_READ_3MB, 3.0, correlation=0.14), L=L, seed=5,
                        event_log=ref_log)
    for f in ("totals", "queueing", "service", "ks", "ns"):
        np.testing.assert_array_equal(getattr(got, f)(), getattr(want, f)())
    np.testing.assert_array_equal(np.asarray(log, np.float64), np.asarray(ref_log, np.float64))
    assert got.summary() == want.summary()


def test_paper_headline_light_load_gain():
    """TOFEC ≥ 1.7× lower mean delay than basic at light load (paper ~2.5×)."""
    cap = queueing.capacity(PAPER_READ_3MB, 3.0, 1, 1.0, L)
    tofec = _run(TOFECPolicy.for_classes([CLS], L), 0.15 * cap)
    basic = _run(StaticPolicy(1, 1), 0.15 * cap)
    assert basic.totals().mean() / tofec.totals().mean() > 1.7


def test_paper_headline_capacity_retention():
    """TOFEC sustains ≥ 2.3× the arrival rate that the delay-optimal static
    (6,3) code can (paper: >3×) — queues stay bounded where (6,3) diverges."""
    cap = queueing.capacity(PAPER_READ_3MB, 3.0, 1, 1.0, L)
    lam = 0.9 * cap
    tofec = _run(TOFECPolicy.for_classes([CLS], L), lam, count=8000)
    static63 = _run(StaticPolicy(6, 3), lam, count=8000)
    assert tofec.totals().mean() < 0.6  # bounded
    assert static63.totals().mean() > 5 * tofec.totals().mean()  # divergent
    cap63 = queueing.capacity(PAPER_READ_3MB, 3.0, 3, 2.0, L)
    assert cap / cap63 > 2.3


def test_beyond_paper_mpc_dominates_threshold_controller():
    cap = queueing.capacity(PAPER_READ_3MB, 3.0, 1, 1.0, L)
    for frac in (0.4, 0.75):
        tofec = _run(TOFECPolicy.for_classes([CLS], L), frac * cap)
        mpc = _run(MPCPolicy(CLS, L), frac * cap)
        assert mpc.totals().mean() < tofec.totals().mean() * 1.02, frac


def test_full_stack_read_after_node_losses():
    """Fig.3 layout + proxy + RS decode survive failures of chunk reads."""
    codec = Codec("kernel", device="cpu")  # the plain path of K1
    layout = SharedKeyLayout(K=6, r=2, strip_bytes=512)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, size=layout.file_bytes, dtype=np.uint8).tobytes()
    inner = MemoryStore()
    store_coded_object(inner, "blob", layout, payload, codec=codec)
    store = FaultyStore(inner, p_fail=0.45, seed=1)
    proxy = Proxy(store, StaticPolicy(6, 3), L=8, codec=codec)
    try:
        ok = 0
        for _ in range(12):
            res = proxy.read("blob", layout, payload_len=len(payload))
            if res.ok:
                assert res.data == payload
                ok += 1
        assert ok >= 6  # (6,3) tolerates 3 failures/request at 45% fail rate
    finally:
        proxy.close()


def test_trace_pools_on_a_device_equal_reference_pools():
    """TraceStore's copula pools draw for draw, their stacked export as
    tensors on an explicit device, and the oracle reading them by arrival
    index (the shared-pool sampler hook) as the reference does."""
    sizes = [0.5, 1.0, 1.5, 3.0]
    store = TraceStore.generate(PAPER_READ_3MB, sizes, samples=500, correlation=0.14, seed=6)
    ref = RefTraceStore.generate(REF_READ_3MB, sizes, samples=500, correlation=0.14, seed=6)
    for a, b in zip(store.pools, ref.pools):
        np.testing.assert_array_equal(a, b)
    assert store.cross_correlation(1.0) == ref.cross_correlation(1.0)
    pools = store.device_pools(12, size=400, device="cpu")
    ref_pools = ref.device_pools(12, size=400)
    assert isinstance(pools.pools, torch.Tensor) and pools.pools.device.type == "cpu"
    np.testing.assert_array_equal(pools.pools.numpy(), ref_pools.pools)
    np.testing.assert_array_equal(pools.sizes_mb.numpy(), ref_pools.sizes_mb)
    idx = np.random.default_rng(2).integers(0, pools.n_rows, 300)
    arr = poisson_arrivals(np.random.default_rng(4), 30.0, 300)
    got = simulate(StaticPolicy(6, 3), arr, pools.host_sampler(3.0, idx), L=L, seed=1)
    want = ref_simulate(RefStaticPolicy(6, 3), arr, ref_pools.host_sampler(3.0, idx), L=L,
                        seed=1)
    np.testing.assert_array_equal(got.totals(), want.totals())
