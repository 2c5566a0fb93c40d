"""The port's telemetry planes on the card. Each test is marked ``cuda`` and
skips where no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_obs_cuda.py

What is held: collection adds no host sync (``torch.cuda.set_sync_debug_mode
("error")`` around the collection code, which turns a sync into an error);
with collection on, a sweep's and a closed-loop round's primary outputs
equal the uncollected run's bit for bit on the card; counters and
histograms equal host recounts of those outputs exactly; the card's delay
buckets equal the CPU's (comparisons against float32 edges, exact on
either device).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.core.traces import TraceStore
from repro_torch.fleet import FleetSweep, PolicySpec, grid_cases
from repro_torch.models import get
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.storage import MemoryStore, Proxy
from repro_torch.taskq import TaskqSweep, taskq_scan_core
from repro_torch.taskq.policies import encode_policy

pytestmark = pytest.mark.cuda

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
L = 16
PROMPT_LEN = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@contextlib.contextmanager
def no_sync():
    """Any host sync inside raises; the queue is drained before and after."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _pools(device):
    store = TraceStore.generate(PAPER_READ_3MB, [3.0 / k for k in range(1, 7)], threads=12,
                                samples=512, correlation=0.14, seed=3)
    return store.device_pools(n_max=12, device=device)


def _grid():
    return grid_cases([10.0, 40.0], [PolicySpec.tofec(), PolicySpec.static(12, 6)], [1],
                      CLS, L)


def test_collection_is_sync_free_on_card(cuda):
    """The buffers' updates and folds, the sweeps' per-case metrics and
    timelines, a collected exact-engine run and a closed-loop round's
    collection, all under the sync-debug mode's "error"."""
    rng = np.random.default_rng(0)
    G, T = 6, 300
    out = {"total": torch.from_numpy(rng.exponential(0.3, (G, T)).astype(np.float32)).to(cuda),
           "n": torch.from_numpy(rng.integers(1, 13, (G, T)).astype(np.int32)).to(cuda),
           "k": torch.from_numpy(rng.integers(1, 7, (G, T)).astype(np.int32)).to(cuda)}
    inter = torch.from_numpy(rng.exponential(0.05, (G, T)).astype(np.float32)).to(cuda)
    cfg = {"obs_count": torch.full((G,), T, dtype=torch.int32, device=cuda)}
    enc = encode_policy(PolicySpec.tofec(), CLS, L, 7, 13, None)
    row = {"J": 3.0, "alpha": enc.alpha, "r_max": enc.r_max, "pol": enc.pol,
           "gk_max": enc.gk_max, "h_k": enc.h_k, "h_n": enc.h_n}
    tq_cfg = {}
    for name, v in row.items():
        a = np.asarray(v, np.int32 if name in ("pol", "gk_max") else np.float32)
        tq_cfg[name] = torch.from_numpy(np.stack([a, a])).to(cuda)
    pools = _pools(cuda)
    tq_inter = inter[:2, :64].contiguous()
    tq_idx = torch.from_numpy(rng.integers(0, 512, (2, 64)).astype(np.int32)).to(cuda)
    delays = torch.tensor([0.2, 0.5, 1.5], dtype=torch.float32).pin_memory()
    obs.delay_bucket(torch.ones(1, device=cuda))  # the edges' one upload
    with no_sync():
        valid = obs.valid_mask(cfg, T)
        mb = obs.sweep_point_metrics(out, "fleet", valid=valid).reduce_rows(G - 1)
        mb = mb.merge(mb)
        tl = obs.sweep_timeline(out, inter, window=8, valid=valid, horizon=512,
                                backlog=out["total"])
        tl = tl.reduce_rows(G - 1).concat(tl)
        taskq_scan_core(tq_cfg, tq_inter, tq_idx, pools.pools, pools.sizes_mb, L=L,
                        collect=True, window=1, horizon=64)
        ring = obs.TimelineBuf.zeros(4, series=("x",), hists={"d": obs.DELAY_BINS},
                                     device=cuda)
        d = delays.to(cuda, non_blocking=True)
        for i in range(6):
            ring = ring.append({"x": float(i)}, {"d": (obs.delay_bucket(d), 1)})
        buf = obs.MetricsBuf.zeros(counters=("c",), hists={"q": 64}, highs=("hi",),
                                   device=cuda)
        buf = buf.count("c", 3).observe("q", 5.0).observe("q", out["n"][0]).high("hi", 2.5)
    assert mb.snapshot()["counters"]["fleet_requests"] == 2 * (G - 1) * T
    assert tl.snapshot()["capacity"] == 64
    assert ring.snapshot()["slots"] == 4 and buf.snapshot()["counters"]["c"] == 3


def test_sweep_collection_invariant_on_card(cuda):
    """Fleet and taskq grids on the card: outputs bit-identical with
    collection on, counters and pick histograms equal to a host recount,
    delay buckets equal to the CPU's on the same delays."""
    cases, count = _grid(), 700
    pools = _pools(cuda)
    try:
        obs.set_enabled(False)
        f0 = FleetSweep(chunk=2, device=cuda).run(cases, count)
        t0 = TaskqSweep(chunk=2, device=cuda).run(cases, count, pools)
        obs.set_enabled(True)
        f1 = FleetSweep(chunk=2, device=cuda).run(cases, count)
        t1 = TaskqSweep(chunk=2, device=cuda).run(cases, count, pools)
    finally:
        obs.set_enabled(None)
    for base, res, prefix in ((f0, f1, "fleet"), (t0, t1, "taskq")):
        a, b = base.to_numpy(), res.to_numpy()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{prefix} {name}")
        snap = res.metrics.snapshot()
        assert snap["counters"][f"{prefix}_requests"] == len(cases) * count
        np.testing.assert_array_equal(snap["hists"][f"{prefix}_pick_n"],
                                      np.bincount(b["n"].ravel(), minlength=obs.PICK_BINS))
        tl = res.timeline.snapshot()
        assert tl["hists"]["delay"].sum() == len(cases) * count
        want = obs.delay_bucket(torch.from_numpy(b["total"])).numpy()
        got = obs.delay_bucket(res.out["total"]).cpu().numpy()
        np.testing.assert_array_equal(got, want)
    c = t1.metrics.snapshot()["counters"]
    assert c["taskq_cancelled"] == c["taskq_cancel_queue"] + c["taskq_cancel_service"]


def test_collected_closed_loop_round_on_card(cuda):
    """One collected round of the smoke config: the uncollected round's
    tokens and pick, exact counters, one bucket."""
    arch = get("qwen1.5-0.5b", smoke=True)
    params = arch.init(torch.Generator(device=cuda).manual_seed(2))
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store = MemoryStore()
    rng = np.random.default_rng(6)
    keys = []
    for i in range(3):
        toks = rng.integers(0, arch.cfg.vocab, size=(PROMPT_LEN,)).astype(np.int32)
        ServingEngine.store_prompt(store, f"p/{i}", layout, toks, codec=Codec("numpy"))
        keys.append(f"p/{i}")
    results = {}
    for collect in (False, True):
        codec = Codec("kernel", device=cuda)
        proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=codec,
                      write_policy=FeedbackPolicy(layout.N, layout.K))
        step = FusedServingStep.for_policy(ServePolicy.tofec(), CLS, L, codec=codec)
        server = ClosedLoopServer(ServingEngine(arch, params, max_seq=64), proxy, layout, step,
                                  prompt_len=PROMPT_LEN)
        obs.set_enabled(collect)
        try:
            results[collect] = (server.serve_round(keys, steps=3), server)
        finally:
            obs.set_enabled(None)
            proxy.close()
    (off, _), (on, server) = results[False], results[True]
    np.testing.assert_array_equal(on.tokens, off.tokens)
    assert on.next_code == off.next_code and server.traces == 1
    snap = server.metrics.snapshot()
    assert snap["counters"] == {"serve_rounds": 1, "serve_requested": 3, "serve_served": 3,
                                "serve_decode_errors": 0}
    assert snap["hists"]["serve_pick_n"][on.next_code[0]] == 1
    tl = server.timeline.snapshot()
    assert tl["slots"] == 1 and tl["hists"]["delay"].sum() == 3
    assert len(server.flight) == 1
    # The round's collection alone, from device picks and pinned delays.
    n_nxt = torch.full((), on.next_code[0], dtype=torch.int32, device=cuda)
    k_nxt = torch.full((), on.next_code[1], dtype=torch.int32, device=cuda)
    delays = torch.tensor([0.1, 0.2], dtype=torch.float32).pin_memory()
    with no_sync():
        server._collect(q=3.0, dt=0.5, n_nxt=n_nxt, k_nxt=k_nxt, requested=3,
                        delays=delays.to(cuda, non_blocking=True))
    snap = server.metrics.snapshot()
    assert snap["counters"]["serve_rounds"] == 2 and snap["counters"]["serve_served"] == 5
    assert server.timeline.snapshot()["hists"]["delay"].sum() == 5
