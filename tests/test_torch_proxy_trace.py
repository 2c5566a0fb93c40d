"""The proxy's read path traced from inside the port: ``obs.tracing()`` under
a ``torch.profiler`` session in the proxy's own threads, the per-read stage
stamps, each chunk task's connection time by outcome, the backlog at each
pick, the batched decode's operand shapes, the tracer's clock anchor, and the
closed loop's bucket keys and phase times with the profiler on and off."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.models import get
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.storage import MemoryStore, Proxy, store_coded_object

CPU = torch.device("cpu")
LAYOUT = SharedKeyLayout(K=6, r=2, strip_bytes=128)
PROXY_EVENTS = ("proxy.pick", "proxy.task", "proxy.read", "proxy.decode")


class DelayStore(MemoryStore):
    """A memory store whose ranged reads sleep a set time by their offset."""

    def __init__(self, delays: dict[int, float] | None = None):
        super().__init__()
        self.delays = delays or {}

    def get_range(self, key, offset, length):
        time.sleep(self.delays.get(offset, 0.0))
        return super().get_range(key, offset, length)


class Recording(StaticPolicy):
    """A static code that keeps the backlog it was given at each pick."""

    def __post_init__(self):
        super().__post_init__()
        self.qs = []

    def select(self, *, q, idle, cls_id=0, now=None):
        self.qs.append(q)
        return super().select(q=q, idle=idle, cls_id=cls_id, now=now)


@contextlib.contextmanager
def tracing_by(how: str):
    """Tracing on by a CPU profiler started in this thread, by ``REPRO_OBS``'s
    switch, or off; the tracer emptied first."""
    obs.reset_trace()
    obs.set_enabled(how == "obs")
    try:
        if how == "profiler":
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                yield
        else:
            yield
    finally:
        obs.set_enabled(None)


def _stored(store, count=6, seed=0):
    rng = np.random.default_rng(seed)
    codec = Codec("kernel", device=CPU)
    payloads = [rng.bytes(LAYOUT.file_bytes - 5) for _ in range(count)]
    keys = [f"obj/{i}" for i in range(count)]
    for key, p in zip(keys, payloads):
        store_coded_object(store, key, LAYOUT, p, codec=codec)
    return keys, payloads, codec


def _read_all(proxy, keys, payloads):
    res = proxy.read_many(keys, LAYOUT, LAYOUT.file_bytes - 5, timeout=30)
    assert [r.data for r in res] == payloads
    return res


def _proxy_events(name=None):
    return [ev for ev in obs.get_tracer().events()
            if ev["name"] in PROXY_EVENTS and (name is None or ev["name"] == name)]


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    return out[0]


def _fields(res):
    return [(r.key, r.op, r.n, r.k, r.ok, r.data, r.failures, r.chunks) for r in res]


def test_tracing_off_records_nothing_and_leaves_the_results_alike():
    store = MemoryStore()
    keys, payloads, codec = _stored(store)
    proxy = Proxy(store, StaticPolicy(12, 6), L=8, codec=codec)
    try:
        with tracing_by("off"):
            assert not obs.tracing() and not _in_thread(obs.tracing)
            off = _read_all(proxy, keys, payloads)
            assert _proxy_events() == []
        with tracing_by("profiler"):
            on = _read_all(proxy, keys, payloads)
        assert _fields(off) == _fields(on)
        assert len(_proxy_events("proxy.read")) == len(keys)
    finally:
        proxy.close()
        obs.reset_trace()


@pytest.mark.parametrize("how", ["profiler", "obs"])
def test_tracing_records_every_read_whole_from_the_proxy_threads(how):
    store = MemoryStore()
    keys, payloads, codec = _stored(store)
    shapes = []
    inner = codec.backend.matmul_prepped
    codec.backend.matmul_prepped = lambda m, d: shapes.append(
        (list(m.shape), list(d.shape))) or inner(m, d)
    proxy = Proxy(store, StaticPolicy(12, 6), L=8, codec=codec)
    try:
        with tracing_by(how):
            assert _in_thread(obs.tracing)
            if how == "profiler":
                # the profiler's own switch is the starting thread's alone
                assert torch._C._autograd._profiler_enabled()
                assert not _in_thread(torch._C._autograd._profiler_enabled)
            res = _read_all(proxy, keys, payloads)
        assert not _in_thread(obs.tracing)
        reads = _proxy_events("proxy.read")
        assert sorted(ev["args"]["rid"] for ev in reads) == list(range(len(keys)))
        assert {ev["tid"] for ev in reads} != {threading.get_ident() % 2**31}
        tasks = _proxy_events("proxy.task")
        assert len(tasks) == 12 * len(keys)
        for ev in tasks:
            assert ev["args"]["outcome"] in ("used", "abandoned", "skipped")
        used = [ev for ev in tasks if ev["args"]["outcome"] == "used"]
        assert len(used) == 6 * len(keys)
        assert len(_proxy_events("proxy.pick")) == len(keys)
        decodes = _proxy_events("proxy.decode")
        assert sum(ev["args"]["reads"] for ev in decodes) == len(keys)
        assert sorted(r for ev in decodes for r in ev["args"]["rids"]) == list(range(len(keys)))
        # each batched decode names the shapes its kernel call was handed
        assert [(ev["args"]["bitmat"], ev["args"]["data"]) for ev in decodes] == shapes
        assert all(r.t_decode is not None for r in res)
    finally:
        proxy.close()
        obs.reset_trace()


def test_a_reads_stamps_are_ordered_and_its_stages_sum_to_its_delay():
    store = MemoryStore()
    keys, payloads, codec = _stored(store)
    proxy = Proxy(store, StaticPolicy(4, 2), L=4, codec=codec)
    try:
        with tracing_by("profiler"):
            res = _read_all(proxy, keys, payloads)
        for r in res:
            assert r.t_arrival <= r.t_first_start <= r.t_kth <= r.t_decode <= r.t_done
        by_rid = {ev["args"]["rid"]: ev for ev in _proxy_events("proxy.read")}
        for rid, r in enumerate(res):
            ev = by_rid[rid]["args"]
            stages = [ev[s] for s in ("queue_ms", "store_ms", "decode_wait_ms", "decode_ms")]
            assert min(stages) >= 0
            assert sum(stages) == pytest.approx(r.total_s * 1e3, abs=1e-6)
            assert ev["queue_ms"] == pytest.approx(r.queueing_s * 1e3, abs=1e-9)
            assert ev["queue_ms"] + ev["store_ms"] == pytest.approx(
                (r.t_kth - r.t_arrival) * 1e3, abs=1e-6)
            assert (ev["n"], ev["k"], ev["ok"], ev["raw"]) == (4, 2, True, False)
        # raw reads end at their k-th chunk: no decode stages
        obs.reset_trace()
        with tracing_by("profiler"):
            raw = proxy.read_many(keys[:2], LAYOUT, raw=True, timeout=30)
        for r, ev in zip(raw, sorted(_proxy_events("proxy.read"),
                                     key=lambda e: e["args"]["rid"])):
            assert r.t_decode is None and r.t_kth <= r.t_done
            assert set(ev["args"]) == {"rid", "n", "k", "ok", "raw", "queue_ms", "store_ms"}
            assert ev["args"]["queue_ms"] + ev["args"]["store_ms"] == pytest.approx(
                r.total_s * 1e3, abs=1e-6)
    finally:
        proxy.close()
        obs.reset_trace()


def test_the_slow_extra_chunk_is_abandoned_for_its_whole_delay():
    fast, slow = 0.05, 0.3
    store = DelayStore({LAYOUT.chunk_range(1, 0)[0]: fast, LAYOUT.chunk_range(1, 1)[0]: slow})
    keys, payloads, codec = _stored(store, count=1)
    proxy = Proxy(store, StaticPolicy(2, 1), L=2, codec=codec)
    try:
        with tracing_by("profiler"):
            (r,) = _read_all(proxy, keys, payloads)
            assert r.total_s < slow
            deadline = time.monotonic() + 5
            while len(_proxy_events("proxy.task")) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        tasks = {ev["args"]["chunk"]: ev for ev in _proxy_events("proxy.task")}
        assert tasks[0]["args"]["outcome"] == "used"
        assert tasks[1]["args"]["outcome"] == "abandoned"
        assert tasks[1]["dur"] / 1e6 == pytest.approx(slow, abs=0.05)
        assert tasks[0]["dur"] / 1e6 < slow
    finally:
        proxy.close()
        obs.reset_trace()


def test_a_task_dropped_before_it_starts_is_skipped():
    store = MemoryStore()
    keys, payloads, codec = _stored(store, count=2)
    proxy = Proxy(store, StaticPolicy(2, 1), L=1, codec=codec)
    try:
        with tracing_by("profiler"):
            _read_all(proxy, keys, payloads)
            deadline = time.monotonic() + 5
            while len(_proxy_events("proxy.task")) < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
        tasks = _proxy_events("proxy.task")
        assert sorted(ev["args"]["outcome"] for ev in tasks) == ["skipped", "skipped",
                                                                "used", "used"]
        assert all(ev["dur"] == 0 for ev in tasks if ev["args"]["outcome"] == "skipped")
    finally:
        proxy.close()
        obs.reset_trace()


def test_each_pick_records_the_backlog_the_policy_was_given():
    store = DelayStore()
    keys, payloads, codec = _stored(store, count=8)
    store.delays = {off: 0.01 for off in range(0, LAYOUT.N * LAYOUT.strip_bytes,
                                               LAYOUT.strip_bytes)}
    policy = Recording(4, 2)
    proxy = Proxy(store, policy, L=2, codec=codec)
    try:
        with tracing_by("profiler"):
            _read_all(proxy, keys, payloads)
        picks = sorted(_proxy_events("proxy.pick"), key=lambda e: e["args"]["rid"])
        assert [ev["args"]["q"] for ev in picks] == policy.qs
        assert max(policy.qs) > 0  # the backlog grew while the reads queued
        for ev in picks:
            a = ev["args"]
            assert (a["op"], a["n"], a["k"], a["cls_id"]) == ("read", 4, 2, 0)
            assert 0 <= a["idle"] <= 2
    finally:
        proxy.close()
        obs.reset_trace()


def test_a_complete_event_maps_onto_the_wall_clock_by_the_anchor(tmp_path):
    tracer = obs.Tracer()
    t = time.monotonic()
    wall = time.time_ns()
    tracer.complete("x", t, t + 0.01, tag=1)
    tracer.complete("later", t + 5.0, t + 5.0)
    (ev,) = tracer.events_between(t - 1.0, t + 1.0)
    mono0, wall0 = tracer.anchor
    assert ev["name"] == "x" and ev["dur"] == pytest.approx(1e4) and ev["args"] == {"tag": 1}
    assert abs(wall0 + ev["ts"] * 1e3 - wall) < 1e6
    assert abs(wall0 + (t - mono0) * 1e9 - wall) < 1e6
    import json

    doc = json.load(open(tracer.write_trace(str(tmp_path / "t.json"), wall_clock=True)))
    assert abs(doc["traceEvents"][0]["ts"] * 1e3 - wall) < 1e6


def _serve(profiled: bool):
    arch = get("qwen1.5-0.5b", smoke=True)
    params = arch.init(torch.Generator().manual_seed(2))
    eng = ServingEngine(arch, params, max_seq=64)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=16)
    codec = Codec("kernel", device=CPU)
    store = MemoryStore()
    rng = np.random.default_rng(6)
    keys = []
    for i in range(3):
        toks = rng.integers(0, arch.cfg.vocab, size=(16,)).astype(np.int32)
        ServingEngine.store_prompt(store, f"p/{i}", layout, toks, codec=codec)
        keys.append(f"p/{i}")
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=codec,
                  write_policy=FeedbackPolicy(layout.N, layout.K))
    cls = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
    step = FusedServingStep.for_policy(ServePolicy.tofec(), cls, 16, codec=codec)
    server = ClosedLoopServer(eng, proxy, layout, step, prompt_len=16)
    try:
        with tracing_by("profiler" if profiled else "off"):
            results = [server.serve_round(keys, steps=2) for _ in range(2)]
        return results, server, obs.get_tracer().events()
    finally:
        proxy.close()
        obs.reset_trace()


def test_the_profiler_changes_no_bucket_key_and_spans_carry_the_phase_times():
    off, server_off, events_off = _serve(False)
    on, server_on, events_on = _serve(True)
    assert events_off == []
    assert server_on._seen == server_off._seen and server_on.traces == server_off.traces
    assert all(key[-1] is False for key in server_on._seen)  # collection stays off
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.codes == b.codes and a.next_code == b.next_code
    assert server_on.metrics is None
    for name, phase in (("serve.launch", "launch"), ("serve.generate", "generate")):
        spans = [ev for ev in events_on if ev["name"] == name]
        assert [ev["args"]["device_ms"] for ev in spans] == [r.phase_ms[phase] for r in on]
    reads = [ev for ev in events_on if ev["name"] == "proxy.read"]
    assert len(reads) == 2 * 3 and all(ev["args"]["raw"] for ev in reads)
