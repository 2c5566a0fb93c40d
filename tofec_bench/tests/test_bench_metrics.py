"""The metric arithmetic: percentiles over every request, the round-boundary
window, the trace's shares, K1's bound and the model's FLOPs."""

import json

import numpy as np
import pytest

from tofec_bench.harness import readers, spec, trace, yardstick
from tofec_bench.harness.record import Check, Record, percentile


def _rec(lat_ms, failed=0):
    rec = Record()
    for i, ms in enumerate(lat_ms):
        rec.requests.append({"due": 100.0 + i, "done": 100.0 + i + ms / 1e3, "ok": True})
    for i in range(failed):
        rec.requests.append({"due": 0.0, "done": None, "ok": False})
    return rec


def test_percentiles_are_over_every_request():
    rng = np.random.default_rng(3)
    lat = rng.exponential(200.0, 2341)
    rec = _rec(lat, failed=2)
    assert readers.latency_p50_ms(rec) == pytest.approx(np.percentile(lat, 50), rel=1e-9)
    assert readers.latency_p95_ms(rec) == pytest.approx(np.percentile(lat, 95), rel=1e-9)
    assert rec.attempted == 2343 and rec.failed == 2
    assert percentile([], 95) is None


def test_tokens_per_second_end_at_a_round_boundary():
    rec = Record(t0=10.0)
    rec.rounds = [{"start": 10.0 + 4 * i, "end": 14.0 + 4 * i, "steps": 64, "traced": False,
                   "after_profiler": False} for i in range(3)]
    rec.t1 = rec.rounds[-1]["end"]
    rec.requests = [{"ok": True}] * 96
    assert readers.gen_tokens_per_s(rec) == pytest.approx(96 * 64 / 12.0)
    rec.requests = [{"ok": True}] * 95 + [{"ok": False}]
    assert readers.gen_tokens_per_s(rec) == pytest.approx(95 * 64 / 12.0)


def test_round_phase_metrics_read_the_rounds_before_the_profiler():
    model = json.load(open(spec.ROOT / "tofec_bench/configs/zamba2-2.7b.json"))["model"]
    rec = Record(config={"model": model})
    rec.rounds = [
        {"phase_ms": {"fetch": 400.0, "launch": 2600.0, "generate": 2200.0}, "rows": 17,
         "padded": 32, "steps": 32, "traced": False, "after_profiler": False, "start": 0.0,
         "end": 5.4, "prompt": 1024},
        {"phase_ms": {"fetch": 900.0, "launch": 9000.0, "generate": 9000.0}, "rows": 32,
         "padded": 32, "steps": 32, "traced": True, "after_profiler": True, "start": 5.4,
         "end": 25.0, "prompt": 1024},
        {"phase_ms": {"fetch": 700.0, "launch": 3000.0, "generate": 3300.0}, "rows": 32,
         "padded": 32, "steps": 32, "traced": False, "after_profiler": True, "start": 25.0,
         "end": 32.0, "prompt": 1024},
    ]
    rec.requests = ([{"due": 0.0, "done": 5.4 + i / 100, "round": 0} for i in range(3)]
                    + [{"due": 0.0, "done": 30.0, "round": 1}] * 5)
    assert readers.fetch_ms(rec) == 400.0
    assert readers.launch_ms_per_row(rec) == pytest.approx(2600.0 / 32)
    assert readers.decode_step_ms(rec) == pytest.approx(2200.0 / 31)
    # the served rows' FLOPs, not the padded batch's
    assert readers.mfu(rec) == pytest.approx(
        100.0 * yardstick.hybrid_flops(model, 17, 1024, 32) / (5.4 * yardstick.PEAK_BF16_FLOPS))
    assert readers.prompt_p50_ms(rec) == pytest.approx(5410.0)


def test_controller_metrics():
    rec = Record()
    rec.requests = [{"k": 1, "n": 2}, {"k": 2, "n": 2}, {"k": 6, "n": 12}]
    assert readers.mean_k(rec) == pytest.approx(3.0)
    assert readers.useful_chunk_share(rec) == pytest.approx(100.0 * 9 / 16)


def _events(dev, host):
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, s, e, kind):
            self._n, self._s, self._e, self._k = name, s, e, kind

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def end_ns(self):
            return self._e

        def device_type(self):
            return self._k

    return ([Ev(n, s, e, DeviceType.CUDA) for n, s, e in dev]
            + [Ev(n, s, e, DeviceType.CPU) for n, s, e in host])


def test_trace_summary_busy_idle_and_names():
    dev = [("k1_regs_kernel<6, true>", 100, 200), ("gemm", 150, 300), ("gemm", 500, 600),
           ("bench.round", 0, 1000)]  # a host range mirrored on the device: not work
    host = [("bench.traced", 0, 1000), ("bench.round", 0, 1000), ("aten::copy_", 300, 500)]
    tr = trace.summarize(_events(dev, host), enter_ns=0)
    assert tr["busy_s"] == pytest.approx(300e-9)
    assert tr["window_s"] == pytest.approx(1000e-9)
    assert tr["k1_calls"] == 1 and tr["k1_s"] == pytest.approx(100e-9)
    assert tr["device_ops"][0] == ["gemm", pytest.approx(250e-9)]
    names = dict((round(s * 1e9), n) for n, s in tr["idle_gaps"])
    assert names[400] == "bench.round / no PyTorch operation"
    assert names[200] == "bench.round / aten::copy_"
    rec = Record(trace=tr)
    assert readers.device_idle(rec) == pytest.approx(70.0)


def test_k1_roofline_pairs_each_kernel_with_its_call():
    # two calls, 1 ms apart; each kernel starts after its call
    b, d = (32, 64, 48), (32, 6, 524288)
    calls = [(1_000_000, b, d), (2_000_000, b, d)]
    kernels = [(1_050_000, 1_250_000), (2_040_000, 2_240_000)]
    rec = Record(trace={"k1_kernels": kernels, "clock_offset_ns": 0}, extra={"k1_calls": calls})
    bound = yardstick.k1_bound_s(*b, d[2])
    assert readers.k1_roofline(rec) == pytest.approx(100.0 * 2 * bound / 400e-6)
    # the PR 15 design figure: 0.0701 ms at this shape, bound by bytes
    assert bound * 1e3 == pytest.approx(0.0701, abs=5e-5)
    rec.extra["k1_calls"] = []
    assert readers.k1_roofline(rec) is None


def test_hybrid_flops_against_the_planners_count():
    # PR 23's meta count of zamba2-2.7b's prefill, 32 x 1,024: 2.503e14
    model = json.load(open(spec.ROOT / "tofec_bench/configs/zamba2-2.7b.json"))["model"]
    assert yardstick.hybrid_flops(model, 32, 1024, 1) == pytest.approx(2.503e14, rel=0.02)
    one = yardstick.hybrid_flops(model, 1, 1024, 32)
    assert yardstick.hybrid_flops(model, 32, 1024, 32) == pytest.approx(32 * one)
    assert one > yardstick.hybrid_flops(model, 1, 1024, 1)


def test_checks():
    assert Check("x", 0, 0).holds and not Check("x", 1, 0).holds
    assert Check("y", 3, 1, at_least=True).holds and not Check("y", 0, 1, at_least=True).holds
    assert Check("z", 0.5, 1.0).line().endswith("ok")
