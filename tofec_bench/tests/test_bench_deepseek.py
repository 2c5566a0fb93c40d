"""The DeepSeek-V3 cell at CPU size (its configuration cut to the port's smoke
shapes, its traffic to rounds of 4 prompts of 12 tokens): a traced run is
correct and its per-layer metrics read the program's records; the FLOPs,
bytes and bounds against closed forms."""

import json
import time

import pytest
import torch

from tofec_bench.harness import deepseek_flops, deepseek_readers, spec, yardstick
from tofec_bench.harness.record import Record
from tofec_bench.tests.test_bench_reference_deepseek import SMOKE_MODEL

CELL = "deepseek3-mla-batch"


def _cut(root):
    path = root / "tofec_bench/configs/deepseek-v3.json"
    cfg = json.loads(path.read_text())
    cfg["model"].update(SMOKE_MODEL)
    path.write_text(json.dumps(cfg))
    path = root / "tofec_bench/traffic/long-batch-32x4096.json"
    tr = json.loads(path.read_text())
    tr.update(prompt_tokens=12, gen_tokens=6, round=4, trace_from=1)
    path.write_text(json.dumps(tr))
    return spec.load_cell(CELL, root)


def test_a_traced_cpu_run_is_correct_and_reads_its_metrics(small):
    cell = _cut(small)
    rec = spec.driver(cell).run(cell, seed=2**31 + 23, seconds=10.0, traced=True,
                                device=torch.device("cpu"), process_start=time.monotonic())
    assert all(c.holds for c in rec.checks), [c.line() for c in rec.checks]
    ph = rec.rounds[0]["phase_ms"]
    assert {"launch.mla", "launch.mlp", "launch.moe"} <= set(ph)
    got = {m["name"]: spec.metric_reader(cell, m["name"])(rec) for m in cell.per_layer}
    assert 0 < got["prefill_mla_share.dsv3"] < 100
    assert got["expert_load_peak.dsv3"] >= 1.0
    assert got["decode_graph_share.dsv3"] == 0.0  # the CPU decodes eagerly
    assert got["mfu.dsv3"] > 0 and got["decode_step_ms.dsv3"] > 0
    assert got["decode_roofline.dsv3"] > 0
    assert got["moe_gemm_roofline.dsv3"] is None  # no device kernels on the CPU
    want = {m["name"] for m in cell.per_layer}
    assert want == {"prefill_mla_share.dsv3", "decode_step_ms.dsv3", "decode_graph_share.dsv3",
                    "decode_roofline.dsv3", "expert_load_peak.dsv3", "moe_gemm_roofline.dsv3",
                    "mfu.dsv3", "device_idle.dsv3"}


def test_readers_find_nothing_in_a_program_without_the_records():
    rec = Record(config={"model": {"n_experts": 8}}, t0=0.0, t1=1.0)
    rec.rounds = [{"phase_ms": {"fetch": 1.0, "launch": 2.0, "generate": 3.0},
                   "after_profiler": False, "traced": True, "padded": 32, "prompt": 4096}]
    assert deepseek_readers.prefill_mla_share(rec) is None
    assert deepseek_readers.decode_roofline(rec) is None
    assert deepseek_readers.moe_gemm_roofline(rec) is None


MODEL = json.loads((spec.ROOT / "tofec_bench/configs/deepseek-v3.json").read_text())["model"]
D, F, V, L = 7168, 2048, 129280, 16


def test_expert_work_and_bound():
    ops, nbytes = deepseek_flops.expert_counts(MODEL, held_pairs=256, experts_hit=8)
    assert ops == 256 * 6 * D * F
    assert nbytes == 8 * 3 * D * F * 2 + 256 * 3 * (D + F) * 2
    # a decode step's call is bound by the weights' bytes, a prefill's by the products
    assert deepseek_flops.expert_bound_s(MODEL, 256, 8) == pytest.approx(
        nbytes / yardstick.PEAK_HBM_BYTES)
    ops, _ = deepseek_flops.expert_counts(MODEL, 32768, 8)
    assert deepseek_flops.expert_bound_s(MODEL, 32768, 8) == pytest.approx(
        ops / yardstick.PEAK_BF16_FLOPS)


def test_weight_bytes_are_the_non_routed_parameters():
    """Every parameter of the 16-layer stage but the routed experts and the
    embedding table, bfloat16 but the float32 router and bias."""
    routed = 13 * 8 * 3 * D * F
    router = 13 * (D * 256 + 256)
    bf16 = 11_212_957_952 - routed - router - V * D
    assert deepseek_flops.weight_bytes(MODEL) == 2 * bf16 + 4 * router
    assert deepseek_flops.expert_bytes(MODEL) == 2 * 3 * D * F


def test_decode_bound_reads_the_weights_the_experts_hit_and_the_cache():
    """A step at 32 rows is bound by its bytes: the weights, 5 experts hit in
    each of 13 layers, and the latent cache up to its position."""
    one = deepseek_flops.decode_bound_s(MODEL, 32, 4096, 1, held_pairs=32 * 13 * 8 // 32,
                                        experts_hit=13 * 5)
    cache = 2 * L * 32 * 576 * (4097 + 1)
    nbytes = deepseek_flops.weight_bytes(MODEL) + 13 * 5 * 2 * 3 * D * F + 2 * 32 * D + cache
    assert one == pytest.approx(nbytes / yardstick.PEAK_HBM_BYTES)
    assert 4e-3 < one < 8e-3
    two = deepseek_flops.decode_bound_s(MODEL, 32, 4096, 2, 26, 2 * 13 * 5)
    assert two == pytest.approx(2 * one + 2 * L * 32 * 576 / yardstick.PEAK_HBM_BYTES)


def test_round_flops_count_the_routed_experts_at_the_held_share():
    K, n_e = 8, 13
    assert deepseek_flops.held_share(MODEL) == 8 / 256
    one = deepseek_flops.round_flops(MODEL, 1, 4096, 256, 1 / 32)
    assert deepseek_flops.round_flops(MODEL, 32, 4096, 256, 1 / 32) == pytest.approx(32 * one)
    tokens = 4096 + 255
    routed = deepseek_flops.round_flops(MODEL, 1, 4096, 256, 2 / 32) - one
    assert routed == pytest.approx(tokens * n_e * K / 32 * 6 * D * F)
    # the prefill alone: ~51 TFLOP a row at 4,096 tokens (1.64 PFLOP at 32 rows)
    prefill = deepseek_flops.round_flops(MODEL, 1, 4096, 1, 1 / 32)
    assert 32 * prefill == pytest.approx(1.64e15, rel=0.01)
    no_steps = deepseek_flops.round_flops(MODEL, 1, 4096, 2, 1 / 32) - prefill
    assert no_steps > 2 * D * V


def test_the_cells_driver_keeps_more_traced_operations(monkeypatch):
    """The configuration's driver is the closed-loop driver whose traced
    summary also holds the grouped expert product's device seconds by
    phase, and it leaves the harness's summary as it found it."""
    from tofec_bench.drivers import closed_loop
    from tofec_bench.harness import trace

    cell = spec.load_cell(CELL)
    driver = spec.driver(cell)
    original = trace.summarize
    monkeypatch.setattr(trace, "summarize", lambda events, enter_ns=None: {"busy_s": 1.0})
    patched = trace.summarize
    seen = []
    monkeypatch.setattr(closed_loop, "run",
                        lambda c, **kw: seen.append((c, kw, trace.summarize([_Ev("x")]))))
    driver.run(cell, seed=1, traced=True)
    assert seen == [(cell, {"seed": 1, "traced": True},
                     {"busy_s": 1.0, "grouped_gemm_s": {"launch": 0.0, "generate": 0.0}})]
    assert trace.summarize is patched and patched is not original


class _Ev:
    """A profiler event as ``trace.summarize`` reads it."""

    def __init__(self, name, start=0, end=0, corr=0, cuda=False):
        from torch.autograd import DeviceType

        self._v = (name, start, end, corr, DeviceType.CUDA if cuda else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


GROUPED = "cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>"


def test_grouped_product_time_is_split_by_the_call_that_launched_it():
    """A kernel a graph launch ran is the decode's; one a kernel launch ran,
    or whose launch the profile lacks, the prefill's; other kernels and
    time outside the traced range count nothing."""
    from tofec_bench.drivers import closed_loop_ops

    events = [_Ev("bench.traced", 1_000, 9_000),
              _Ev("cudaLaunchKernelExC", 1_100, 1_200, corr=7),
              _Ev("cudaGraphLaunch", 5_000, 5_100, corr=8),
              _Ev(GROUPED, 2_000, 2_500, corr=7, cuda=True),
              _Ev(GROUPED, 2_600, 2_700, corr=9, cuda=True),
              _Ev(GROUPED, 5_200, 5_500, corr=8, cuda=True),
              _Ev(GROUPED, 8_900, 9_400, corr=8, cuda=True),
              _Ev(GROUPED, 400, 600, corr=7, cuda=True),
              _Ev("nvjet_tst_192x192", 3_000, 4_000, corr=7, cuda=True)]
    got = closed_loop_ops.grouped_gemm_by_phase(events)
    assert got == {"launch": pytest.approx(600e-9), "generate": pytest.approx(400e-9)}
    assert closed_loop_ops.grouped_gemm_by_phase(events[1:]) == {"launch": 0.0,
                                                                 "generate": 0.0}


def test_the_grouped_roofline_reads_only_where_each_counted_phase_has_time(monkeypatch):
    tags = {"serve.launch": [{"held_pairs": 4096, "held_experts_hit": 8}],
            "serve.generate": [{"held_pairs": 300, "held_experts_hit": 6}]}
    monkeypatch.setattr(deepseek_readers, "_counted", lambda rec, name: tags[name])
    rec = Record(config={"model": MODEL}, t0=0.0, t1=1.0)
    bound = sum(deepseek_flops.expert_bound_s(MODEL, t[0]["held_pairs"],
                                              t[0]["held_experts_hit"]) for t in tags.values())
    rec.trace = {"grouped_gemm_s": {"launch": 0.02, "generate": 0.01}}
    assert deepseek_readers.moe_gemm_roofline(rec) == pytest.approx(100 * bound / 0.03)
    rec.trace = {"grouped_gemm_s": {"launch": 0.02, "generate": 0.0}}
    assert deepseek_readers.moe_gemm_roofline(rec) is None
    tags["serve.generate"] = []
    assert deepseek_readers.moe_gemm_roofline(rec) == pytest.approx(
        100 * deepseek_flops.expert_bound_s(MODEL, 4096, 8) / 0.02)
