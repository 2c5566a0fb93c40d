"""The Nemotron-H cell at CPU size (its configuration cut to the port's smoke
shapes, its traffic to rounds of 4 prompts of 12 tokens): a traced run is
correct and its per-layer metrics read the program's records; the FLOPs
and the grouped expert product's work against closed forms."""

import json
import time

import pytest
import torch

from tofec_bench.harness import nemotron_flops, nemotron_readers, spec, yardstick
from tofec_bench.harness.record import Record
from tofec_bench.tests.test_bench_reference_nemotron import SMOKE_MODEL

CELL = "nemotron3-decode-batch"


def _cut(root):
    path = root / "tofec_bench/configs/nemotron3-nano-30b-a3b.json"
    cfg = json.loads(path.read_text())
    cfg["model"].update(SMOKE_MODEL)
    path.write_text(json.dumps(cfg))
    path = root / "tofec_bench/traffic/decode-batch-64x512.json"
    tr = json.loads(path.read_text())
    tr.update(prompt_tokens=12, gen_tokens=6, round=4, trace_from=1)
    path.write_text(json.dumps(tr))
    return spec.load_cell(CELL, root)


def test_a_traced_cpu_run_is_correct_and_reads_its_metrics(small):
    cell = _cut(small)
    rec = spec.driver(cell).run(cell, seed=2**31 + 17, seconds=10.0, traced=True,
                                device=torch.device("cpu"), process_start=time.monotonic())
    assert all(c.holds for c in rec.checks), [c.line() for c in rec.checks]
    ph = rec.rounds[0]["phase_ms"]
    assert {"launch.mamba", "launch.moe", "launch.attn"} <= set(ph)
    got = {m["name"]: spec.metric_reader(cell, m["name"])(rec) for m in cell.per_layer}
    assert 0 < got["prefill_moe_share.nemo"] < 100
    assert got["expert_load_peak.nemo"] >= 1.0
    assert got["decode_graph_share.nemo"] == 0.0  # the CPU decodes eagerly
    assert got["mfu.nemo"] > 0 and got["decode_step_ms.nemo"] > 0
    assert got["moe_gemm_roofline.nemo"] is None  # no device kernels on the CPU
    want = {m["name"] for m in cell.per_layer}
    assert want == {"decode_step_ms.nemo", "decode_graph_share.nemo", "prefill_moe_share.nemo",
                    "expert_load_peak.nemo", "moe_gemm_roofline.nemo", "mfu.nemo",
                    "device_idle.nemo"}


def test_readers_find_nothing_in_a_program_without_the_records():
    rec = Record(config={"model": {"n_experts": 32}}, t0=0.0, t1=1.0)
    rec.rounds = [{"phase_ms": {"fetch": 1.0, "launch": 2.0, "generate": 3.0},
                   "after_profiler": False}]
    assert nemotron_readers.prefill_moe_share(rec) is None
    assert nemotron_readers.expert_load_peak(rec) is None
    assert nemotron_readers.moe_gemm_roofline(rec) is None


MODEL = json.loads((spec.ROOT / "tofec_bench/configs/nemotron3-nano-30b-a3b.json").read_text())[
    "model"]


def test_expert_work_and_bound():
    d, f = 2688, 1856
    ops, nbytes = nemotron_flops.expert_counts(MODEL, held_pairs=384, experts_hit=32)
    assert ops == 384 * 4 * d * f
    assert nbytes == 32 * 2 * d * f * 2 + 384 * 2 * (d + f) * 2
    # a decode step's call is bound by the weights' bytes, a prefill's by the products
    assert nemotron_flops.expert_bound_s(MODEL, 384, 32) == pytest.approx(
        nbytes / yardstick.PEAK_HBM_BYTES)
    ops, _ = nemotron_flops.expert_counts(MODEL, 49152, 32)
    assert nemotron_flops.expert_bound_s(MODEL, 49152, 32) == pytest.approx(
        ops / yardstick.PEAK_BF16_FLOPS)


def test_round_flops_count_the_routed_experts_at_the_held_share():
    d, f, K, n_e, V = 2688, 1856, 6, 23, 131072
    assert nemotron_flops.held_share(MODEL) == 0.25
    one = nemotron_flops.round_flops(MODEL, 1, 512, 128, 0.25)
    assert nemotron_flops.round_flops(MODEL, 64, 512, 128, 0.25) == pytest.approx(64 * one)
    tokens = 512 + 127
    routed = nemotron_flops.round_flops(MODEL, 1, 512, 128, 0.5) - one
    assert routed == pytest.approx(tokens * n_e * 0.25 * K * 4 * d * f)
    # the head at the prefill's last position and at each decode step
    no_steps = nemotron_flops.round_flops(MODEL, 1, 512, 1, 0.25)
    assert one - no_steps > 127 * 2 * d * V
