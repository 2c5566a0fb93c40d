"""The readers of the DeepSeek-V3 cell's per-layer metrics.

They read the program's own records: the rounds' ``phase_ms`` (the
prefill's device ms by layer kind, ``launch.mla``, ``launch.mlp`` and
``launch.moe``) and, in a traced run, the ``serve.launch`` and
``serve.generate`` spans, tagged with the expert layers' counts of the
prefill and of the decode steps, and the generate span with its device ms
and its steps. Each returns None where the program recorded none of these:
a run not traced, or a program without them.
"""

from __future__ import annotations

from tofec_bench.harness import deepseek_flops, yardstick
from tofec_bench.harness.nemotron_readers import _counted
from tofec_bench.harness.readers import _rounds
from tofec_bench.harness.record import Record

KINDS = ("mla", "mlp", "moe")


def prefill_mla_share(rec: Record):
    """Latent attention's share of the prefill's device time by layer kind,
    over the unprofiled rounds, in %."""
    rs = [r for r in _rounds(rec) if "launch.mla" in r["phase_ms"]]
    if not rs:
        return None
    total = sum(r["phase_ms"].get(f"launch.{k}", 0.0) for r in rs for k in KINDS)
    return 100.0 * sum(r["phase_ms"]["launch.mla"] for r in rs) / total if total else None


def decode_roofline(rec: Record):
    """Σ bound / Σ device time of the profiled rounds' decode steps, in %:
    each round's ``serve.generate`` span (its ``device_ms``, its steps and
    its expert counts) against :func:`deepseek_flops.decode_bound_s` at the
    round's padded rows and prompt."""
    model = rec.config.get("model", {})
    bound = busy = 0.0
    for r, t in zip([r for r in rec.rounds if r["traced"]], _counted(rec, "serve.generate")):
        steps = t.get("graph_replays", 0) + t.get("eager_steps", 0)
        if not steps or "device_ms" not in t:
            continue
        bound += deepseek_flops.decode_bound_s(model, r["padded"], r["prompt"], steps,
                                               t["held_pairs"], t["held_experts_hit"])
        busy += t["device_ms"] / 1e3
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None


def moe_gemm_roofline(rec: Record):
    """Σ bound / Σ device time of the grouped expert product's kernels in
    the profiled rounds, in %: each phase's (prefill, decode) bound from its
    counts (:func:`deepseek_flops.expert_bound_s`, three products a pair)
    against its kernels' time, ``grouped_gemm_s`` in the traced summary
    (the cell's driver, ``drivers/closed_loop_ops.py``). None unless every
    phase that counted pairs has kernel time: a bound without its time
    would read high."""
    busy_by_phase = (rec.trace or {}).get("grouped_gemm_s")
    if not busy_by_phase:
        return None
    model = rec.config["model"]
    bound = busy = 0.0
    for phase in ("launch", "generate"):
        b = sum(deepseek_flops.expert_bound_s(model, t["held_pairs"], t["held_experts_hit"])
                for t in _counted(rec, f"serve.{phase}"))
        if b > 0:
            if not busy_by_phase.get(phase, 0.0) > 0:
                return None
            bound += b
            busy += busy_by_phase[phase]
    return 100.0 * bound / busy if busy > 0 else None


def mfu(rec: Record):
    """Model FLOPs of the rows the unprofiled rounds served over their wall
    time at the bfloat16 peak, in %: the routed experts' work at the held
    share of the pairs the program counted in the traced rounds, or at held
    experts over the router's width where it counted none."""
    rs = _rounds(rec)
    if not rs:
        return None
    model = rec.config["model"]
    tags = _counted(rec, "serve.launch") + _counted(rec, "serve.generate")
    routed = sum(t["routed_pairs"] for t in tags)
    share = (sum(t["held_pairs"] for t in tags) / routed if routed
             else deepseek_flops.held_share(model))
    flops = sum(deepseek_flops.round_flops(model, r["rows"], r["prompt"], r["steps"], share)
                for r in rs)
    wall = sum(r["end"] - r["start"] for r in rs)
    return 100.0 * flops / (wall * yardstick.PEAK_BF16_FLOPS)
