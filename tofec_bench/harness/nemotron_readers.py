"""The readers of the Nemotron-H cell's per-layer metrics.

They read the program's own records: the rounds' ``phase_ms`` (the
prefill's device ms by layer kind, ``launch.mamba``, ``launch.moe`` and
``launch.attn``) and, in a traced run, the ``serve.launch`` and
``serve.generate`` spans, tagged with the expert layers' counts
(``routed_pairs``, ``held_pairs``, ``held_experts_hit``,
``peak_expert_pairs``, ``layer_steps``) of the prefill and of the decode
steps. Each returns None where the program recorded none of these: a run
not traced, or a program without them.
"""

from __future__ import annotations

from tofec_bench.harness import nemotron_flops, yardstick
from tofec_bench.harness.readers import _rounds
from tofec_bench.harness.record import Record

#: name parts of the grouped expert product's device kernels
#: (``torch._grouped_mm`` on the card)
GROUPED_GEMM_KERNELS = ("GroupProblemShape", "grouped_gemm", "prepare_grouped_gemm")
KINDS = ("mamba", "moe", "attn")


def _counted(rec: Record, name: str) -> list[dict]:
    """The tags of the window's ``name`` spans that carry the expert counts."""
    from repro_torch import obs

    between = getattr(obs.get_tracer(), "events_between", None)
    if between is None or rec.t1 <= rec.t0:
        return []
    return [e["args"] for e in between(rec.t0, rec.t1)
            if e["name"] == name and "held_pairs" in e["args"]]


def prefill_moe_share(rec: Record):
    """The expert layers' share of the prefill's device time by layer kind,
    over the unprofiled rounds, in %."""
    rs = [r for r in _rounds(rec) if "launch.moe" in r["phase_ms"]]
    if not rs:
        return None
    total = sum(r["phase_ms"][f"launch.{k}"] for r in rs for k in KINDS)
    return 100.0 * sum(r["phase_ms"]["launch.moe"] for r in rs) / total if total else None


def expert_load_peak(rec: Record):
    """The most loaded held expert's pairs over the mean held expert's, over
    the window's traced decode steps and layers."""
    tags = _counted(rec, "serve.generate")
    held = sum(t["held_pairs"] for t in tags)
    if not held:
        return None
    return rec.config["model"]["n_experts"] * sum(t["peak_expert_pairs"] for t in tags) / held


def moe_gemm_roofline(rec: Record):
    """Σ bound / Σ device time of the grouped expert product's kernels in
    the profiled rounds, in %: the bound of each phase (prefill, decode)
    from its counts (:func:`nemotron_flops.expert_bound_s`), the time from
    the profile's operations whose names hold one of
    :data:`GROUPED_GEMM_KERNELS`."""
    if not rec.trace:
        return None
    busy = sum(t for name, t in rec.trace["device_ops"]
               if any(k in name for k in GROUPED_GEMM_KERNELS))
    model = rec.config["model"]
    tags = _counted(rec, "serve.launch") + _counted(rec, "serve.generate")
    bound = sum(nemotron_flops.expert_bound_s(model, t["held_pairs"], t["held_experts_hit"])
                for t in tags)
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None


def mfu(rec: Record):
    """Model FLOPs of the rows the unprofiled rounds served over their wall
    time at the bfloat16 peak, in %: the routed experts' work at the held
    share of the pairs the program counted in the traced rounds, or at
    held experts over the router's width where it counted none."""
    rs = _rounds(rec)
    if not rs:
        return None
    model = rec.config["model"]
    tags = _counted(rec, "serve.launch") + _counted(rec, "serve.generate")
    routed = sum(t["routed_pairs"] for t in tags)
    share = (sum(t["held_pairs"] for t in tags) / routed if routed
             else nemotron_flops.held_share(model))
    flops = sum(nemotron_flops.round_flops(model, r["rows"], r["prompt"], r["steps"], share)
                for r in rs)
    wall = sum(r["end"] - r["start"] for r in rs)
    return 100.0 * flops / (wall * yardstick.PEAK_BF16_FLOPS)
