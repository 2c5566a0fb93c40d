"""On-device reductions: sweep outputs → throughput-delay frontiers.

The port of the reference package's ``repro/fleet/frontier.py``. Consumes a
:class:`repro_torch.fleet.sweep.SweepResult` (stacked device tensors)
and produces the paper's evaluation quantities without a per-point host
loop: mean and p50/p95/p99 total delay, mean chosen (n, k), mean thread
usage U(n, k) and the capacity estimate L/Ū it implies, per-policy
throughput-delay frontiers, adaptation-convergence statistics, the
TOFEC-vs-static headline ratios (Fig.7/8: ~2.5× lower light-load delay than
the throughput-optimal basic code, ~3× the capacity of the latency-optimal
static code), and the ``BENCH_fleet.json`` artifact feeding the bench
trajectory.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch import obs
from repro_torch.fleet import stats


@dataclasses.dataclass
class FrontierPoint:
    """Reduced statistics for one grid point."""

    policy: str
    lam: float
    seed: int
    cls_name: str
    mean: float
    p50: float
    p90: float
    p95: float
    p99: float
    std: float
    mean_queueing: float
    mean_k: float
    mean_n: float
    mean_usage: float
    util: float          # offered utilization λ·Ū/L of the chosen code mix
    capacity_est: float  # L/Ū: the rate at which this code mix saturates

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _reduced(result, warmup_frac: float):
    """Per-row statistics of a result: the streamed carry, or the shared
    block reduction of :mod:`repro_torch.fleet.stats` over the materialized
    block on its device (the same reduction the streaming fold runs, which
    is what makes the two bit-exact equals)."""
    streamed = getattr(result, "streamed", None)
    if streamed is not None:
        return streamed.require(warmup_frac)
    par = stats.class_params(result.cfg, result.out["total"].device)
    red = stats.frontier_block_reduce(result.out, *par, w=int(result.count * warmup_frac))
    return {k: v.cpu().numpy() for k, v in red.items()}


def frontier_points(result, warmup_frac: float = 0.05) -> list[FrontierPoint]:
    """Per-grid-point statistics, reduced on the result's device."""
    red = _reduced(result, warmup_frac)
    points = []
    for i, case in enumerate(result.cases):
        usage = float(red["mean_usage"][i])
        points.append(FrontierPoint(
            policy=case.policy.name,
            lam=case.lam,
            seed=case.seed,
            cls_name=case.cls.name,
            mean=float(red["mean"][i]),
            p50=float(red["p50"][i]),
            p90=float(red["p90"][i]),
            p95=float(red["p95"][i]),
            p99=float(red["p99"][i]),
            std=float(red["std"][i]),
            mean_queueing=float(red["mean_queueing"][i]),
            mean_k=float(red["mean_k"][i]),
            mean_n=float(red["mean_n"][i]),
            mean_usage=usage,
            util=case.lam * usage / case.L,
            capacity_est=case.L / usage,
        ))
    return points


def frontier(points: list[FrontierPoint]) -> dict[str, list[FrontierPoint]]:
    """Group by policy, λ-sorted: the Fig.1/Fig.7 delay-vs-rate curves."""
    by: dict[str, list[FrontierPoint]] = {}
    for pt in points:
        by.setdefault(pt.policy, []).append(pt)
    for pts in by.values():
        pts.sort(key=lambda p: (p.lam, p.seed))
    return by


def capacity_estimates(points: list[FrontierPoint], *, util_cap: float = 0.98) -> dict[str, float]:
    """Per-policy supportable-rate estimate.

    For each policy, take the highest-λ grid point still stable
    (util < util_cap) and report the L/Ū its chosen code mix implies —
    static codes give their constant L/U, adaptive policies the capacity of
    the codes they degrade to under load (basic-like, per Corollary 1).
    Falls back to the minimum L/Ū over the grid when no point is stable.
    """
    caps: dict[str, float] = {}
    for name, pts in frontier(points).items():
        stable = [p for p in pts if p.util < util_cap]
        caps[name] = stable[-1].capacity_est if stable else min(p.capacity_est for p in pts)
    return caps


def convergence_stats(result, warmup_frac: float = 0.05) -> list[dict]:
    """Adaptation convergence per grid point: how fast k settles.

    ``settle_frac``: fraction of the (post-warmup) horizon after which the
    chosen k never leaves ±1 of its final mode; ``modal_frac``: fraction of
    requests served exactly at the modal k. Static policies settle at 0.

    Streamed results read the convergence integers the per-chunk fold
    accumulated (:func:`repro_torch.fleet.stats.convergence_reduce`) and finish
    the exact fractions here — identical values, no (G, T) block.
    """
    w = int(result.count * warmup_frac)
    horizon = max(result.count - w, 1)
    streamed = getattr(result, "streamed", None)
    if streamed is not None:
        red = streamed.require(warmup_frac)
        return [
            {
                "policy": case.policy.name,
                "lam": case.lam,
                "seed": case.seed,
                "modal_k": int(red["modal_k"][i]),
                "modal_frac": int(red["modal_count"][i]) / horizon,
                "settle_frac": int(red["settle_idx"][i]) / horizon,
            }
            for i, case in enumerate(result.cases)
        ]
    ks = result.out["k"].cpu().numpy()
    out = []
    for i, case in enumerate(result.cases):
        k_i = ks[i, w:]
        modal = int(np.bincount(k_i).argmax())
        off = np.abs(k_i.astype(np.int64) - modal) > 1
        settle_idx = int(np.max(np.nonzero(off)[0])) + 1 if off.any() else 0
        out.append({
            "policy": case.policy.name,
            "lam": case.lam,
            "seed": case.seed,
            "modal_k": modal,
            "modal_frac": float((k_i == modal).mean()),
            "settle_frac": settle_idx / max(len(k_i), 1),
        })
    return out


def headline_ratios(points: list[FrontierPoint]) -> dict:
    """The paper's two headline comparisons, computed from the frontier.

    * ``delay_gain_vs_basic`` — mean-delay ratio of the throughput-optimal
      static code (basic (1,1)) over TOFEC at the lightest common λ
      (paper: ~2.5×).
    * ``capacity_gain_vs_latency_optimal`` — TOFEC's capacity estimate over
      that of the latency-optimal static code (the static policy with the
      lowest light-load mean delay; paper: ~3×).
    """
    by = frontier(points)
    out: dict = {}
    caps = capacity_estimates(points)
    tofec = by.get("tofec")
    basic = by.get("static(1,1)")
    if tofec and basic:
        lam0 = min(p.lam for p in tofec)
        t0 = next(p for p in tofec if p.lam == lam0)
        b0 = min((p for p in basic), key=lambda p: abs(p.lam - lam0))
        out["light_lam"] = lam0
        out["tofec_light_mean"] = t0.mean
        out["basic_light_mean"] = b0.mean
        out["delay_gain_vs_basic"] = b0.mean / t0.mean
    statics = {n: pts for n, pts in by.items() if n.startswith("static(") and n != "static(1,1)"}
    if tofec and statics:
        # Latency-optimal static: best mean at the lightest λ.
        lam0 = min(p.lam for p in tofec)
        best_name = min(
            statics,
            key=lambda n: min(p.mean for p in statics[n] if p.lam <= lam0 * 1.5 + 1e-9),
        )
        out["latency_optimal_static"] = best_name
        out["capacity_tofec"] = caps.get("tofec")
        out["capacity_latency_optimal"] = caps.get(best_name)
        if caps.get(best_name):
            out["capacity_gain_vs_latency_optimal"] = caps["tofec"] / caps[best_name]
    return out


def write_fleet_artifact(
    path: str,
    result,
    *,
    warmup_frac: float = 0.05,
    extra: dict | None = None,
    points: list[FrontierPoint] | None = None,
) -> dict:
    """Reduce a sweep and write the ``BENCH_fleet.json`` artifact.

    Returns the artifact dict (also written to ``path``): grid metadata,
    per-point frontier stats, per-policy capacities, convergence stats and
    the headline TOFEC-vs-static ratios. Pass ``points`` to reuse an
    already-computed :func:`frontier_points` reduction.
    """
    if points is None:
        points = frontier_points(result, warmup_frac)
    artifact = {
        "schema": "repro.fleet/BENCH_fleet/v1",
        "meta": obs.run_meta(mesh_shape=getattr(result, "mesh_shape", ())),
        "grid_size": len(result.cases),
        "count": result.count,
        "compiles": result.compiles,
        "launches": result.launches,
        "points": [p.to_dict() for p in points],
        "capacity_req_s": capacity_estimates(points),
        "convergence": convergence_stats(result, warmup_frac),
        "headline": headline_ratios(points),
    }
    if extra:
        artifact.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return artifact
