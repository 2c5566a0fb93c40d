"""Per-class reductions for joint shared-pool sweeps, on the device.

The port of the reference package's ``repro/sched/frontier.py``. Consumes a
:class:`repro_torch.sched.sweep.SchedResult` and produces the §IV-style
multi-class quantities the fluid split cannot: per-class delay percentiles
under cross-class interference, per-class chosen-code mixes, the Jain
fairness index of per-class mean delay, and the ``BENCH_multiclass.json``
artifact. Class membership is a mask (``cls_ids``), so one reduction covers
the whole (G, T) block: per-class percentiles go through the fleet's
:func:`repro_torch.fleet.stats.masked_percentiles` (class-masked sort +
gather — lower-interpolation percentiles, exact for the class sample), and
every float sum runs over fixed blocks of rows
(:func:`repro_torch.fleet.stats.reduce_row_blocks`), so a streamed run
equals a materialized one bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import obs
from repro_torch.fleet.stats import masked_percentiles, reduce_row_blocks

_QS = (50.0, 90.0, 95.0, 99.0)


def jain_index(xs) -> float:
    """Jain's fairness index (Σx)²/(m·Σx²) ∈ (0, 1]; 1 = perfectly equal."""
    xs = np.asarray([x for x in xs], dtype=np.float64)
    if xs.size == 0:
        return 1.0
    denom = xs.size * np.sum(xs * xs)
    return float(np.sum(xs) ** 2 / denom) if denom > 0 else 1.0


def _class_block(blk: dict, C: int, w: int) -> dict[str, torch.Tensor]:
    tot = blk["total"][:, w:]
    dq = blk["queueing"][:, w:]
    nf = blk["n"][:, w:].to(torch.float32)
    kf = blk["k"][:, w:].to(torch.float32)
    ids = blk["cls_ids"][:, w:]

    def one_class(c):
        mask = ids == c
        cnt = mask.sum(1, dtype=torch.int32)
        safe = torch.clamp_min(cnt, 1).to(torch.float32)

        def masked_mean(x):
            # A class with no post-warmup arrivals has no statistics: NaN,
            # matching masked_percentiles — not a silent 0.0.
            return torch.where(cnt > 0, torch.where(mask, x, 0.0).sum(1) / safe, torch.nan)

        pct = masked_percentiles(tot, _QS, mask)  # (rows, 4)
        return {
            "count": cnt,
            "mean": masked_mean(tot),
            "p50": pct[:, 0], "p90": pct[:, 1], "p95": pct[:, 2], "p99": pct[:, 3],
            "mean_queueing": masked_mean(dq),
            "mean_k": masked_mean(kf),
            "mean_n": masked_mean(nf),
        }

    per = [one_class(c) for c in range(C)]
    red = {name: torch.stack([p[name] for p in per], dim=1) for name in per[0]}  # (rows, C)
    red["agg_mean"] = tot.mean(1)
    # Lower interpolation, like the per-class percentiles.
    red["agg_p99"] = masked_percentiles(tot, [99.0])[:, 0]
    return red


def _reduce_multiclass(out: dict, *, C: int, w: int, first: int = 0) -> dict[str, torch.Tensor]:
    """Per-class statistics of a (rows, T) result block (``total``,
    ``queueing``, ``n``, ``k`` and ``cls_ids``), on its device; ``w`` is the
    warmup cut and ``first`` the grid index of the block's first row."""
    rows = {name: out[name] for name in ("total", "queueing", "n", "k", "cls_ids")}
    return reduce_row_blocks(lambda blk: _class_block(blk, C, w), rows, first=first)


@dataclasses.dataclass
class MulticlassPoint:
    """Reduced statistics for one joint grid point: aggregate + per class."""

    discipline: str
    lam: float  # aggregate arrival rate of the mix
    seed: int
    mix_name: str
    L: int
    agg_mean: float
    agg_p99: float
    jain_delay: float  # Jain index of per-class mean delays
    classes: list[dict]  # per-class: name, lam, weight, mean, p50..p99, ...

    def cls(self, name: str) -> dict:
        return next(c for c in self.classes if c["name"] == name)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def multiclass_points(result, warmup_frac: float = 0.05) -> list[MulticlassPoint]:
    """Per-grid-point aggregate + per-class statistics, reduced on the
    result's device.

    Streamed results (``SchedSweep.run(..., stream=...)``) reuse the
    statistics the per-chunk fold already accumulated — same values, no
    materialized (G, T) block."""
    streamed = getattr(result, "streamed", None)
    if streamed is not None:
        red = streamed.require(warmup_frac)
    else:
        C = max(len(case.mix.classes) for case in result.cases)
        red = _reduce_multiclass(result.out, C=C, w=int(result.count * warmup_frac))
        red = {k: v.cpu().numpy() for k, v in red.items()}
    points = []
    for i, case in enumerate(result.cases):
        classes = []
        for c, (cls, wt) in enumerate(zip(case.mix.classes, case.mix.weights)):
            classes.append({
                "name": cls.name,
                "lam": case.mix.lam * wt,
                "weight": wt,
                "count": int(red["count"][i, c]),
                "mean": float(red["mean"][i, c]),
                "p50": float(red["p50"][i, c]),
                "p90": float(red["p90"][i, c]),
                "p95": float(red["p95"][i, c]),
                "p99": float(red["p99"][i, c]),
                "mean_queueing": float(red["mean_queueing"][i, c]),
                "mean_k": float(red["mean_k"][i, c]),
                "mean_n": float(red["mean_n"][i, c]),
            })
        points.append(MulticlassPoint(
            discipline=case.discipline.name,
            lam=case.mix.lam,
            seed=case.seed,
            mix_name="+".join(c.name for c in case.mix.classes),
            L=case.L,
            agg_mean=float(red["agg_mean"][i]),
            agg_p99=float(red["agg_p99"][i]),
            jain_delay=jain_index([c["mean"] for c in classes if c["count"] > 0]),
            classes=classes,
        ))
    return points


def by_discipline(points: list[MulticlassPoint]) -> dict[str, list[MulticlassPoint]]:
    """Group by discipline, λ-sorted: per-class delay-vs-rate curves."""
    by: dict[str, list[MulticlassPoint]] = {}
    for pt in points:
        by.setdefault(pt.discipline, []).append(pt)
    for pts in by.values():
        pts.sort(key=lambda p: (p.lam, p.seed))
    return by


def interference_summary(
    joint: list[MulticlassPoint], split_p99: dict[str, float] | None = None
) -> dict:
    """Cross-class interference headline at the highest common λ.

    For each discipline at max λ: the spread of per-class p99 (max/min) and
    the Jain index. When ``split_p99`` (class name → the Poisson-split
    fleet's p99 prediction) is given, also reports per-class joint/split p99
    ratios — the quantity the fluid split gets wrong (≈1 for the
    high-priority class, ≫1 for the starved one).
    """
    out: dict = {}
    for name, pts in by_discipline(joint).items():
        p = pts[-1]
        p99s = [c["p99"] for c in p.classes if c["count"] > 0]
        entry = {
            "lam": p.lam,
            "jain_delay": p.jain_delay,
            "p99_spread": max(p99s) / max(min(p99s), 1e-12),
        }
        if split_p99:
            entry["p99_vs_split"] = {
                c["name"]: c["p99"] / split_p99[c["name"]]
                for c in p.classes
                if c["name"] in split_p99 and c["count"] > 0
            }
        out[name] = entry
    return out


def write_multiclass_artifact(
    path: str,
    result,
    *,
    warmup_frac: float = 0.05,
    extra: dict | None = None,
    points: list[MulticlassPoint] | None = None,
) -> dict:
    """Reduce a joint sweep and write the ``BENCH_multiclass.json`` artifact."""
    if points is None:
        points = multiclass_points(result, warmup_frac)
    artifact = {
        "schema": "repro.sched/BENCH_multiclass/v1",
        "meta": obs.run_meta(mesh_shape=getattr(result, "mesh_shape", ())),
        "grid_size": len(result.cases),
        "count": result.count,
        "compiles": result.compiles,
        "launches": result.launches,
        "points": [p.to_dict() for p in points],
        "interference": interference_summary(points),
    }
    if extra:
        artifact.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return artifact
