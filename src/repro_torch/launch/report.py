"""Render the launch plan's roofline tables from the dry-run records.

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--dir build/dryrun_torch]

The port of the reference package's ``repro/launch/report.py``: the same
tables, on the H100 constants of :mod:`repro_torch.launch.roofline`. Prints
markdown.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.roofline import HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS

DEFAULT_DIR = RESULTS_DIR

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = [
    "whisper-base", "xlstm-350m", "gemma2-2b", "mistral-nemo-12b", "yi-6b",
    "qwen1.5-0.5b", "pixtral-12b", "grok-1-314b", "mixtral-8x7b", "zamba2-2.7b",
]


def load(dirpath: str) -> list[dict]:
    recs = []
    for name in sorted(os.listdir(dirpath)):
        if name.endswith(".json"):
            try:
                with open(os.path.join(dirpath, name)) as f:
                    recs.append(json.load(f))
            except json.JSONDecodeError:
                continue  # sweep mid-write
    return recs


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}µs"


def fmt_b(x) -> str:
    if x is None:
        return "—"
    for unit, div in [("GB", 2**30), ("MB", 2**20)]:
        if x >= div:
            return f"{x / div:.1f}{unit}"
    return f"{x}B"


def _mem(rec: dict) -> tuple:
    m = rec.get("memory", {})
    return m.get("argument_size_b"), m.get("temp_size_b"), m.get("peak_b")


def roofline_table(recs: list[dict], mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | dominant | "
        "useful/counted flops | args/dev | temp/dev | fits | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            rec = next(
                (r for r in recs if r["arch"] == arch and r["shape"] == shape
                 and r["mesh"] == mesh), None)
            if rec is None:
                continue
            if rec["status"] in ("skipped", "error"):
                word = "SKIP" if rec["status"] == "skipped" else "ERROR"
                lines.append(f"| {arch} | {shape} | — | — | — | {word} | — | — | — | — | — |")
                continue
            r = rec["roofline"]
            tc, tm, tl = r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]
            bound = max(tc, tm, tl)
            frac = tc / bound if bound > 0 else 0.0
            ratio = rec.get("useful_flops_ratio")
            arg, temp, _ = _mem(rec)
            lines.append(
                f"| {arch} | {shape} | {fmt_s(tc)} | {fmt_s(tm)} | {fmt_s(tl)} "
                f"| {r['dominant']} | {'—' if ratio is None else f'{ratio:.2f}'} "
                f"| {fmt_b(arg)} | {fmt_b(temp)} | {'yes' if rec.get('fits') else 'NO'} "
                f"| {frac:.2f} |")
    return "\n".join(lines)


def summary_stats(recs: list[dict]) -> str:
    recs = [r for r in recs if not r.get("optimized")]
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skipped"]
    err = [r for r in recs if r["status"] == "error"]
    by_dom = {}
    for r in ok:
        by_dom.setdefault(r["roofline"]["dominant"], []).append(r)
    lines = [
        f"cells: {len(ok)} ok, {len(skip)} skipped (documented), {len(err)} errors",
        "dominant-term histogram: " + ", ".join(f"{k}={len(v)}" for k, v in sorted(by_dom.items())),
        f"constants (NVIDIA H100 SXM data sheet): {PEAK_FLOPS / 1e12:.1f} TFLOP/s bf16 dense, "
        f"{HBM_BW / 1e9:.0f} GB/s HBM3; links {NVLINK_BW / 1e9:.0f} GB/s NVLink 4 per "
        f"direction (axes of <= 8 GPUs, one node), {IB_BW / 1e9:.0f} GB/s 400 Gb/s "
        "InfiniBand per GPU (wider axes); collectives modelled, not measured",
    ]
    return "\n".join(lines)


def render(recs: list[dict]) -> str:
    out = ["## Dry-run / roofline summary (H100)\n", summary_stats(recs),
           "\n### Single-pod (16×16 = 256 H100s) roofline, per cell\n",
           roofline_table(recs, "16x16")]
    opt = [r for r in recs if r.get("optimized") and r["status"] == "ok"]
    if opt:
        out.append("\n### Optimized cells (--opt: weight_gather, cache re-shard, microbatching)\n")
        for r in opt:
            ro = r["roofline"]
            arg, temp, _ = _mem(r)
            out.append(f"* {r['arch']} × {r['shape']} × {r['mesh']}: "
                       f"t_comp={fmt_s(ro['t_compute_s'])} t_mem={fmt_s(ro['t_memory_s'])} "
                       f"t_coll={fmt_s(ro['t_collective_s'])} args/dev={fmt_b(arg)} "
                       f"temp/dev={fmt_b(temp)}")
    out.append("\n### Multi-pod (2×16×16 = 512 H100s) — plan proof\n")
    recs_m = [r for r in recs if r["mesh"] == "2x16x16" and not r.get("optimized")]
    ok = sum(1 for r in recs_m if r["status"] == "ok")
    sk = sum(1 for r in recs_m if r["status"] == "skipped")
    er = [r for r in recs_m if r["status"] == "error"]
    out.append(f"{ok} cells plan on the multi-pod mesh, {sk} documented skips, "
               f"{len(er)} errors{': ' + ', '.join(r['arch'] + '×' + r['shape'] for r in er) if er else ''}.")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_DIR)
    args = ap.parse_args(argv)
    print(render(load(args.dir)))


if __name__ == "__main__":
    main()
