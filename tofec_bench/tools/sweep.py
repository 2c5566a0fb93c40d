"""Find an open-loop cell's knee: run its window at several offered rates,
one after another in one process, and print what each rate sustained.

    python3 tofec_bench/tools/sweep.py --workload read3mb-poisson \\
        --rates 40,50,60,70,80 --seconds 20 --seed 11

For each rate, one JSON line: the requests offered and answered, the
answered rate over the window, the median and 95th percentile delays over
all requests and over each half of the window (by due time; a backlog that
grows through the window shows as a later half far slower than the
earlier), and the time the last answer came after the close. The knee is the
highest rate whose later half is not far slower than its earlier half and
whose answers come within a round of the close; a cell runs at four fifths
of it, written as a number into its traffic file. Lines also go to
``build/tofec_bench/sweep_<workload>.jsonl``.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def summary(rec, rate: float, seconds: float) -> dict:
    from tofec_bench.harness.record import percentile

    reqs = sorted(rec.requests, key=lambda r: r["due"])
    half = len(reqs) // 2
    lat = [(r["done"] - r["due"]) * 1e3 for r in reqs if r["done"] is not None]
    early = [(r["done"] - r["due"]) * 1e3 for r in reqs[:half] if r["done"] is not None]
    late = [(r["done"] - r["due"]) * 1e3 for r in reqs[half:] if r["done"] is not None]
    done = [r["done"] for r in reqs if r["done"] is not None]
    ks = [r["k"] for r in reqs if "k" in r]
    return {"rate_per_s": rate, "offered": len(reqs), "answered": len(done),
            "answered_per_s": sum(1 for d in done if d <= rec.t0 + seconds) / seconds,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "early_p95_ms": percentile(early, 95), "late_p95_ms": percentile(late, 95),
            "last_answer_after_close_s": (max(done) - rec.t0 - seconds) if done else None,
            "mean_k": sum(ks) / len(ks) if ks else None,
            "correct": all(c.holds for c in rec.checks)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated offered rates per second")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=11)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from tofec_bench.harness import deploy, spec

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    base = spec.load_cell(args.workload, ROOT)
    out = ROOT / "build" / "tofec_bench" / f"sweep_{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell.traffic["rate_per_s"] = rate
        t = time.monotonic()
        rec = spec.driver(cell).run(cell, seed=args.seed + i, seconds=args.seconds, traced=False,
                                    device=device, process_start=t)
        line = json.dumps(summary(rec, rate, args.seconds))
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
        del rec
        deploy.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
