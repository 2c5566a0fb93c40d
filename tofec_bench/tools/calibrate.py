"""Read the numbers a cell's limits are set from: the program's readings
over many seeds and the control's over a few, in one process.

    python3 tofec_bench/tools/calibrate.py --workload zamba2-chat-poisson \\
        --seeds 101,102,... --controls 3 --seconds 12

Each seed runs the cell's driver once with a short window at the cell's own
load and sizes, and prints one JSON line with every check's value and
whether the run came out correct.

* A model's cell: on the first ``--controls`` seeds the reference in
  float8 products (the precision below bfloat16) is put in the program's
  place, and its tokens are judged; the line keeps every judged token's
  gap below the float32 reference's best logit, the program's and the
  control's.
* A cell with no model: on the first ``--controls`` seeds the control
  breaks the guarantee that a read returns the stored bytes: the proxy's
  decode hands back the k chunks it gathered, undecoded (right only where
  they are the systematic ones); the line gives the reads it got wrong.

Lines, with the gaps, also go to
``build/tofec_bench/calibrate_<workload>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def skip_decode(name, obj):
    """The control of a cell with no model: decode returns its input rows."""
    if name == "deployment":
        obj.codec.decode = lambda rows, present, n, k: rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=12.0)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from tofec_bench.harness import deploy, spec

    if not torch.cuda.is_available():
        print("the calibration needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload, ROOT)
    model = "reference" in cell.config
    out = ROOT / "build" / "tofec_bench" / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        control = i < args.controls
        kw = {}
        if control and model:
            kw["control"] = "fp8"
        elif control:
            kw["hook"] = skip_decode
        t = time.monotonic()
        rec = spec.driver(cell).run(cell, seed=seed, seconds=args.seconds, traced=False,
                                    device=device, process_start=t, **kw)
        line = {"seed": seed, "control": control, "seconds": time.monotonic() - t,
                "correct": all(c.holds for c in rec.checks),
                "checks": {c.name: c.value for c in rec.checks},
                "attempted": rec.attempted, "failed": rec.failed,
                "program_gaps": rec.extra.get("program_gaps"),
                "control_gaps": rec.extra.get("control_gaps")}
        print(json.dumps({k: v for k, v in line.items() if not k.endswith("_gaps")}), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del rec
        deploy.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
