#!/usr/bin/env python3
"""Telemetry's wall cost on the card: the three figure sweeps of
``chip_smoke.py`` at full size, run in alternating pairs with ``REPRO_OBS``
off and on (off-on, then on-off, ...), timed on the host clock around work
that ends in ``torch.cuda.synchronize()``.

Usage, from the repository root, on a machine with one CUDA card:

    python3 obs_cost.py [--pairs 5]

Prints, per sweep, every run's seconds, the median and quartiles of each
side, and the median of the per-pair ratio on / off; the card's
``nvidia-smi`` name and power limit first. Writes the same as JSON to
``chiprun_out/obs_cost.json``. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("obs_cost: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch import obs
    from repro_torch.fleet import FleetSweep
    from repro_torch.sched import SchedSweep
    from repro_torch.taskq import TaskqSweep

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    smi = c.nvidia_smi_line()
    print(f"[obs_cost] {smi}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    pools = c.taskq_pools(dev)
    taskq_cases, _ = c.taskq_grid()
    fleet_cases = c.fleet_grid()
    sched_cases = c.sched_grid()[1]
    paths = {
        "fleet": lambda: FleetSweep(chunk=c.FLEET_CHUNK, device=dev).run(fleet_cases,
                                                                          c.FLEET_COUNT),
        "taskq": lambda: TaskqSweep(chunk=c.TASKQ_CHUNK, device=dev).run(taskq_cases,
                                                                         c.TASKQ_COUNT, pools),
        "sched": lambda: SchedSweep(chunk=c.SCHED_CHUNK, device=dev).run(sched_cases,
                                                                         c.SCHED_COUNT),
    }

    def timed(run, on: bool) -> float:
        obs.set_enabled(on)
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            return time.monotonic() - t0
        finally:
            obs.set_enabled(None)

    report = {"device": smi, "pairs": args.pairs, "paths": {}}
    for name, run in paths.items():
        timed(run, False)  # warm-up, not kept
        off, on = [], []
        for i in range(args.pairs):
            for flag in ((False, True) if i % 2 == 0 else (True, False)):
                (on if flag else off).append(timed(run, flag))
        ratio = np.median(np.array(on) / np.array(off))
        rec = {"off_s": off, "on_s": on, "off_median": float(np.median(off)),
               "on_median": float(np.median(on)),
               "off_quartiles": [float(q) for q in np.percentile(off, [25, 75])],
               "on_quartiles": [float(q) for q in np.percentile(on, [25, 75])],
               "on_over_off_median_ratio": float(ratio)}
        report["paths"][name] = rec
        print(f"[obs_cost] {name}: off {[round(x, 3) for x in off]} s (median "
              f"{rec['off_median']:.3f}, quartiles {rec['off_quartiles'][0]:.3f}-"
              f"{rec['off_quartiles'][1]:.3f}); on {[round(x, 3) for x in on]} s (median "
              f"{rec['on_median']:.3f}, quartiles {rec['on_quartiles'][0]:.3f}-"
              f"{rec['on_quartiles'][1]:.3f}); median per-pair on/off {ratio:.4f}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "obs_cost.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
