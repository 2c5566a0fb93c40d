"""Run one cell of the benchmark once and print its result.

    python3 tofec_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and metrics
are found by name (``tofec_bench/harness/spec.py``). The run needs CUDA
cards, as many as the cell names: without them it exits 2 and prints no
result; it never falls back to the CPU. With ``--trace 0`` it reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled stretch of the window.

The last lines of standard error name each number compared and its limit;
the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``.

Every build and kernel cache the program writes lies in ``build/`` inside
the checkout. The run sets ``PYTHONHASHSEED=0`` (restarting itself once to
do so): the proxy orders a read's chunks by ``hash(key)``, so two runs of
one seed would otherwise issue different chunks.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton_cache"}


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules (``modules``, default ``sys.modules``) whose top-level
    name, the part before the first dot, is one of :data:`FORBIDDEN`,
    compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result(cell, rec, traced: bool, device_name: str, chips: int, readers) -> dict:
    """The result line of a run: its metrics read by name, and its checks."""
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = readers(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": all(c.holds for c in rec.checks), "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                              "holds_if": "value >= limit" if c.at_least else "value <= limit"}
                     for c in rec.checks}
    return out


def main(argv=None) -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = {**os.environ, "PYTHONHASHSEED": "0"}
        os.execve(sys.executable, [sys.executable, *sys.argv], env)
    args = _args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from tofec_bench.harness import deploy, spec

    process_start = time.monotonic() - deploy.process_age_s()
    import torch

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    return run_cell(cell, args, device, lambda: torch.cuda.get_device_name(device),
                    process_start)


def run_cell(cell, args, device, device_name, process_start: float) -> int:
    """Run the cell once on ``device``, read its metrics and checks, and
    print its result; print none and return 3 where a forbidden module was
    loaded by then (the metric readers included)."""
    from tofec_bench.harness import spec

    rec = spec.driver(cell).run(cell, seed=args.seed, seconds=args.seconds,
                                traced=bool(args.trace), device=device,
                                process_start=process_start)
    out = result(cell, rec, bool(args.trace), device_name(), cell.chips,
                 lambda name: spec.metric_reader(cell, name))
    out["device"]["power_limit"] = _power_limit()
    for i, r in enumerate(rec.rounds):
        ph = r["phase_ms"]
        print(f"round {i}: {r['rows']} rows ({r['padded']} padded), fetch {ph['fetch']:.1f} ms, "
              f"launch {ph['launch']:.1f} ms, generate {ph['generate']:.1f} ms, wall "
              f"{(r['end'] - r['start']) * 1e3:.1f} ms, host {host_line(r)}"
              f"{', profiled' if r['traced'] else ''}", file=sys.stderr)
    if rec.trace:
        print(f"traced: {rec.trace['device_events']} device events, K1 "
              f"{rec.trace['k1_calls']} calls, {rec.trace['k1_s']!r} s", file=sys.stderr)
    for line in rec.extra.get("notes", []):
        print(line, file=sys.stderr)
    bad = forbidden_loaded()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    for c in rec.checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def host_line(r: dict) -> str:
    """What the host did in a round: the main thread's CPU seconds and
    involuntary context switches, the other threads' CPU seconds, the
    garbage collector's seconds, the CPU seconds the hypervisor took from
    the machine, and the store's task seconds that overlapped the generate
    phase."""
    h = r.get("host")
    if not h:
        return "-"
    return (f"main cpu {h['main_cpu_s']:.3f} s, {h['main_nivcsw']} preempted, others cpu "
            f"{h['other_cpu_s']:.3f} s, gc {h['gc_s']:.3f} s, stolen {h['steal_s']:.2f} s, "
            f"store sleeping in generate {h['store_s_in_generate']:.3f} s")


if __name__ == "__main__":
    sys.exit(main())
