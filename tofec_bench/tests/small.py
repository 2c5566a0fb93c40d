"""Cells at a size a CPU test can hold: the benchmark's files copied into a
temporary checkout root, each cell's configuration and traffic cut down in
the copy (tiny objects, the store's delays scaled down, zamba2's smoke
shapes), so the harness runs end to end on the CPU."""

from __future__ import annotations

import json
import pathlib
import shutil

from tofec_bench.harness import spec

BENCH = spec.ROOT / "tofec_bench"

#: zamba2's CPU-test shapes (the port's ``configs/zamba2_2_7b.smoke_config``)
SMOKE_MODEL = {"n_layers": 4, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
               "vocab": 512, "ssm_state": 16, "attn_every": 2, "ssm_chunk": 8,
               "local_window": 8}

SMALL_DEPLOYMENT = {"file_bytes": 6 * 1024, "time_scale": 0.02}
SMALL_TRAFFIC = {
    "read3mb-poisson": {"rate_per_s": 150.0},
    "chat-poisson": {"rate_per_s": 12.0, "prompt_tokens": 16, "gen_tokens": 4, "max_round": 4,
                     "trace_from": 1, "traced_rounds": 1},
    "decode-batch": {"prompt_tokens": 12, "gen_tokens": 6, "round": 4, "trace_from": 1},
}


def _edit(path: pathlib.Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def small_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout root under ``tmp`` with BENCHMARK.json and the benchmark's
    folder, every configuration and traffic cut down for the CPU."""
    root = pathlib.Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "tofec_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")

    def config(c):
        c["deployment"].update(SMALL_DEPLOYMENT)
        c["drain_s"] = 5
        if "model" in c:
            c["model"].update(SMOKE_MODEL)
            c["prompts"] = 8
            c["check"].update(sample_tokens=16, ref_rows=2)
        else:
            c["objects"] = 16

    for path in (root / "tofec_bench" / "configs").glob("*.json"):
        _edit(path, config)
    for name, change in SMALL_TRAFFIC.items():
        _edit(root / "tofec_bench" / "traffic" / f"{name}.json", lambda t: t.update(change))
    return root

