"""The DeepSeek-V3 cell on the card: a run comes out correct, and the float8
control at the cell's own size comes out not correct."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tofec_bench.harness import spec

CELL = "deepseek3-mla-batch"


@pytest.mark.cuda
def test_the_cell_runs_correct_on_the_card(card):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "tofec_bench/run.py", "--workload", CELL, "--seed",
                          str(2**31 + 99), "--seconds", "12", "--trace", "0"],
                         cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["device"]["memory_peak_bytes"] < 72e9


@pytest.mark.cuda
def test_fp8_control_is_not_correct_at_the_cells_size(card):
    cell = spec.load_cell(CELL)
    rec = spec.driver(cell).run(cell, seed=2**31 + 4321, seconds=12.0, traced=False,
                                device=card, process_start=time.monotonic(), control="fp8")
    checks = {c.name: c for c in rec.checks}
    assert not checks["mean_sq_logit_gap"].holds, checks["mean_sq_logit_gap"]
    assert np.mean(np.square(rec.extra["program_gaps"])) < checks["mean_sq_logit_gap"].limit
