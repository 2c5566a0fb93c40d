"""The command: no card, no result; no program, no result; and, on a card,
each cell runs with ``correct`` true."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tofec_bench.harness import spec

CMD = [sys.executable, "tofec_bench/run.py"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_without_a_card_there_is_no_result():
    out = subprocess.run(CMD + ["--workload", "read3mb-poisson", "--seed", str(2**31 + 5),
                                "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copytree(spec.ROOT / "tofec_bench", tmp_path / "tofec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(CMD + ["--workload", "read3mb-poisson", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["read3mb-poisson", "zamba2-chat-poisson",
                                      "zamba2-decode-batch"])
def test_each_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(CMD + ["--workload", workload, "--seed", str(2**31 + 99),
                                "--seconds", "12", "--trace", "0"],
                         cwd=spec.ROOT, env=_env(), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
