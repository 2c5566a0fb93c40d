"""No run loads JAX or the JAX package, and no source of the benchmark reads
the JAX package's benchmark folder."""

import json
import os
import re
import subprocess
import sys

import pytest

from tofec_bench.harness import spec

RUN_CELLS = r"""
import json, pathlib, sys, tempfile, time
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import torch
from tofec_bench.harness import spec
from tofec_bench.tests.small import small_root
root = small_root(pathlib.Path(tempfile.mkdtemp()))
entry = spec.load_module(pathlib.Path(sys.argv[1]) / "tofec_bench/run.py", "entry")
correct = {}
for name in ("read3mb-poisson", "zamba2-decode-batch"):
    cell = spec.load_cell(name, root)
    rec = spec.driver(cell).run(cell, seed=2**31 + 3, seconds=1.0, traced=False,
                                device=torch.device("cpu"), process_start=time.monotonic())
    correct[name] = all(c.holds for c in rec.checks)
    for m in cell.end_to_end + cell.per_layer:
        spec.metric_reader(cell, m["name"])
print(json.dumps({"loaded": entry.forbidden_loaded(), "correct": correct}))
"""


def test_a_run_loads_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUN_CELLS, str(spec.ROOT)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert all(res["correct"].values()), res


STUB_DRIVER = '''from tofec_bench.harness.record import Check, Record


def run(cell, *, seed, seconds, traced, device, process_start):
    rec = Record(setup_s=0.5)
    rec.requests.append({"due": 0.0, "done": 0.001, "ok": True})
    rec.checks = [Check("stub", 0, 0)]
    return rec
'''

RUN_STUB = r"""
import argparse, pathlib, sys, time
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from tofec_bench.harness import spec
entry = spec.load_module(pathlib.Path(sys.argv[1]) / "tofec_bench/run.py", "entry")
cell = spec.load_cell("stub-cell", pathlib.Path(sys.argv[2]))
args = argparse.Namespace(seed=1, seconds=0.1, trace=0)
sys.exit(entry.run_cell(cell, args, "cpu", lambda: "stub", time.monotonic()))
"""


@pytest.mark.parametrize("metric_imports_jax", [True, False])
def test_a_module_loaded_by_a_metric_reader_withholds_the_result(tmp_path, metric_imports_jax):
    """The look at ``sys.modules`` comes after every reader has run: a metric
    file that loads a module named ``jax`` (a stand-in on the path) leaves
    the run with no result and exit code 3."""
    bench = tmp_path / "root" / "bench"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        (bench / sub).mkdir(parents=True)
    (tmp_path / "root" / "BENCHMARK.json").write_text(json.dumps({
        "paths": ["bench"],
        "configs": [{"name": "stub", "file": "bench/configs/stub.json"}],
        "workloads": [{"name": "stub-cell", "config": "stub", "traffic": "stub", "chips": 1}],
        "end_to_end": [{"name": "stub_ms", "unit": "ms"}], "per_layer": []}))
    (bench / "configs/stub.json").write_text(json.dumps({"driver": "stub"}))
    (bench / "traffic/stub.json").write_text("{}")
    (bench / "drivers/stub.py").write_text(STUB_DRIVER)
    (bench / "metrics/stub_ms.py").write_text(
        ("import jax  # noqa: F401\n" if metric_imports_jax else "") + "\n\ndef read(rec):\n    return 1.0\n")
    (tmp_path / "stubs").mkdir()
    (tmp_path / "stubs" / "jax.py").write_text('"""A stand-in for JAX."""\n')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path / "stubs")
    out = subprocess.run([sys.executable, "-c", RUN_STUB, str(spec.ROOT), str(tmp_path / "root")],
                         env=env, capture_output=True, text=True, timeout=300)
    if metric_imports_jax:
        assert out.returncode == 3 and out.stdout.strip() == "", out.stdout
        assert "forbidden modules: jax" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["metrics"]["stub_ms"]["value"] == 1.0


def test_the_check_compares_whole_top_level_names():
    entry = spec.load_module(spec.ROOT / "tofec_bench/run.py", "entry")
    assert entry.forbidden_loaded(["repro_torch", "repro_torch.core", "jaxtyping", "numpy"]) == []
    assert entry.forbidden_loaded(["repro.core", "jax", "jaxlib.xla_client", "flax", "torch"]) \
        == ["flax", "jax", "jaxlib.xla_client", "repro.core"]


def test_no_source_of_the_benchmark_names_the_jax_package_or_benchmarks():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|repro)(\s|\.|$)", re.M)
    for f in (spec.ROOT / "tofec_bench").rglob("*.py"):
        text = f.read_text()
        assert not pat.search(text), f
        assert "bench" + "marks/" not in text.replace("tofec_bench/", ""), f
