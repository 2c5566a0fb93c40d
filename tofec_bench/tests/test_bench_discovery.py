"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files (and entries in BENCHMARK.json) are found by name, with no edit
to any file the benchmark already has."""

import hashlib
import json
import shutil

import pytest

from tofec_bench.harness import spec

NEW_METRIC = '''"""Mean k of the window's reads, doubled."""


def read(rec):
    ks = [r["k"] for r in rec.requests if "k" in r]
    return 2.0 * sum(ks) / len(ks) if ks else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "tofec_bench").rglob("*") if p.is_file()}


def test_a_cell_of_new_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "tofec_bench", root / "tofec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    # new files only
    cfg = json.loads((root / "tofec_bench/configs/tofec-read3mb.json").read_text())
    cfg["objects"] = 512
    (root / "tofec_bench/configs/tofec-read3mb-512.json").write_text(json.dumps(cfg))
    (root / "tofec_bench/traffic/read3mb-light.json").write_text(json.dumps(
        {"arrivals": "poisson", "rate_per_s": 13.0, "keys": "uniform"}))
    (root / "tofec_bench/metrics/twice_k.read.py").write_text(NEW_METRIC)
    # and entries
    bench["configs"].append({"name": "tofec-read3mb-512", "source": "https://arxiv.org/abs/1307.8083",
                             "file": "tofec_bench/configs/tofec-read3mb-512.json", "reduced": [],
                             "why": "twice the objects"})
    bench["workloads"].append({"name": "read3mb-light", "config": "tofec-read3mb-512",
                               "traffic": "read3mb-light", "chips": 1, "why": "a light load"})
    bench["per_layer"].append({"name": "twice_k.read", "unit": "chunks", "better": "higher",
                               "source": "program_counter", "layer": "controller (core/controller.py TOFECPolicy)",
                               "moves": "read_p50_ms", "workloads": ["read3mb-light"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("read_"):
            m["workloads"].append("read3mb-light")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("read3mb-light", root)
    assert cell.config["objects"] == 512
    assert cell.traffic["rate_per_s"] == 13.0
    assert [m["name"] for m in cell.per_layer] == ["twice_k.read"]
    assert {m["name"] for m in cell.end_to_end} == {"read_p50_ms", "read_p95_ms", "setup_s"}
    assert spec.driver(cell).__name__.endswith("proxy_reads")

    class Rec:
        requests = [{"k": 1}, {"k": 3}]

    assert spec.metric_reader(cell, "twice_k.read")(Rec) == 4.0
    # the cells that were there are found as before
    assert spec.load_cell("read3mb-poisson", root).config["objects"] == 256
    assert before == {p: d for p, d in _digests(root).items() if p in before}


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
    cell = spec.load_cell("read3mb-poisson")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader(cell, "no_such_metric")


def test_every_cell_finds_its_parts():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        spec.driver(cell)
        if "reference" in cell.config:
            spec.reference(cell)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(cell, m["name"]))
