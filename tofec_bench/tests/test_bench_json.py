"""BENCHMARK.json keeps to the benchmark's contract: its keys, names, units,
bounds, files and the time a full check of 24 cells takes."""

import json
import math
import re

import pytest

from tofec_bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    ms = BENCH[kind]
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    all_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(all_names)) == len(all_names)
    assert 1 <= len(ms) <= (16 if kind == "end_to_end" else 128)
    for m in ms:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                              "moves"}
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert _line(m["layer"]) and m["moves"] in e2e
            moved = e2e[m["moves"]]
            # every cell that reads this metric reports the metric it moves
            assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
            if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
                assert m["unit"] == "%"
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        # a layer named twice is named alike
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(spec.ROOT).as_posix()
            assert PATH.match(rel), rel


def test_open_loop_rates_are_numbers_at_four_fifths_of_the_knee():
    for w in BENCH["workloads"]:
        t = spec.load_cell(w["name"]).traffic
        if t["arrivals"] == "poisson":
            assert isinstance(t["rate_per_s"], float)
            assert math.isclose(t["rate_per_s"], 0.8 * t["knee_per_s"], rel_tol=1e-9)
