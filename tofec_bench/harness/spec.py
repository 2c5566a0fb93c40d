"""Finds every part of a cell by its name.

``BENCHMARK.json`` at the checkout's root names the cell, its configuration
and its traffic. Everything else lies under the benchmark's folder (the
first of ``paths``), one file per part:

* ``configs/<config>.json``: the configuration (its entry's ``file``);
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``metrics/<metric>.py``: one reader per metric, ``read(rec) -> float | None``;
* ``drivers/<driver>.py``: the code that runs a configuration's kind of
  system, named by the configuration's ``driver``;
* ``reference/<reference>.py``: a model's plain reference, named by the
  configuration's ``reference``.

A later change adds a cell, a configuration or a metric by adding such files
and entries; no file that is there needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

#: The checkout's root: the folder that holds ``BENCHMARK.json``.
ROOT = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    #: the metric entries of BENCHMARK.json that this cell reports
    end_to_end: list[dict]
    per_layer: list[dict]
    bench_dir: pathlib.Path


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell does where the entry
    lists no ``workloads``."""
    return "workloads" not in metric or cell in metric["workloads"]


def _one(entries: list[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    root = pathlib.Path(root)
    bench = load_benchmark(root)
    bench_dir = root / bench["paths"][0]
    w = _one(bench["workloads"], name, "workloads")
    c = _one(bench["configs"], w["config"], "configs")
    with open(root / c["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)],
                bench_dir=bench_dir)


def load_module(path: pathlib.Path, kind: str):
    """Import one file of the benchmark by its path, under a module name
    made from ``kind`` and the file's name (a metric's name may hold dots)."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"tofec_bench_{kind}_" + re.sub(r"\W", "_", path.stem)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(cell: Cell, metric: str):
    return load_module(cell.bench_dir / "metrics" / f"{metric}.py", "metric").read


def driver(cell: Cell):
    return load_module(cell.bench_dir / "drivers" / f"{cell.config['driver']}.py", "driver")


def reference(cell: Cell):
    return load_module(cell.bench_dir / "reference" / f"{cell.config['reference']}.py",
                       "reference")
