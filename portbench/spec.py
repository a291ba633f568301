"""A cell of ``BENCHMARK.json`` and the files it is made of.

A workload names a configuration and a traffic mix. The configuration is
the file that its ``configs`` entry names; the traffic mix is
``portbench/traffic/<traffic>.json``; the limits of its correctness check
are ``portbench/limits/<workload>.json``; and each metric is read by
``portbench/metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files and entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

__all__ = ["ROOT", "Cell", "load_benchmark", "load_cell", "metric_reader"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the metrics' BENCHMARK.json entries that this cell reports
    per_layer: list


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_of_cell


def load_benchmark(bench: str | None = None) -> dict:
    """``BENCHMARK.json`` at the checkout's root, or the file ``bench``."""
    return _read_json(bench or os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str, bench: str | None = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` (at the checkout's root
    unless ``bench`` names another file) with its files read."""
    spec = load_benchmark(bench)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=w["chips"], config=_read_json(os.path.join(ROOT, config["file"])),
                traffic=_read_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                limits=_read_json(os.path.join(HERE, "limits", f"{name}.json")),
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
