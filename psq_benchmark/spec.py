"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's file (named there), each traffic mix's
file ``traffic/<traffic>.json``, each cell's limits ``limits/<cell>.json``
and each per-layer metric's reader ``metrics/<metric>.py``.  Adding a
configuration, a traffic mix, a cell or a metric adds files and entries;
no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    here = os.path.join(root, "psq_benchmark")
    spec = benchmark(root)
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name) and m["moves"] in reported]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: str = ROOT):
    """The ``read(run)`` function of metrics/<metric>.py."""
    path = os.path.join(root, "psq_benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "psq_benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
