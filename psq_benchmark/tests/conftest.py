"""Tests of the benchmark itself, on the CPU: ``pytest psq_benchmark/``.
Tests that need a card are marked ``cuda`` and skip inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on one")


#: cells whose files the harness keeps but BENCHMARK.json does not list
#: (their rates spread too widely on the card to hold a bound): name ->
#: (configuration file, traffic)
KEPT = {"variant-all-1kb-10x": ("poreseq-1kb-10x", "variant-all"),
        "consensus-1kb-30x": ("poreseq-1kb-30x", "consensus-b4")}


def cell_of(name: str):
    """A cell of BENCHMARK.json, or one of KEPT built from its files."""
    import json

    from psq_benchmark import spec

    if name not in KEPT:
        return spec.cell(name)
    conf, traffic = KEPT[name]
    here = os.path.join(ROOT, "psq_benchmark")
    load = lambda *p: json.load(open(os.path.join(here, *p)))
    return spec.Cell(name=name, chips=1,
                     config=load("configs", conf + ".json"),
                     traffic=load("traffic", traffic + ".json"),
                     limits=load("limits", name + ".json"),
                     end_to_end=[], per_layer=[])


def tiny_cell(name: str, **traffic):
    """A cell cut to a size the CPU twins run in about a minute: 200 b
    regions, widths 16 / 8 / 6, batches of 2, -i 1."""
    import copy

    c = cell_of(name)
    c.config = copy.deepcopy(c.config)
    c.config["params"].update(realign_width=16, scoring_width=8,
                              point_width=6, end_trim=20, min_overlap=100)
    c.config["region_length"] = 200
    c.config["read_length"] = 240
    t = dict(c.traffic, pool_regions=2)
    if "region_batch" in t:
        t.update(region_batch=2, iterations=1)
    t.update(traffic)
    c.traffic = t
    c.limits = dict(c.limits, block_regions=2, check_regions=None)
    return c


def run_tiny(cell, seed: int = 2**31 + 17, control: bool = False):
    import time

    from psq_benchmark.run import run_cell

    return run_cell(cell, seed, 0.5, False, "cpu", time.time(),
                    control=control)
