"""Every cell resolves to its files; a cell, configuration, traffic mix
or metric added as files and entries is found without an edit."""

import json
import os
import re
import shutil

from psq_benchmark import spec

from .conftest import ROOT


def test_every_workload_resolves_to_its_files():
    b = spec.benchmark()
    names = [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for w in b["workloads"]:
        c = spec.cell(w["name"])
        assert c.config["name"] == w["config"]
        assert c.traffic["entry"] in ("consensus", "variant_all")
        assert c.chips == 1
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, w["name"]
        for m in c.per_layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in reported
        assert c.limits


def test_config_files_match_their_entries():
    b = spec.benchmark()
    for c in b["configs"]:
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_benchmark_json_keeps_to_its_form():
    """Each entry has exactly its keys (a metric may add ``workloads``),
    every name, unit and line is within its limits."""
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["command"]) <= 32 and all(map(_line, b["command"]))
    for section, keys in KEYS.items():
        names = [e["name"] for e in b[section]]
        assert len(names) == len(set(names)), section
        for e in b[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                  "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (section, e["name"])
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer"):
                if k in e:
                    assert _line(e[k]), (section, e["name"], k)
    for c in b["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.fullmatch(w["traffic"]) and w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "psq_benchmark"),
                    root / "psq_benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read()
              for p in (root / "psq_benchmark").rglob("*") if p.is_file()}
    conf = json.load(open(root / "psq_benchmark/configs/poreseq-1kb-10x.json"))
    conf["name"] = "poreseq-2kb-10x"
    conf["region_length"] = 2000
    (root / "psq_benchmark/configs/poreseq-2kb-10x.json").write_text(
        json.dumps(conf))
    (root / "psq_benchmark/traffic/consensus-b2.json").write_text(json.dumps(
        {"entry": "consensus", "region_batch": 2, "iterations": 4,
         "pool_regions": 8}))
    (root / "psq_benchmark/limits/consensus-2kb-10x.json").write_text(
        json.dumps({"optimum_gap": 1.0}))
    (root / "psq_benchmark/metrics/regions_per_batch.py").write_text(
        "def read(run):\n    return 2.0\n")
    b = json.load(open(root / "BENCHMARK.json"))
    b["configs"].append({"name": "poreseq-2kb-10x", "source": "x",
                         "file": "psq_benchmark/configs/poreseq-2kb-10x.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "consensus-2kb-10x",
                           "config": "poreseq-2kb-10x",
                           "traffic": "consensus-b2", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "regions_per_batch", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "kb_per_hour",
                           "workloads": ["consensus-2kb-10x"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "consensus-1kb-10x" in m["workloads"]:
            m["workloads"].append("consensus-2kb-10x")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.cell("consensus-2kb-10x", str(root))
    assert c.config["region_length"] == 2000
    assert c.traffic["region_batch"] == 2
    assert "regions_per_batch" in [m["name"] for m in c.per_layer]
    assert spec.reader("regions_per_batch", str(root))(None) == 2.0
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_the_cells_kept_for_later_resolve_from_their_files():
    from .conftest import KEPT, cell_of

    for name in KEPT:
        c = cell_of(name)
        assert c.traffic["entry"] in ("consensus", "variant_all")
        assert c.limits and c.config["params"]
