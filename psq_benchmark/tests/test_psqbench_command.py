"""The command fails, and prints no result, without a card, and in a
directory that holds only BENCHMARK.json and the benchmark's files."""

import os
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

ARGS = ["-m", "psq_benchmark.run", "--workload", "consensus-1kb-10x",
        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env)
    assert p.returncode == 2, p.stderr
    assert p.stdout == ""
    assert "CUDA card" in p.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copytree(os.path.join(ROOT, "psq_benchmark"),
                    tmp_path / "psq_benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = _run(str(tmp_path), env)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    p = _run(ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    import json

    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
