"""The port's benchmark runners (tools/bench.py, tools/bench_consensus.py)
on the CPU against the JAX side: bench.py's fill cell count and Refine
mutation set at its full sizes, the Refine call's totals against
TpuEngine(float64), and bench_e2e's FASTA and accuracy against the JAX
CLI's exact backend on the same run."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tools import bench as tb
from tools import bench_consensus as bc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOOLS = ("bench", "bench_consensus", "bench_multihost", "dryrun")




def test_fill_cells_equal_bench_py():
    """bench_fill's cells (seed 0, 1 kb, 60 events, width 300) are the
    count bench.py:169-171 makes from the JAX package's fill_inputs."""
    from poreseq_tpu.core.sequence import seq_to_states
    from poreseq_tpu.engine.tpu.pack import (fill_inputs, pack_events,
                                             round_up)
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(0), ref_len=1000,
                             coverage=60)
    data = AlignData.from_session(pa)
    S = len(seq_to_states(data.sequence))
    arrays, ref_indexes = pack_events(data.events)
    fi = fill_inputs(arrays, ref_indexes, S, round_up(S, 64), 300)
    h0, h1 = fi["i0"], fi["i1"]
    exp = int(np.sum(np.maximum(h1[:, 1 : S + 1] - h0[:, 1 : S + 1] + 1,
                                0)) * 4)
    got = tb.fill_case("cpu")
    assert got["cells"] == exp > 0
    assert (got["S"], got["n_events"]) == (S, 60)
    # the operands are the fill's: [C, E] states and pad, [E, C + 1] band
    C, E = got["C"], got["E"]
    assert got["states"].shape == got["is_pad"].shape == (C, E)
    assert got["i0"].shape == got["i1"].shape == (E, C + 1)


def test_refine_case_equals_bench_py():
    """bench_refine's mutations and events (seed 3, 1 kb at 20X, scoring
    width 20) are bench.py:102-124's."""
    from poreseq_tpu.engine.driver import find_point_mutations
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(3), ref_len=1000,
                             coverage=20)
    data = AlignData.from_session(pa)
    data.params.scoring_width = 20
    exp = find_point_mutations(data)
    _, pdata, got = tb.refine_case("cpu")
    assert len(got) == len(exp) > 0
    assert [(m.start, m.orig, m.mut) for m in got] == [
        (m.start, m.orig, m.mut) for m in exp]
    assert len(pdata.events) == len(data.events) == 20


def test_refine_totals_equal_tpu_engine_f64(monkeypatch):
    """The Refine-scale call at a small size in f64 on the CPU (the kernels'
    twins) gives TpuEngine(float64)'s scores within 1e-8; realign width 24
    on both sides keeps the CPU's fills short."""
    import jax
    import jax.numpy as jnp

    from poreseq_tpu.engine.driver import find_point_mutations
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.sim import simulate_session

    engine, data, muts = tb.refine_case("cpu", 120, 4, "float64")
    data.params.realign_width = 24
    got = np.asarray([m.score for m in engine.score_mutations(data, muts)])
    jax.config.update("jax_enable_x64", True)
    try:
        pa, _ = simulate_session(np.random.default_rng(3), ref_len=120,
                                 coverage=4)
        jdata = AlignData.from_session(pa)
        jdata.params.scoring_width = 20
        jdata.params.realign_width = 24
        exp = np.asarray([m.score for m in TpuEngine(
            dtype=jnp.float64).score_mutations(
                jdata, find_point_mutations(jdata))])
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.shape == exp.shape == (len(muts),) and len(muts) > 500
    assert np.max(np.abs(got - exp)) <= 1e-8


def test_bench_e2e_exact_equals_the_jax_cli(tmp_path):
    """bench_e2e under --backend exact (2 x 400 b at 6X, widths 48/24/12)
    leaves the FASTA the JAX CLI writes on the same run, byte for byte,
    and its accuracy is bench.py:82-85's arithmetic on that FASTA."""
    import time

    from poreseq_tpu import cli as jcli
    from poreseq_tpu.api import swalign
    from poreseq_tpu.engine.exact._native import LIB as JLIB
    from poreseq_tpu.io.fasta import read_fasta
    from poreseq_tpu.sim import random_seq

    res = tb.bench_e2e(time.monotonic() + 600, "cpu", R=2, L=400, cov=6,
                       backend="exact", widths=(48, 24, 12), steady_runs=1,
                       workdir=str(tmp_path))
    assert res["n_regions"] == 2 and len(res["steady_runs_s"]) == 1
    assert res["peak_device_mib"] is None
    assert res["regions_per_hour"] == pytest.approx(
        3600 * 2 / res["steady_run_median_s"])
    d = str(tmp_path)
    out = tmp_path / "jax.fasta"
    JLIB.psq_srand(1)
    jcli.main(["consensus", f"{d}/ref.fasta", f"{d}/reads.bam",
               f"{d}/reads", "-R", f"{d}/regions.txt", "-p",
               f"{d}/params.conf", "-o", str(out), "-i", "4", "--backend",
               "exact"])
    assert (tmp_path / "out.fasta").read_bytes() == out.read_bytes()
    seqs = read_fasta(str(out))
    # write_run's first draw is the truth (poreseq_tpu/sim.py:227)
    truth = random_seq(np.random.default_rng(0), 800)
    accs = [swalign(seq, truth[max(int(n.split(":")[1]) - 400, 0)
                               : int(n.split(":")[2]) + 400])[0]
            for n, seq in seqs.items()]
    assert res["mean_accuracy_pct"] == float(np.nanmean(accs))


def test_bench_consensus_batches_agree(tmp_path):
    """bench_consensus at --batch 1 and --batch 2 on one run under exact:
    the same output (exact runs regions one by one whatever the batch)
    and the script's keys."""
    args = bc.parse(["2", "--region-length", "400", "--coverage", "6",
                     "--backend", "exact", "--device", "cpu"])
    built = bc.build(args, str(tmp_path))
    with open(built["conf"], "w") as f:
        f.write(tb.CONF.format(48, 24, 12, 300))
    from poreseq_tpu_torch.engine import _native

    lines = []
    for batch in (1, 2):
        args.batch = batch
        _native.srand(1)
        lines.append(bc.run(args, built))
    keys = {"regions", "batch", "coverage", "backend", "total_s", "first_s",
            "s_per_region", "regions_per_hour", "vs_ref_2min_per_kb",
            "mean_acc", "n_out"}
    assert keys <= set(lines[0]) and lines[0]["n_out"] == 2
    assert [l["batch"] for l in lines] == [1, 2]
    assert ((tmp_path / "out.b1.fasta").read_bytes()
            == (tmp_path / "out.b2.fasta").read_bytes())
    assert lines[0]["mean_acc"] == lines[1]["mean_acc"]


_NO_CARD = """
import importlib, io, json, sys, contextlib
import torch
torch.cuda.is_available = lambda: False
codes = {}
for name, argv in json.loads(sys.argv[1]).items():
    mod = importlib.import_module(f"tools.{name}")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main(argv)
        codes[name] = [0, out.getvalue()]
    except SystemExit as e:
        codes[name] = [e.code if isinstance(e.code, int) else 1,
                       out.getvalue()]
    except Exception as e:
        codes[name] = [1, out.getvalue()]
print(json.dumps(codes))
"""


def test_tools_refuse_to_run_without_a_card():
    """Each tool runs on cuda by default; where torch sees no card it
    stops non-zero before printing a result line (no CPU fallback)."""
    import json

    argvs = {name: [] for name in TOOLS}
    argvs["bench_multihost"] = ["--processes", "2"]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_CARD, json.dumps(argvs)], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    codes = json.loads(proc.stdout.splitlines()[-1])
    assert set(codes) == set(TOOLS)
    for name, (code, out) in codes.items():
        assert code != 0 and "{" not in out, (name, code, out)
