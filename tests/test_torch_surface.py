"""Twins of the JAX package's tests of the API and CLI surface that no other
port test mirrors: PSAlign.ApplyMuts, a region without mutations in a
multi-region ScoreMutations batch, the `merge` and `extract` subcommands
(output byte-equal to the JAX CLI's), and, marked `slow` as their
originals are, split -> consensus -> merge on a 3.4 kb genome, 44 regions
in one --region-batch and a two-process `train`.  Each gives the same
seeded inputs to the JAX package and to the port."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu import cli as jcli
from poreseq_tpu.api import swalign
from poreseq_tpu.io.fasta import read_fasta, write_fasta
from poreseq_tpu.sim import write_run

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_apply_muts_matches_jax():
    """tests/test_pipeline_extra.py::test_apply_muts on the port: the same
    four pre-scored mutations (a substitution, a deletion, an insertion and
    a negative one) give the JAX session's sequence and alignments."""
    from poreseq_tpu.core.regions import MutationScore as JMS
    from poreseq_tpu.sim import simulate_session as jsim
    from poreseq_tpu_torch.core.regions import MutationScore
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.sim import simulate_session

    pj, _ = jsim(np.random.default_rng(21), ref_len=120, coverage=4)
    pt, _ = simulate_session(np.random.default_rng(21), ref_len=120,
                             coverage=4,
                             engine=TorchEngine("cpu", torch.float64))
    orig = pj.sequence
    assert pt.sequence == orig
    muts = [(10, orig[10], "A" if orig[10] != "A" else "C", 5.0),
            (50, orig[50], "", 3.0),                    # deletion
            (90, "", "G", 2.0),                         # insertion
            (30, orig[30], "T" if orig[30] != "T" else "G", -1.0)]
    pj.ApplyMuts([JMS(*m) for m in muts])
    pt.ApplyMuts([MutationScore(*m) for m in muts])
    assert pt.sequence == pj.sequence
    assert len(pt.sequence) == len(orig) and pt.sequence != orig
    assert pt.sequence[30] == orig[30]      # the negative one not applied
    for ej, et in zip(pj.events, pt.events):
        np.testing.assert_array_equal(et.ref_align, ej.ref_align)


def test_engine_multi_skips_empty_regions_as_jax(x64):
    """tests/test_multiregion.py::test_engine_multi_skips_empty_regions on
    TorchEngine(cpu, f64): the region with no mutations gets [] and its
    events stay untouched; the other region's scores equal TpuEngine's
    within 1e-8."""
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.engine.types import AlignData as JaxAlignData
    from poreseq_tpu.sim import simulate_session
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.types import AlignData

    from test_multiregion import _rand_muts

    rng = np.random.default_rng(101)
    pas = [simulate_session(rng, ref_len=150, coverage=3)[0],
           simulate_session(rng, ref_len=210, coverage=4)[0]]
    for pa in pas:
        pa.params.update(realign_width=24, scoring_width=8)
    muts = [_rand_muts(np.random.default_rng(8), pas[0].sequence, 5), []]
    out = {}
    for name, eng, make in (
            ("torch", TorchEngine("cpu", torch.float64),
             AlignData.from_session),
            ("jax", TpuEngine(dtype=jnp.float64),
             JaxAlignData.from_session)):
        datas = [make(pa) for pa in pas]
        before = [ev.ref_align.copy() for ev in datas[1].events]
        res = eng.score_mutations_multi(datas, muts)
        assert len(res[0]) == 5 and res[1] == []
        for ev, ra in zip(datas[1].events, before):
            np.testing.assert_array_equal(ev.ref_align, ra)
        out[name] = [m.score for m in res[0]]
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-8)


def test_merge_and_extract_equal_the_jax_cli(tmp_path):
    """`merge` on overlapping corrected fragments of two references (given
    out of order, over two files) and `extract` of a run's fast5 files,
    with and without -p: the port's output files equal the JAX CLI's byte
    for byte."""
    from poreseq_tpu_torch import cli

    truth, _, reads, _, _ = write_run(
        str(tmp_path / "run"), np.random.default_rng(4), ref_len=900,
        n_reads=5, draft_error=0.02)
    rng = np.random.default_rng(5)
    mut = lambda s: "".join(c if rng.random() > 0.01 else "ACGT"[
        int(rng.integers(0, 4))] for c in s)
    frags = [{"synthref:300:650": mut(truth[300:650]),
              "other:0:400": mut(truth[500:900])},
             {"synthref:0:400": mut(truth[:400]),
              "synthref:550:900": mut(truth[550:900]),
              "other:300:600": mut(truth[300:600][::-1])}]
    ins = []
    for k, f in enumerate(frags):
        ins.append(str(tmp_path / f"frag{k}.fasta"))
        write_fasta(ins[-1], f)
    runs = []
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        d = tmp_path / name
        d.mkdir()
        main(["merge", str(d / "merged.fasta"), *ins])
        main(["extract", reads, str(d / "reads.fasta")])
        main(["extract", reads, str(d / "paths.fasta"), "-p"])
        runs.append({p.name: p.read_bytes() for p in d.iterdir()})
    assert runs[0] == runs[1]
    merged = read_fasta(str(tmp_path / "port" / "merged.fasta"))
    assert list(merged) == ["synthref", "other"]
    assert swalign(merged["synthref"], truth)[0] > 95.0
    assert len(read_fasta(str(tmp_path / "port" / "reads.fasta"))) >= 5


@pytest.mark.slow
def test_split_consensus_merge_on_the_port(tmp_path):
    """tests/test_lambda_e2e.py::test_split_consensus_merge on the port
    (`split`, `consensus`, `merge`), with the JAX package's checks: at
    least 3 fragments, one merged sequence, at least 95 % of the truth's
    length and 99 % accurate.  The consensus runs on the port's CPU engine,
    `--backend exact` (about 5 CPU minutes): the TorchEngine's twins on
    the CPU take well over an hour at these widths.  tests/test_torch_exact.py
    holds that engine to the JAX one, tests/test_torch_f32_e2e.py and the
    card's phase 8 hold the TorchEngine to it."""
    from poreseq_tpu_torch import cli

    d = str(tmp_path)
    truth, _, reads, bam, fasta = write_run(
        d, np.random.default_rng(7), ref_len=3400, n_reads=24,
        read_len=1600, draft_error=0.02)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write("realign_width = 300\nscoring_width = 100\npoint_width = 20\n"
                "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 200\n"
                "max_length = 10000\nlik_offset = 4.5\n")
    cli.main(["split", fasta, "-R", "1800", "-n", "1"])
    rf = os.path.splitext(fasta)[0] + ".1.region"
    regions = [ln.strip() for ln in open(rf) if ln.strip()]
    assert len(regions) >= 3
    out = os.path.join(d, "corrected.fasta")
    cli.main(["consensus", fasta, bam, reads, "-R", rf, "-p", conf, "-o",
              out, "-i", "2", "--backend", "exact"])
    assert len(read_fasta(out)) >= 3
    merged = os.path.join(d, "merged.fasta")
    cli.main(["merge", merged, out])
    seqs = read_fasta(merged)
    assert len(seqs) == 1
    final = next(iter(seqs.values()))
    assert len(final) > 0.95 * len(truth)
    assert swalign(final, truth)[0] >= 99.0


@pytest.mark.slow
def test_44_region_lockstep_batch_on_the_port(tmp_path):
    """tests/test_bigbatch.py::test_44_region_lockstep_batch on the port:
    44 regions of 300 b through one --region-batch 44 at widths 16/8/6."""
    from poreseq_tpu_torch import cli

    d = str(tmp_path)
    R, L = 44, 300
    truth, _, reads, bam, fasta = write_run(
        d, np.random.default_rng(11), ref_len=R * L, n_reads=2 * R,
        read_len=L + 150, draft_error=0.02)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
                "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 100\n"
                "max_length = 10000\nlik_offset = 4.5\n")
    rf = os.path.join(d, "regions.txt")
    with open(rf, "w") as f:
        f.write("\n".join(f"synthref:{r * L}:{(r + 1) * L}"
                          for r in range(R)) + "\n")
    out = os.path.join(d, "out.fasta")
    cli.main(["consensus", fasta, bam, reads, "-R", rf, "-p", conf, "-o",
              out, "-i", "2", "--device", "cpu", "--region-batch", str(R)])
    seqs = read_fasta(out)
    assert len(seqs) >= R - 6
    accs = np.asarray([swalign(s, truth[max(int(n.split(":")[1]) - 400, 0)
                                        : int(n.split(":")[2]) + 400])[0]
                       for n, s in seqs.items()], dtype=np.float64)
    assert int(np.sum(np.isnan(accs))) <= 2
    assert float(np.nanmean(accs)) >= 97.5


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_train_on_the_port(tmp_path):
    """tests/test_distributed.py::test_two_process_distributed_train on the
    port: two `train --coordinator` processes (the exact backend, as the
    original) each evaluate half the proposals; both write the same best
    line, and train_best.conf is written."""
    from poreseq_tpu.core.params import load_params

    d = str(tmp_path)
    _, _, reads, bam, fasta = write_run(
        d, np.random.default_rng(11), ref_len=600, n_reads=9, read_len=260,
        draft_error=0.02)
    conf = os.path.join(d, "train.conf")
    with open(conf, "w") as f:
        f.write("realign_width = 100\nscoring_width = 50\npoint_width = 12\n"
                "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
                "max_length = 10000\nlik_offset = 4.5\n"
                "skip_t = 0.141\nskip_c = 0.088\nstay_t = 0.043\n"
                "stay_c = 0.057\nextend_t = 0.072\nextend_c = 0.046\n"
                "insert_t = 0.020\ninsert_c = 0.025\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    d2 = tmp_path / "two"
    d2.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "poreseq_tpu_torch.cli", "train", fasta, bam,
         reads, "-p", conf, "-r", "synthref:0:200", "-i", "1", "-n", "1",
         "--backend", "exact", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid)],
        env=env, cwd=str(d2), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=1800) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert load_params(str(d2 / "train_best.conf"))
    lines = [[ln for ln in se.splitlines() if ln.startswith("Best at iter 1")]
             for _, se in outs]
    assert lines[0] and lines[0] == lines[1]
