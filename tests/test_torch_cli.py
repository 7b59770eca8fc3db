"""The port's command line end to end on CPU (plain twins): lockstep
consensus improves a synthetic draft, resumes, retries a batch that runs
out of memory, raises on a kernel failure, and runs without jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from poreseq_tpu.api import swalign
from poreseq_tpu.io.fasta import read_fasta
from poreseq_tpu.sim import write_run

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONF = ("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
        "max_length = 10000\nlik_offset = 4.5\n")


def _run(tmp_path, ref_len, n_reads, read_len, regions, seed=0):
    truth, draft, reads_dir, bam, fasta = write_run(
        str(tmp_path), np.random.default_rng(seed), ref_len=ref_len,
        n_reads=n_reads, read_len=read_len, draft_error=0.03)
    conf = tmp_path / "params.conf"
    conf.write_text(CONF)
    rf = tmp_path / "regions.txt"
    rf.write_text("\n".join(regions) + "\n")
    return truth, draft, [fasta, bam, reads_dir, "-R", str(rf), "-p",
                          str(conf)]


def _acc(seq, truth, name):
    a, b = int(name.split(":")[1]), int(name.split(":")[2])
    return swalign(seq, truth[max(a - 100, 0) : b + 100])[0]


def test_cli_consensus_region_batch_improves_accuracy(tmp_path, capsys):
    from poreseq_tpu_torch import cli

    regions = ["synthref:0:200", "synthref:200:400"]
    truth, draft, args = _run(tmp_path, 400, 6, 240, regions)
    out = tmp_path / "out.fasta"
    cli.main(["consensus", *args, "-o", str(out), "-i", "1",
              "--region-batch", "2", "--device", "cpu"])
    seqs = read_fasta(str(out))
    assert list(seqs) == regions
    before = np.mean([_acc(draft[int(n.split(":")[1]) : int(n.split(":")[2])],
                           truth, n) for n in regions])
    after = np.mean([_acc(s, truth, n) for n, s in seqs.items()])
    assert after > before
    # a resumed run skips the regions already in the output
    cli.main(["consensus", *args, "-o", str(out), "-i", "1",
              "--region-batch", "2", "--device", "cpu", "--resume"])
    assert read_fasta(str(out)) == seqs
    assert capsys.readouterr().err.count("Resuming past") == 2


@pytest.mark.parametrize("error", ["kernel", "out_of_memory"])
def test_cli_halves_batch_only_on_out_of_memory(tmp_path, capsys,
                                                monkeypatch, error):
    # a failing kernel (or build) raises out of the CLI; only running out of
    # memory retries the batch at half its width
    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.engine import fill as fill_mod

    regions = ["synthref:0:100", "synthref:100:200"]
    _, _, args = _run(tmp_path, 200, 4, 140, regions, seed=2)
    out = tmp_path / "out.fasta"
    real, calls = fill_mod.fill_reference, []

    def failing_fill(*a, **k):
        calls.append(1)
        if error == "kernel":
            raise RuntimeError("fill.psq_fill_f32: CUDA error 700")
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(*a, **k)

    monkeypatch.setattr(fill_mod, "fill_reference", failing_fill)
    argv = ["consensus", *args, "-o", str(out), "-i", "1",
            "--region-batch", "2", "--device", "cpu"]
    if error == "kernel":
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            cli.main(argv)
        assert len(calls) == 1
        assert read_fasta(str(out)) == {}
    else:
        cli.main(argv)
        assert "retrying at 1" in capsys.readouterr().err
        assert list(read_fasta(str(out))) == regions


def test_port_runs_consensus_without_jax(tmp_path):
    """consensus, variant -a and split run in one process that never
    imports jax, nor any module of the JAX package poreseq_tpu."""
    regions = ["synthref:0:150"]
    _, draft, args = _run(tmp_path, 150, 4, None, regions, seed=1)
    out = tmp_path / "out.fasta"
    argvs = [["consensus", *args, "-o", str(out), "-i", "1", "--device",
              "cpu"],
             ["variant", *args[:3], "-a", "-r", "synthref:40:110", "-p",
              args[-1], "--device", "cpu"],
             ["split", args[0], "-R", "2000", "-n", "1"]]
    code = (
        "import json, sys\n"
        "import poreseq_tpu_torch\n"
        "from poreseq_tpu_torch import cli\n"
        f"for argv in {json.dumps(argvs)}:\n"
        "    cli.main(argv)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
        "in ('jax', 'jaxlib', 'poreseq_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == []
    assert list(read_fasta(str(out))) == regions
    # one score line per point mutation of the 70 b region
    assert len(lines) > 70 * 7
    assert all(l.split("\t")[0].isdigit() for l in lines[:-1])
    assert (tmp_path / "ref.1.region").read_text() == "synthref:0:{}\n".format(
        len(draft))
