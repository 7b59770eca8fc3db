"""tools/genome_run.py (the port's split -> consensus -> merge on a
simulated genome, the counterpart of scripts/bench_lambda.py and
scripts/bench_ecoli.py) on the CPU at a tiny size: a 2.4 kb genome, reads
of the whole genome (longer than the regions, so they carry a trim hint),
two shards dealt round-robin, narrow widths.

Under --backend exact each shard's output equals the JAX CLI's consensus
--backend exact on the same shard byte for byte, and the merged FASTA the
JAX merge of those outputs.  A TorchEngine run cannot be compared end to end
with TpuEngine (the Viterbi draws differ, ROADMAP §C), so the TorchEngine
run on the CPU (slow: the fill twins run a Python loop per column) checks
that it merges into one contig and prints every field."""

import ast
import json
import tempfile
from pathlib import Path

import pytest
import torch

from poreseq_tpu import cli as jcli
from poreseq_tpu.engine.exact._native import LIB as JLIB
from poreseq_tpu_torch.engine import _native
from tools import genome_run

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONF = ("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
        "max_length = 10000\nlik_offset = 4.5\n")
FIELDS = ("genome_bp", "regions", "regions_done", "regions_skipped",
          "consensus_s", "kb_per_hour", "regions_per_hour", "merged_contigs",
          "merged_accuracy_pct", "peak_device_mib", "card", "power_limit")
# 1,050 b regions overlap by 1 kb: the first two of each shard's deal
TINY = ["sharded", "--genome", "2400", "--region-length", "1050",
        "--read-len", "2400", "--shards", "2", "--limit", "1",
        "--iterations", "1"]


def _script_defaults(name: str) -> dict:
    """{dest: default} of a JAX script's add_argument calls."""
    out = {}
    for node in ast.walk(ast.parse((REPO / "scripts" / name).read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            dest = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            out[dest] = (ast.literal_eval(kw["default"]) if "default" in kw
                         else False)
    return out


@pytest.mark.parametrize("mode,script", [("lambda", "bench_lambda.py"),
                                         ("sharded", "bench_ecoli.py")])
def test_genome_run_takes_the_scripts_arguments(mode, script):
    """Each mode takes its JAX script's arguments with their defaults (the
    backend's default is the port's engine, the read length's the region
    length + 400 as in bench_lambda.py), on the card unless --device says
    otherwise."""
    args = vars(genome_run.parse([mode]))
    for dest, default in _script_defaults(script).items():
        if dest == "backend":
            assert args[dest] == "torch"
        elif dest == "read_len" and default is None:
            assert args[dest] == args["region_length"] + 400
        else:
            assert args[dest] == default, dest
    assert args["device"] == "cuda" and args["params"] is None


def test_genome_run_exact_is_byte_equal_to_the_jax_cli(tmp_path,
                                                       monkeypatch, capsys):
    conf = tmp_path / "narrow.conf"
    conf.write_text(CONF)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _native.srand(1)
    genome_run.main(TINY + ["--backend", "exact", "--params", str(conf),
                         "--keep"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(k in res for k in FIELDS)
    assert res["regions"] == res["regions_done"] == 2
    assert res["merged_contigs"] == 1 and res["merged_accuracy_pct"] > 95
    assert res["peak_device_mib"] is None and res["card"] is None
    d = Path(res["workdir"])
    common = [str(d / "ref.fasta"), str(d / "reads.bam"), str(d / "reads"),
              "-R", str(d / "regions.txt"), "-p", str(d / "params.conf"),
              "-i", "1", "--backend", "exact", "--region-batch", "8",
              "--num-shards", "2"]
    # the tool ran its shards one after the other in one process, so the
    # JAX CLI's shards share one libc rand() sequence too
    JLIB.psq_srand(1)
    outs = []
    for si in range(2):
        out = tmp_path / f"jax.s{si}.fasta"
        jcli.main(["consensus", *common, "--shard-index", str(si), "-o",
                   str(out)])
        outs.append(str(out))
        assert out.read_bytes() == (d / f"out.s{si}.fasta").read_bytes()
        assert out.read_bytes().count(b">") == 1
    jcli.main(["merge", str(tmp_path / "jax.merged.fasta"), *outs])
    assert ((tmp_path / "jax.merged.fasta").read_bytes()
            == (d / "merged.fasta").read_bytes())


@pytest.mark.slow
def test_genome_run_torch_on_the_cpu(tmp_path, capsys):
    """The TorchEngine on the CPU (about 150 s on one core)."""
    conf = tmp_path / "narrow.conf"
    conf.write_text(CONF)
    genome_run.main(TINY + ["--device", "cpu", "--params", str(conf)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(k in res for k in FIELDS)
    assert res["device"] == "cpu" and res["peak_device_mib"] is None
    assert res["regions_done"] == 2 and res["merged_contigs"] == 1
    assert res["merged_accuracy_pct"] > 95
