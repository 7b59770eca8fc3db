"""The port's `variant` and `train` subcommands on CPU (plain twins, f64):
variant scores against the exact engine and TpuEngine(float64), train's
best-parameter file, and the failure units of both."""

import os

import numpy as np
import pytest
import torch

from poreseq_tpu import api
from poreseq_tpu.core.params import load_params
from poreseq_tpu.io.fasta import write_fasta
from poreseq_tpu.sim import mutate_seq, write_run

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

CONF = ("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
        "max_length = 10000\nlik_offset = 4.5\n")
TRAIN_CONF = CONF + ("skip_t = 0.141\nskip_c = 0.088\nstay_t = 0.043\n"
                     "stay_c = 0.057\nextend_t = 0.072\nextend_c = 0.046\n"
                     "insert_t = 0.020\ninsert_c = 0.025\n")
REGION = "synthref:0:180"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 180 b run with no draft error, a copy of the reference with one
    planted substitution, a mutation file that reverts it and corrupts
    another base, and a variant FASTA (the truth and a 5 %-mutated copy)."""
    d = tmp_path_factory.mktemp("torchvar")
    truth, _, reads, bam, fasta = write_run(
        str(d), np.random.default_rng(8), ref_len=180, n_reads=5,
        draft_error=0.0)
    pos, bad = 70, 120
    planted = truth[:pos] + ("A" if truth[pos] != "A" else "C") \
        + truth[pos + 1 :]
    ref2 = str(d / "planted.fasta")
    write_fasta(ref2, {"synthref": planted})
    muts = str(d / "muts.txt")
    with open(muts, "w") as f:
        f.write("# comment line\n")
        f.write("{} {} {}\n".format(pos, planted[pos], truth[pos]))
        f.write("{} {} {}\n".format(bad, planted[bad],
                                    "A" if planted[bad] != "A" else "C"))
    var = str(d / "variants.fasta")
    write_fasta(var, {"good": truth, "bad": mutate_seq(
        np.random.default_rng(3), truth, 0.05)})
    conf = d / "params.conf"
    conf.write_text(CONF)
    tconf = d / "train.conf"
    tconf.write_text(TRAIN_CONF)
    return dict(dir=d, truth=truth, reads=reads, bam=bam, fasta=fasta,
                planted=ref2, muts=muts, var=var, conf=str(conf),
                tconf=str(tconf))


@pytest.fixture
def f64_cli(monkeypatch):
    """The port's CLI with its engine made in float64 on the CPU."""
    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.engine import TorchEngine

    monkeypatch.setattr(cli, "TorchEngine", lambda device: TorchEngine(
        device=device, dtype=torch.float64))
    return cli


def _mode_args(run, mode):
    return {"m": (run["planted"], ["-m", run["muts"]]),
            "a": (run["fasta"], ["-a"]),
            "f": (run["fasta"], ["-f", run["var"]])}[mode]


def _scores(text, mode):
    """{key: score} from variant's stdout: 'vid, score' lines for -f,
    MutationScore lines (start, orig, mut, score) for -m / -a."""
    out = {}
    for line in text.splitlines():
        if mode == "f":
            vid, score = line.rsplit(", ", 1)
            out[vid] = float(score)
        elif line.strip():
            start, orig, mut, score = line.split("\t")
            out[(int(start), orig, mut)] = float(score)
    return out


def _reference_scores(run, mode, capsys, backend):
    """pipeline.variant on another backend with the CLI's inputs."""
    from poreseq_tpu.core.regions import MutationInfo
    from poreseq_tpu.pipeline import variant

    ref, _ = _mode_args(run, mode)
    muts = ([MutationInfo(l) for l in open(run["muts"])] if mode == "m"
            else [])
    muts = [m for m in muts if m.start >= 0]
    params = dict(load_params(run["conf"]), end_trim=0)
    capsys.readouterr()
    variant(ref, run["bam"], run["reads"],
            run["var"] if mode == "f" else None, muts, REGION, params, 0,
            backend=backend)
    return _scores(capsys.readouterr().out, mode)


@pytest.mark.parametrize("mode", ["m", "a", "f"])
def test_variant_matches_exact_engine(run, f64_cli, capsys, mode):
    ref, flags = _mode_args(run, mode)
    capsys.readouterr()
    f64_cli.main(["variant", ref, run["bam"], run["reads"], *flags, "-r",
                  REGION, "-p", run["conf"], "--device", "cpu"])
    got = _scores(capsys.readouterr().out, mode)
    exp = _reference_scores(run, mode, capsys, "exact")
    assert got.keys() == exp.keys() and len(got) > 0
    for k in exp:
        # TpuEngine and the exact engine disagree on mutations at a
        # region's last bases (tests/test_tpu_engine.py draws them below
        # len - 6); the port follows TpuEngine there (the next test)
        if mode == "f" or k[0] < len(run["truth"]) - 6:
            assert abs(got[k] - exp[k]) <= 1e-8, (k, got[k], exp[k])
    if mode == "m":
        revert, corrupt = sorted(got)
        assert got[revert] > 0 > got[corrupt]
    if mode == "f":
        assert got["good"] > got["bad"]


def test_variant_all_matches_tpu_engine_f64(run, f64_cli, capsys,
                                            monkeypatch):
    import jax
    import jax.numpy as jnp

    from poreseq_tpu.engine.tpu import TpuEngine

    f64_cli.main(["variant", run["fasta"], run["bam"], run["reads"], "-a",
                  "-r", REGION, "-p", run["conf"], "--device", "cpu"])
    got = _scores(capsys.readouterr().out, "a")
    jax.config.update("jax_enable_x64", True)
    try:
        monkeypatch.setitem(api._ENGINES, "tpu", TpuEngine(dtype=jnp.float64))
        exp = _reference_scores(run, "a", capsys, "tpu")
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.keys() == exp.keys() and len(got) > 0
    assert max(abs(got[k] - exp[k]) for k in exp) <= 1e-8


def _two_candidates(monkeypatch, cli):
    """train with 2 proposals of 1 rep each (the CLI path, not the
    numerics: tests/test_torch_lockstep.py holds those)."""
    from poreseq_tpu_torch import pipeline

    real = pipeline.train_candidates
    monkeypatch.setattr(pipeline, "train_candidates",
                        lambda *a, **kw: real(*a, **{**kw, "reps": 1}))
    monkeypatch.setattr(cli, "vary_params", lambda p, rng=None: [
        dict(p), dict(p, skip_t=p["skip_t"] * 1.1)])


def test_train_writes_best_params(run, f64_cli, monkeypatch, tmp_path,
                                  capsys):
    _two_candidates(monkeypatch, f64_cli)
    monkeypatch.chdir(tmp_path)
    # -d descends from the (error-free) draft: the CLI path at little cost
    f64_cli.main(["train", run["fasta"], run["bam"], run["reads"], "-i",
                  "1", "-n", "1", "-p", run["tconf"], "-r", REGION, "-d",
                  "--device", "cpu"])
    best = load_params(str(tmp_path / "train_best.conf"))
    assert best["skip_t"] in (0.141, 0.141 * 1.1)
    assert all(best[k] > 0 for k in best if k[-2:] in ("_t", "_c"))
    assert "Best at iter 1:" in capsys.readouterr().err


def test_variant_skips_a_region_that_fails_to_load(run, f64_cli, capsys):
    f64_cli.main(["variant", run["fasta"], run["bam"], run["reads"], "-a",
                  "-r", "nosuchref:0:100", "-p", run["conf"], "--device",
                  "cpu"])
    out = capsys.readouterr()
    assert "Skipping nosuchref:0:100" in out.err and out.out == ""


@pytest.mark.parametrize("subcommand", ["variant", "train"])
def test_engine_failure_ends_the_run(run, f64_cli, monkeypatch, tmp_path,
                                     subcommand):
    """A kernel failure inside the engine is not a region's failure: it
    raises out of the CLI (the process exits non-zero)."""
    from poreseq_tpu_torch import EngineError
    from poreseq_tpu_torch.engine import fill as fill_mod

    def failing_fill(*a, **k):
        raise RuntimeError("fill.psq_fill_f64: CUDA error 700")

    monkeypatch.setattr(fill_mod, "fill_reference", failing_fill)
    monkeypatch.chdir(tmp_path)
    if subcommand == "variant":
        argv = ["variant", run["fasta"], run["bam"], run["reads"], "-a",
                "-r", REGION, "-p", run["conf"]]
    else:
        _two_candidates(monkeypatch, f64_cli)
        argv = ["train", run["fasta"], run["bam"], run["reads"], "-i", "1",
                "-p", run["tconf"], "-r", REGION]
    with pytest.raises(EngineError, match="CUDA error 700"):
        f64_cli.main(argv + ["--device", "cpu"])
    assert not os.path.exists(tmp_path / "train_best.conf")
