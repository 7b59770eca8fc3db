"""The port's exact backend (``engine/exact``, ``--backend exact``,
``PSAlign(backend="exact")``) against the JAX package's, bit for bit:
every ExactEngine method, sessions through the API, every golden fixture
of the reference C++ (tests/golden/) at tests/test_golden.py's exactness,
and the CLI's output byte for byte.

Both C++ cores draw their Viterbi candidates from libc rand(), whose state
the two libraries share in one process: each Viterbi call is seeded with
its own library's psq_srand right before it."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from poreseq_tpu.api import PSAlign as JPSAlign
from poreseq_tpu.engine.driver import find_point_mutations as jpoints
from poreseq_tpu.engine.exact import ExactEngine as JExactEngine
from poreseq_tpu.engine.exact._native import LIB as JLIB
from poreseq_tpu.engine.types import AlignData as JAlignData
from poreseq_tpu.sim import simulate_session as jsession
from poreseq_tpu_torch.api import PSAlign, get_engine
from poreseq_tpu_torch.core.regions import MutationInfo
from poreseq_tpu_torch.engine.driver import (find_mutations,
                                             find_point_mutations,
                                             make_mutations)
from poreseq_tpu_torch.engine import _native
from poreseq_tpu_torch.engine.exact import ExactEngine
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.sim import mutate_seq, simulate_session
from poreseq_tpu_torch.sim import write_run
from test_torch_golden import _fixture, _session

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WIDTHS = dict(realign_width=48, scoring_width=24, point_width=12, verbose=0)
CONF = ("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
        "max_length = 10000\nlik_offset = 4.5\n")


def _pair(seed, **kw):
    """The same simulated session on the port's exact backend and on the
    JAX package's (the two simulators are equal, test_torch_host.py)."""
    kw = dict(ref_len=200, coverage=6, draft_error=0.03,
              params=dict(WIDTHS), **kw)
    pp, truth = simulate_session(np.random.default_rng(seed),
                                 backend="exact", **kw)
    pj, _ = jsession(np.random.default_rng(seed), backend="exact", **kw)
    return pp, pj, truth


def _events_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.ref_align, y.ref_align)
        np.testing.assert_array_equal(x.ref_like, y.ref_like)


def test_the_backend_switch():
    """PSAlign(backend="exact") shares one ExactEngine, a given engine wins,
    and an unknown backend is refused when the engine is asked for."""
    pa = PSAlign(backend="exact")
    assert isinstance(pa.engine, ExactEngine) and pa.engine.name == "exact"
    assert pa.engine is get_engine("exact") is pa.Copy().engine
    eng = ExactEngine()
    assert PSAlign(backend="exact", engine=eng).engine is eng
    with pytest.raises(ValueError, match="unknown backend"):
        PSAlign(backend="tpu").engine
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("method", ["score_alignments", "score_mutations",
                                    "map_alignments", "swalign",
                                    "viterbi_mutate"])
def test_exact_engine_equals_jax(method):
    pp, pj, truth = _pair(17)
    dp, dj = AlignData.from_session(pp), JAlignData.from_session(pj)
    port, jax_ = ExactEngine(), JExactEngine()
    if method == "score_alignments":
        lp, lj = np.zeros(len(pp.sequence)), np.zeros(len(pj.sequence))
        assert port.score_alignments(dp, likes=lp) == \
            jax_.score_alignments(dj, likes=lj)
        np.testing.assert_array_equal(lp, lj)
        _events_equal(dp.events, dj.events)
    elif method == "score_mutations":
        # a Refine-sized set: every point mutation at the point width
        dp.params.scoring_width = dj.params.scoring_width = 12
        muts = find_point_mutations(dp)
        assert [(m.start, m.orig, m.mut) for m in muts] == [
            (m.start, m.orig, m.mut) for m in jpoints(dj)]
        got = port.score_mutations(dp, muts)
        exp = jax_.score_mutations(dj, jpoints(dj))
        assert len(got) > 1000
        assert [g.score for g in got] == [e.score for e in exp]
        _events_equal(dp.events, dj.events)
    elif method == "map_alignments":
        var = mutate_seq(np.random.default_rng(5), pp.sequence, 0.05)
        (ap, pairs_p), (aj, pairs_j) = (port.map_alignments(dp, var),
                                        jax_.map_alignments(dj, var))
        assert ap == aj and dp.sequence == dj.sequence == var
        np.testing.assert_array_equal(pairs_p, pairs_j)
        for x, y in zip(dp.events, dj.events):
            np.testing.assert_array_equal(x.ref_align, y.ref_align)
    elif method == "swalign":
        rng = np.random.default_rng(2)
        for n in (0, 1, 40, 200):
            a = pp.sequence[:n]
            b = mutate_seq(rng, truth[:n + 7], 0.1)
            got, exp = ExactEngine.swalign(a, b), JExactEngine.swalign(a, b)
            np.testing.assert_equal(got[0], exp[0])      # NaN-safe
            assert got[1] == exp[1]
    else:
        _native.srand(7)
        got = port.viterbi_mutate(dp.events, 16, 0.05, 0.01, 0.33, 0.75)
        JLIB.psq_srand(7)
        exp = jax_.viterbi_mutate(dj.events, 16, 0.05, 0.01, 0.33, 0.75)
        assert got == exp and len(got) == 16
        # the state is libc's, shared: the same seed through either library
        JLIB.psq_srand(7)
        assert port.viterbi_mutate(dp.events, 16, 0.05, 0.01, 0.33,
                                   0.75) == exp


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_exact_sessions_equal_jax(seed):
    """PSAlign(backend="exact") Mutate (the reads, then Viterbi candidates)
    and Refine give the JAX session's sequences at every step."""
    pp, pj, _ = _pair(seed)
    steps = []
    for call in ("self", "viterbi", "refine"):
        if call == "refine":
            got, exp = pp.Refine(), pj.Refine()
        else:
            if call == "viterbi":
                _native.srand(seed)
            got = pp.Mutate(seqs=call, reps=2)
            if call == "viterbi":
                JLIB.psq_srand(seed)
            exp = pj.Mutate(seqs=call, reps=2)
        assert (got, pp.sequence) == (exp, pj.sequence), call
        steps.append(got)
    _events_equal(pp.events, pj.events)
    assert steps[0] > 0


GOLDEN = sorted(p.stem for p in (REPO / "tests" / "golden").glob("*.npz"))


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_fixture_on_the_exact_backend(name):
    """tests/test_golden.py's cases, exact f64 equality, on the port's
    exact backend; viterbi_a's candidates under glibc's first seed, 1."""
    d = _fixture(name)
    if name.startswith("swfull"):
        from poreseq_tpu_torch.engine.exact.sw import swfull

        acc, pairs, score = swfull(str(d["seq1"]), str(d["seq2"]))
        assert acc == float(d["out_acc"]) and score == int(d["out_score"])
        np.testing.assert_array_equal(pairs[:, 0], d["out_i1"])
        np.testing.assert_array_equal(pairs[:, 1], d["out_i2"])
        return
    pa = _session(d, get_engine("exact"))
    data = AlignData.from_session(pa)
    eng = pa.engine
    if name.startswith("score_events"):
        likes = np.zeros(len(pa.sequence))
        np.testing.assert_array_equal(
            eng.score_alignments(data, likes=likes), d["out_scores"])
        np.testing.assert_array_equal(likes, d["out_likes"])
    elif name.startswith("score_muts"):
        muts = []
        for s, o, m in zip(d["mut_starts"], d["mut_origs"], d["mut_muts"]):
            mi = MutationInfo()
            mi.start, mi.orig, mi.mut = int(s), str(o), str(m)
            muts.append(mi)
        np.testing.assert_array_equal(
            [ms.score for ms in eng.score_mutations(data, muts)],
            d["out_scores"])
    elif name.startswith("viterbi"):
        _native.srand(1)       # the oracle process's glibc default seed
        assert eng.viterbi_mutate(data.events, int(d["nkeep"]), 0.05, 0.01,
                                  0.33, 0.75) == [str(s)
                                                  for s in d["out_seqs"]]
        return
    elif name.startswith("mutate"):
        seqs = [ev.sequence for ev in pa.events[::2]]
        totbases = 0
        for _ in range(int(d["reps"])):
            nb = make_mutations(eng, data, eng.score_mutations(
                data, find_mutations(eng, data, seqs)))
            if nb == 0:
                break
            totbases += nb
        assert (data.sequence, totbases) == (str(d["out_seq"]),
                                             int(d["out_nbases"]))
    else:                                   # refine
        data.params.scoring_width = int(d["point_width"])
        scores = eng.score_mutations(data, find_point_mutations(data))
        np.testing.assert_array_equal([ms.score for ms in scores],
                                      d["out_scores"])
        nb = make_mutations(eng, data, scores)
        assert (data.sequence, nb) == (str(d["out_seq"]),
                                       int(d["out_nbases"]))
    if name.startswith("refine"):
        return                      # the fixture keeps no events
    for i, ev in enumerate(data.events):
        np.testing.assert_array_equal(ev.ref_align, d[f"out_ev{i}_ref_align"])
        np.testing.assert_array_equal(ev.ref_like, d[f"out_ev{i}_ref_like"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("exact_run")
    truth, draft, reads, bam, fasta = write_run(
        str(d), np.random.default_rng(4), ref_len=400, n_reads=6,
        draft_error=0.03)
    (d / "params.conf").write_text(CONF)
    (d / "regions.txt").write_text("synthref:0:200\nsynthref:200:400\n")
    return dict(dir=d, reads=reads, bam=bam, fasta=fasta,
                conf=str(d / "params.conf"), regions=str(d / "regions.txt"))


def test_pipeline_exact_equals_sequential_jax(run):
    """mutate_many and train_candidates on backend="exact" run their
    sessions one after another: the JAX package's sequential mutate()."""
    from poreseq_tpu import pipeline as jpipe
    from poreseq_tpu_torch import pipeline as ppipe

    regions = ["synthref:0:200", "synthref:200:400"]
    params = dict(realign_width=16, scoring_width=8, point_width=6,
                  min_overlap=50, min_coverage=0, max_coverage=30)
    args = (run["fasta"], run["bam"], run["reads"])
    _native.srand(1)
    got = ppipe.mutate_many(*args, regions, params=params, reps=2,
                            backend="exact")
    JLIB.psq_srand(1)
    exp = [jpipe.mutate(*args, region=r, params=params, reps=2,
                        backend="exact") for r in regions]
    assert got == exp and got[0][0]
    cands = [dict(params, skip_t=0.141), dict(params, skip_t=0.2)]
    _native.srand(1)
    got = ppipe.train_candidates(*args, regions[0], cands, descend=True,
                                 reps=2, backend="exact", verbose=0)
    JLIB.psq_srand(1)
    exp = [jpipe.mutate(*args, region=regions[0], params=p, reps=2,
                        backend="exact") for p in cands]
    assert got == exp


# the port's CLI in a fresh process (libc rand() at its first seed, as in
# any new process) that must load no jax, no poreseq_tpu module and never
# start CUDA or make a TorchEngine
_CHILD = """
import json, sys
import torch
import poreseq_tpu_torch.engine as pe
from poreseq_tpu_torch import cli
from poreseq_tpu_torch.engine import _native

def refuse(*a, **k):
    raise AssertionError("--backend exact reached CUDA or a TorchEngine")

torch.cuda._lazy_init = refuse
pe.TorchEngine.__init__ = refuse
for argv in json.loads(sys.argv[1]):
    _native.srand(1)
    cli.main(argv)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('jax', 'jaxlib',
                                               'poreseq_tpu'))))
"""


def test_cli_exact_is_byte_equal_to_the_jax_cli(run, tmp_path, capsys):
    from poreseq_tpu import cli as jcli

    common = [run["fasta"], run["bam"], run["reads"]]
    cons = [*common, "-R", run["regions"], "-p", run["conf"], "-i", "2",
            "--backend", "exact"]
    var = [*common, "-a", "-r", "synthref:40:110", "-p", run["conf"],
           "--backend", "exact"]
    JLIB.psq_srand(1)
    jcli.main(["consensus", *cons, "-o", str(tmp_path / "jax.fa")])
    JLIB.psq_srand(1)
    jcli.main(["variant", *var])
    jax_variant = capsys.readouterr().out
    argvs = [["consensus", *cons, "-o", str(tmp_path / f"port{b}.fa"),
              "--region-batch", str(b)] for b in (1, 2)]
    argvs.append(["variant", *var])
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(argvs)],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert json.loads(lines[-1]) == []
    assert "\n".join(lines[:-1]) + "\n" == jax_variant
    assert len(lines) > 70 * 7
    expected = (tmp_path / "jax.fa").read_bytes()
    assert expected.count(b">") == 2
    for b in (1, 2):
        assert (tmp_path / f"port{b}.fa").read_bytes() == expected


@pytest.mark.parametrize("flags", [["--mesh", "2x2"], ["--device", "cpu"]])
def test_cli_exact_refuses_a_device(run, capsys, flags):
    from poreseq_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["consensus", run["fasta"], run["bam"], run["reads"], "-R",
                  run["regions"], "-p", run["conf"], "--backend", "exact",
                  *flags])
    err = capsys.readouterr().err
    assert e.value.code == 2 and err.count("\n") == 1
    assert flags[0] in err


@pytest.mark.slow
def test_cli_train_exact_pool(run, tmp_path, capsys, monkeypatch):
    """train --backend exact -i 1 -n 2: 16 proposals over a pool of two
    spawned processes; the best goes to ./train_best.conf."""
    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.core.params import load_params

    conf = tmp_path / "train.conf"
    conf.write_text(CONF + "skip_t = 0.141\nskip_c = 0.088\nstay_t = 0.043\n"
                    "stay_c = 0.057\nextend_t = 0.072\nextend_c = 0.046\n"
                    "insert_t = 0.020\ninsert_c = 0.025\n")
    monkeypatch.chdir(tmp_path)
    cli.main(["train", run["fasta"], run["bam"], run["reads"], "-i", "1",
              "-n", "2", "-r", "synthref:0:180", "-p", str(conf), "-d",
              "--backend", "exact"])
    best = load_params(str(tmp_path / "train_best.conf"))
    assert all(best[k] > 0 for k in best if k[-2:] in ("_t", "_c"))
    assert "Best at iter 1:" in capsys.readouterr().err
    assert not torch.cuda.is_initialized()
