"""The port's own host layer (core/, io/, sim.py, api.py, pipeline.py,
engine/{types,driver,multi,sw}.py and the Smith-Waterman of its copy of
csrc/psq_exact.cpp) against the JAX package's originals on seeded inputs,
one parametrised test per layer, and a scan of the port's sources for any
import of the JAX package."""

import ast
import copy
import filecmp
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from poreseq_tpu import sim as jsim
from poreseq_tpu.engine import driver as jdriver
from poreseq_tpu.engine.exact import sw as jsw
from poreseq_tpu_torch import sim as psim
from poreseq_tpu_torch.engine import driver as pdriver
from poreseq_tpu_torch.engine import sw as psw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONF = dict(realign_width=16, scoring_width=8, point_width=6,
            min_coverage=0, max_coverage=30, min_overlap=50,
            max_length=10000, lik_offset=4.5)


def test_port_imports_nothing_of_the_jax_package():
    """No file of poreseq_tpu_torch/ (the device mesh, parallel/mesh.py,
    and the exact engine, engine/exact/ over engine/_native.py, among
    them) and no line of
    chip_smoke.py or the tools (tools/__init__.py, profile_phase3.py,
    sweep_constants.py, genome_run.py, bench.py, bench_consensus.py,
    bench_multihost.py, dryrun.py, fill_instances.py, obs_instances.py)
    imports poreseq_tpu
    (or jax), lazily inside a function or not."""
    files = sorted((REPO / "poreseq_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"] + [
        REPO / "tools" / f"{t}.py"
        for t in ("__init__", "profile_phase3", "sweep_constants",
                  "genome_run", "bench", "bench_consensus",
                  "bench_multihost", "dryrun", "fill_instances",
                  "obs_instances")]
    port = REPO / "poreseq_tpu_torch"
    assert port / "parallel" / "mesh.py" in files
    assert port / "engine" / "_native.py" in files
    assert {port / "engine" / "exact" / f"{m}.py" for m in (
        "__init__", "align", "sw", "viterbi")} <= set(files)
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("poreseq_tpu", "jax", "jaxlib")]
    assert len(files) > 30 and bad == []


def _seqs(rng, n, length):
    """Pairs of related sequences (a copy with 10 % edits) and unrelated
    ones, some empty."""
    out = [("", "ACGT"), ("ACGT", "")]
    for _ in range(n):
        a = psim.random_seq(rng, int(rng.integers(1, length)))
        b = psim.mutate_seq(rng, a, 0.1) if rng.random() < 0.7 else \
            psim.random_seq(rng, int(rng.integers(1, length)))
        out.append((a, b))
    return out


@pytest.mark.parametrize("fn", ["swfull", "swfast", "swalign",
                                "argsort_desc", "fillinds"])
def test_host_sw_equals_the_exact_core(fn):
    rng = np.random.default_rng(11)
    if fn == "argsort_desc":
        for n in (0, 1, 7, 40, 300):
            scores = np.round(rng.normal(0, 2, n))     # many exact ties
            np.testing.assert_array_equal(psw.argsort_desc(scores),
                                          jdriver._argsort_desc(scores))
        return
    for a, b in _seqs(rng, 40, 120):
        if fn == "fillinds":
            pairs = jsw.swfull(a, b)[1]
            np.testing.assert_array_equal(psw.fillinds(pairs),
                                          jsw.fillinds(pairs))
            continue
        if fn == "swfast":
            if not a or not b:
                continue
            args = (a, b, len(a) / len(b), float(rng.integers(-3, 4)),
                    int(rng.integers(8, 40)))
        else:
            args = (a, b)
        got, exp = getattr(psw, fn)(*args), getattr(jsw, fn)(*args)
        np.testing.assert_equal(got[0], exp[0])      # accuracy, NaN-safe
        if fn == "swalign":
            assert got[1] == exp[1]
        else:
            np.testing.assert_array_equal(got[1], exp[1])
            assert got[2] == exp[2]


def _session(mod, seed, **kw):
    pa, truth = mod.simulate_session(np.random.default_rng(seed),
                                     ref_len=150, coverage=4,
                                     draft_error=0.03, **kw)
    pa.params.update(CONF)
    return pa, truth


@pytest.mark.parametrize("fn", ["find_point_mutations", "extract_mutations",
                                "greedy_accept"])
def test_drivers_equal_their_originals(fn):
    from poreseq_tpu.engine.types import AlignData as JAlignData
    from poreseq_tpu_torch.engine.types import AlignData as PAlignData

    pa, _ = _session(jsim, 5)
    key = lambda ms: [(m.start, m.orig, m.mut) for m in ms]
    jdata, pdata = JAlignData.from_session(pa), PAlignData.from_session(pa)
    if fn == "find_point_mutations":
        assert key(pdriver.find_point_mutations(pdata)) == key(
            jdriver.find_point_mutations(jdata))
        return
    rng = np.random.default_rng(3)
    if fn == "extract_mutations":
        seqs = [psim.mutate_seq(rng, pa.sequence, 0.08) for _ in range(4)]
        likes, als = [], []
        for s in seqs:
            pairs = jsw.fillinds(jsw.swfull(pa.sequence, s)[1])
            dl, al = jdriver.candidate_dlikes(
                rng.normal(0, 1, len(pa.sequence)), rng.normal(0, 1, len(s)),
                pairs)
            likes.append(np.maximum(dl + rng.normal(0, 0.3, len(dl)), 0))
            als.append(al)
        got = pdriver.extract_mutations(pa.sequence, seqs,
                                        copy.deepcopy(likes), als)
        exp = jdriver.extract_mutations(pa.sequence, seqs,
                                        copy.deepcopy(likes), als)
        assert key(got) == key(exp) and len(got) > 0
        return
    muts = jdriver.find_point_mutations(jdata)
    for m in muts:          # ties and negatives: the accept order matters
        m.score = float(np.round(rng.normal(0, 1.5)))
    jm = [copy.copy(m) for m in muts]
    pm = [copy.copy(m) for m in muts]
    nb_j, extra_j = jdriver.greedy_accept(jdata, jm)
    nb_p, extra_p = pdriver.greedy_accept(pdata, pm)
    assert (nb_p, key(extra_p), pdata.sequence) == (nb_j, key(extra_j),
                                                    jdata.sequence)
    assert nb_p > 0 and pdata.sequence != pa.sequence


def _events_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for f in ("mean", "stdv", "length", "start", "ref_align",
                  "ref_like"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        for f in ("level_mean", "level_stdv", "sd_mean", "sd_stdv"):
            np.testing.assert_array_equal(getattr(x.model, f),
                                          getattr(y.model, f))
        assert x.sequence == y.sequence


@pytest.mark.parametrize("what", ["simulate_session", "write_run",
                                  "load_aligned_events"])
def test_sim_and_io_equal_their_originals(what, tmp_path):
    if what == "simulate_session":
        (pj, tj), (pp, tp) = _session(jsim, 9), _session(psim, 9)
        assert (pp.sequence, tp) == (pj.sequence, tj)
        _events_equal(pp.events, pj.events)
        return
    runs = {}
    for name, mod in (("jax", jsim), ("port", psim)):
        d = tmp_path / name
        runs[name] = mod.write_run(str(d), np.random.default_rng(2),
                                   ref_len=220, n_reads=4, read_len=180,
                                   draft_error=0.02)
    (tj, dj, rj, bj, fj), (tp, dp, rp, bp, fp) = runs["jax"], runs["port"]
    assert (tp, dp) == (tj, dj)
    if what == "write_run":
        assert filecmp.cmp(fj, fp, shallow=False)
        assert filecmp.cmp(bj, bp, shallow=False)
        names = sorted(os.listdir(rj))
        assert names == sorted(os.listdir(rp)) and len(names) == 4
        from poreseq_tpu.io.fast5 import load_event
        from poreseq_tpu_torch.io.fast5 import load_event as pload_event

        for n in names:
            assert filecmp.cmp(os.path.join(rj, n), os.path.join(rp, n),
                               shallow=False)
            for typ in ("t", "c"):
                _events_equal([pload_event(os.path.join(rp, n), typ)],
                              [load_event(os.path.join(rj, n), typ)])
        return
    from poreseq_tpu.core.regions import RegionInfo as JRegion
    from poreseq_tpu.io.load import load_aligned_events as jload
    from poreseq_tpu_torch.core.regions import RegionInfo as PRegion
    from poreseq_tpu_torch.io.load import load_aligned_events as pload

    for region in ("synthref:0:220", "synthref:40:160"):
        pj = jload(fj, bj, rj, JRegion(region), dict(CONF))
        pp = pload(fp, bp, rp, PRegion(region), dict(CONF))
        assert (pp.sequence, pp.params) == (pj.sequence, pj.params)
        _events_equal(pp.events, pj.events)


@pytest.mark.parametrize("ref_len,n_reads", [(150, 4), (220, 5)])
def test_port_pipeline_equals_jax_pipeline(ref_len, n_reads, tmp_path,
                                           monkeypatch):
    """The port's mutate_many and the JAX package's, both on one CPU f64
    TorchEngine (registered as the JAX package's backend "torch"), give the
    same sequences and accuracies."""
    from poreseq_tpu import api
    from poreseq_tpu import pipeline as jpipe
    from poreseq_tpu_torch import pipeline as ppipe
    from poreseq_tpu_torch.engine import TorchEngine

    _, _, reads, bam, fasta = psim.write_run(
        str(tmp_path), np.random.default_rng(ref_len), ref_len=ref_len,
        n_reads=n_reads, draft_error=0.03)
    regions = ["synthref:0:{}".format(ref_len)]
    out = {}
    for name in ("port", "jax"):
        eng = TorchEngine("cpu", torch.float64)
        if name == "port":
            out[name] = ppipe.mutate_many(fasta, bam, reads, regions,
                                          params=dict(CONF), reps=1,
                                          engine=eng)
        else:
            monkeypatch.setitem(api._ENGINES, "torch", eng)
            out[name] = jpipe.mutate_many(fasta, bam, reads, regions,
                                          params=dict(CONF), reps=1,
                                          backend="torch")
    assert out["port"] == out["jax"] and out["port"][0][0]
