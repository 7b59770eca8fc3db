"""The port's ``api.PSAlign`` against the reference C++'s fixtures
(tests/golden/, produced by tools/golden/oracle.cpp), on
``TorchEngine("cpu", torch.float64)`` alone and on a 2x2 CPU mesh, and the
port's twins of tests/test_consensus.py's API cases.

Tolerances (tests/test_tpu_engine.py's): scores and ref_like within 1e-9,
likes and mutation deltas within 1e-8, ref_align identical, final
sequences and base counts equal.  Mutations that start in a sequence's last
6 bases are held to the JAX TpuEngine in f64, not to the reference: there
TpuEngine and the reference already disagree (refine_a: by 1.948 at start
116 of 121), and the port follows TpuEngine.  viterbi_a is left out: its
candidates come from glibc rand().  The fixtures run at the reference's
default widths 300/150 (W = 601 on the CPU twins), so mutate_a and the
_a fixtures on the mesh are marked slow."""

import os

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.api import PSAlign
from poreseq_tpu_torch.core.events import Event, Model
from poreseq_tpu_torch.core.regions import MutationInfo
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine.driver import (find_mutations,
                                             find_point_mutations,
                                             make_mutations)
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.parallel.mesh import make_mesh

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
TAIL = 6      # a sequence's last bases, where TpuEngine sets the reference


def _engine(mesh: bool):
    return TorchEngine("cpu", torch.float64,
                       mesh=make_mesh(2, 2, ["cpu"] * 4) if mesh else None)


def _fixture(name):
    return np.load(os.path.join(GOLDEN_DIR, name + ".npz"),
                   allow_pickle=True)


def _session(d, engine) -> PSAlign:
    """tests/golden_util.session_from_fixture on the port's PSAlign."""
    pa = PSAlign(engine=engine)
    pa.sequence = str(d["sequence"])
    pa.params = {"verbose": 0}
    for i in range(int(d["n_events"])):
        p = f"ev{i}_"
        m = Model(level_mean=d[p + "level_mean"],
                  level_stdv=d[p + "level_stdv"], sd_mean=d[p + "sd_mean"],
                  sd_stdv=d[p + "sd_stdv"],
                  prob_skip=float(d[p + "probs"][0]),
                  prob_stay=float(d[p + "probs"][1]),
                  prob_extend=float(d[p + "probs"][2]),
                  prob_insert=float(d[p + "probs"][3]),
                  complement=bool(d[p + "complement"]))
        pa.events.append(Event(
            mean=d[p + "mean"], stdv=d[p + "stdv"],
            length=np.ones(len(d[p + "mean"])),
            start=np.zeros(len(d[p + "mean"])),
            ref_align=d[p + "ref_align"], ref_like=d[p + "ref_like"],
            model=m, sequence=str(d[p + "seq2d"])))
    return pa


def _events_match(d, data):
    for i, ev in enumerate(data.events):
        np.testing.assert_array_equal(ev.ref_align, d[f"out_ev{i}_ref_align"],
                                      err_msg=f"ref_align ev{i}")
        np.testing.assert_allclose(ev.ref_like, d[f"out_ev{i}_ref_like"],
                                   rtol=0, atol=1e-9,
                                   err_msg=f"ref_like ev{i}")


def _muts(d):
    out = []
    for s, o, m in zip(d["mut_starts"], d["mut_origs"], d["mut_muts"]):
        mi = MutationInfo()
        mi.start, mi.orig, mi.mut = int(s), str(o), str(m)
        out.append(mi)
    return out


def _cases(*names, slow_mesh=()):
    """(name, mesh) cases: each fixture alone and on the 2x2 mesh, the
    mesh case marked slow for the names in slow_mesh."""
    out = []
    for n in names:
        out.append(pytest.param(n, False, id=f"{n}-alone"))
        marks = [pytest.mark.slow] if n in slow_mesh else []
        out.append(pytest.param(n, True, id=f"{n}-mesh2x2", marks=marks))
    return out


@pytest.mark.parametrize("name,mesh", _cases(
    "score_events_a", "score_events_b", slow_mesh=("score_events_a",)))
def test_score_events_parity(name, mesh):
    d = _fixture(name)
    pa = _session(d, _engine(mesh))
    data = AlignData.from_session(pa)
    likes = np.zeros(len(pa.sequence))
    scores = pa.engine.score_alignments(data, likes=likes)
    pa.engine.flush_ref_likes()
    np.testing.assert_allclose(scores, d["out_scores"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(likes, d["out_likes"], rtol=0, atol=1e-8)
    _events_match(d, data)
    if mesh or name != "score_events_b":
        return
    # ScoreEvents through the API: the same scores, no write-back
    api = _session(d, pa.engine)
    np.testing.assert_allclose(api.ScoreEvents(), d["out_scores"], rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(api.events[0].ref_align, d["ev0_ref_align"])


@pytest.mark.parametrize("name,mesh", _cases(
    "score_muts_a", "score_muts_b", slow_mesh=("score_muts_a",)))
def test_score_mutations_parity(name, mesh):
    d = _fixture(name)
    pa = _session(d, _engine(mesh))
    data = AlignData.from_session(pa)
    scores = pa.engine.score_mutations(data, _muts(d))
    pa.engine.flush_ref_likes()
    np.testing.assert_allclose([ms.score for ms in scores], d["out_scores"],
                               rtol=0, atol=1e-8)
    _events_match(d, data)
    if mesh or name != "score_muts_b":
        return
    api = _session(d, pa.engine).ScoreMutations(_muts(d))
    np.testing.assert_allclose([ms.score for ms in api], d["out_scores"],
                               rtol=0, atol=1e-8)


@pytest.mark.slow
@pytest.mark.parametrize("mesh", [False, True], ids=["alone", "mesh2x2"])
def test_mutate_rounds_parity(mesh):
    d = _fixture("mutate_a")
    pa = _session(d, _engine(mesh))
    data = AlignData.from_session(pa)
    seqs = [ev.sequence for ev in pa.events[::2]]
    totbases = 0
    for _ in range(int(d["reps"])):
        muts = find_mutations(pa.engine, data, seqs)
        scores = pa.engine.score_mutations(data, muts)
        nb = make_mutations(pa.engine, data, scores)
        if nb == 0:
            break
        totbases += nb
    pa.engine.flush_ref_likes()
    assert data.sequence == str(d["out_seq"])
    assert totbases == int(d["out_nbases"])
    _events_match(d, data)


@pytest.fixture(scope="module")
def refine_tail_jax():
    """TpuEngine(float64)'s scores of refine_a's point mutations that start
    in the sequence's last TAIL bases: {(start, orig, mut): score}."""
    import jax
    import jax.numpy as jnp

    from golden_util import session_from_fixture
    from poreseq_tpu.engine.driver import find_point_mutations as jax_points
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.engine.types import AlignData as JAlignData

    jax.config.update("jax_enable_x64", True)
    try:
        d = _fixture("refine_a")
        data = JAlignData.from_session(session_from_fixture(d))
        data.params.scoring_width = int(d["point_width"])
        tail = [m for m in jax_points(data)
                if m.start >= len(data.sequence) - TAIL]
        scores = TpuEngine(dtype=jnp.float64).score_mutations(data, tail)
    finally:
        jax.config.update("jax_enable_x64", False)
    return {(m.start, m.orig, m.mut): s.score for m, s in zip(tail, scores)}


@pytest.mark.parametrize("mesh", [False, True], ids=["alone", "mesh2x2"])
def test_refine_parity(mesh, refine_tail_jax):
    d = _fixture("refine_a")
    pa = _session(d, _engine(mesh))
    data = AlignData.from_session(pa)
    data.params.scoring_width = int(d["point_width"])
    muts = find_point_mutations(data)
    scores = pa.engine.score_mutations(data, muts)
    got = np.array([ms.score for ms in scores])
    tail = np.array([m.start >= len(data.sequence) - TAIL for m in muts])
    assert tail.sum() == len(refine_tail_jax) > 0
    np.testing.assert_allclose(got[~tail], d["out_scores"][~tail], rtol=0,
                               atol=1e-8)
    for m, s in zip(muts, scores):
        if m.start >= len(data.sequence) - TAIL:
            assert abs(s.score - refine_tail_jax[(m.start, m.orig, m.mut)]) \
                <= 1e-8
    nb = make_mutations(pa.engine, data, scores)
    assert data.sequence == str(d["out_seq"])
    assert nb == int(d["out_nbases"])


# the port's twins of tests/test_consensus.py's API cases (exact engine),
# at the same seeds and the default widths 300/150


def _sessions(seed, **kw):
    """The same simulated session on the port and on the JAX package (the
    port's sim equals the JAX package's, tests/test_torch_host.py)."""
    from poreseq_tpu.sim import simulate_session as jax_session
    from poreseq_tpu_torch.sim import simulate_session

    pa, truth = simulate_session(np.random.default_rng(seed),
                                 engine=_engine(False), **kw)
    pj, _ = jax_session(np.random.default_rng(seed), **kw)
    assert pa.sequence == pj.sequence
    return pa, pj, truth


def test_score_points_prefers_no_change():
    pa, pj, _ = _sessions(3, ref_len=150, coverage=6)
    pa.params["point_width"] = pj.params["point_width"] = 20
    got, exp = pa.ScorePoints(), pj.ScorePoints()
    assert [(m.start, m.orig, m.mut) for m in got] == [
        (m.start, m.orig, m.mut) for m in exp]
    for g, e in zip(got, exp):
        if g.start < len(pa.sequence) - TAIL:
            assert abs(g.score - e.score) <= 1e-8
    assert sum(1 for s in got if s.score < 0) / len(got) > 0.95


def test_copy_realign_to_and_coverage():
    from poreseq_tpu_torch.sim import mutate_seq

    pa, pj, truth = _sessions(5, ref_len=200, coverage=4)
    np.testing.assert_array_equal(pa.Coverage(), pj.Coverage())
    base = pa.ScoreEvents()
    np.testing.assert_allclose(base, pj.ScoreEvents(), rtol=0, atol=1e-9)
    var = mutate_seq(np.random.default_rng(1), truth, 0.02)
    pav, pjv = pa.Copy(), pj.Copy()
    assert pav.engine is pa.engine and pav.events is not pa.events
    pav.RealignTo(var)
    pjv.RealignTo(var)
    assert pav.sequence == var and pa.sequence != var
    for a, b in zip(pav.events, pjv.events):
        np.testing.assert_array_equal(a.ref_align, b.ref_align)
    np.testing.assert_array_equal(pav.Coverage(), pjv.Coverage())
    var_score = pav.ScoreEvents()
    np.testing.assert_allclose(var_score, pjv.ScoreEvents(), rtol=0,
                               atol=1e-9)
    # truth should outscore a corrupted variant
    assert float(np.sum(var_score)) < float(np.sum(base))
