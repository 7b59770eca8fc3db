"""Event trimming on the port (Event.trim, the band-reachable level range
set at load) against the JAX package: the twin of tests/test_trim.py.

Reads overhanging a short region carry levels no band can reach; the pack
slices them (``engine/pack.py trim_range``) and the engine writes ref_align
and ref_like back into full-length level coordinates (``place_full``).
Checks, at narrow widths on the CPU (the kernels' plain twins):
  * the port's loader sets the JAX loader's trim hint on an overhanging read;
  * TorchEngine f64 equals TpuEngine f64 on that overhang: scores within
    1e-9, ref_align identical, mutation deltas within 1e-8;
  * PSQ_TRIM_EVENTS=0 and =1 give identical f64 results on the port;
  * a lockstep batch of two 2.5 kb regions whose reads are twice as long:
    score_alignments_multi and (slow) one Mutate round against TpuEngine
    f64.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.core.regions import RegionInfo as JRegionInfo
from poreseq_tpu.engine.multi import mutate_datas as jmutate_datas
from poreseq_tpu.engine.types import AlignData as JAlignData
from poreseq_tpu.io.load import load_aligned_events as jload
from poreseq_tpu_torch.core.regions import RegionInfo
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine.driver import find_point_mutations
from poreseq_tpu_torch.engine.multi import mutate_datas
from poreseq_tpu_torch.engine.pack import pack_events
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.io.load import load_aligned_events
from poreseq_tpu_torch.sim import mutate_seq, write_run

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

PARAMS = dict(realign_width=48, scoring_width=24, point_width=12,
              min_overlap=50, min_coverage=0, max_coverage=30,
              max_length=10000, lik_offset=4.5, verbose=0)
REGION = "synthref:1200:1600"


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """tests/test_trim.py's run (the port's simulator writes the JAX one's
    files byte for byte, tests/test_torch_host.py)."""
    d = tmp_path_factory.mktemp("trimrun")
    write_run(str(d), np.random.default_rng(5), ref_len=3000, n_reads=4,
              draft_error=0.03)
    return str(d)


def _load(run_dir, trim: bool, region=REGION, params=PARAMS, jax_pkg=False):
    """The region's session from the port's loader (or the JAX package's)
    with PSQ_TRIM_EVENTS set to trim."""
    load, info = ((jload, JRegionInfo) if jax_pkg
                  else (load_aligned_events, RegionInfo))
    os.environ["PSQ_TRIM_EVENTS"] = "1" if trim else "0"
    try:
        return load(os.path.join(run_dir, "ref.fasta"),
                    os.path.join(run_dir, "reads.bam"),
                    os.path.join(run_dir, "reads"), info(region),
                    dict(params), backend="exact")
    finally:
        os.environ.pop("PSQ_TRIM_EVENTS", None)


def _muts(data, step=20):
    """Every step-th point mutation of the region (deletions, substitutions
    and insertions alike)."""
    return find_point_mutations(data)[::step]


def _score(engine, data, muts=None):
    """ScoreEvents (scores, likes, ref_align, ref_like per event), then
    ScoreMutations of muts on the realigned events where muts are given."""
    likes = np.zeros(len(data.sequence))
    scores = engine.score_alignments(data, likes=likes)
    engine.flush_ref_likes()
    ral = [ev.ref_align.copy() for ev in data.events]
    rlk = [ev.ref_like.copy() for ev in data.events]
    deltas = (np.array([m.score for m in engine.score_mutations(data, muts)])
              if muts is not None else None)
    return np.asarray(scores), likes, ral, rlk, deltas


def test_trim_hint_set_on_overhang(run_dir):
    pa = _load(run_dir, trim=True)
    trims = [ev.trim for ev in pa.events]
    assert any(t is not None for t in trims), \
        "overhanging reads should carry a trim hint"
    for ev in pa.events:
        if ev.trim:
            lo, hi = ev.trim
            assert 0 <= lo < hi <= len(ev.mean)
            assert hi - lo < len(ev.mean)
    assert trims == [ev.trim for ev in _load(run_dir, True,
                                             jax_pkg=True).events]
    # the batch's level axis is the trimmed length, not the reads'
    arrays, _ = pack_events(pa.events)
    assert arrays["mean"].shape[1] < max(len(ev.mean) for ev in pa.events)


def test_trim_overhang_matches_jax_f64(x64, run_dir):
    from poreseq_tpu.engine.tpu import TpuEngine

    dP = AlignData.from_session(_load(run_dir, trim=True))
    dJ = JAlignData.from_session(_load(run_dir, trim=True, jax_pkg=True))
    assert any(ev.trim for ev in dP.events)
    muts = _muts(dP)
    sP, lP, raP, rlP, mP = _score(TorchEngine("cpu", torch.float64), dP,
                                  muts)
    sJ, lJ, raJ, rlJ, mJ = _score(TpuEngine(dtype=jnp.float64), dJ, muts)
    np.testing.assert_allclose(sP, sJ, rtol=0, atol=1e-9)
    np.testing.assert_allclose(lP, lJ, rtol=0, atol=1e-8)
    for a, b in zip(raP, raJ):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rlP, rlJ):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert len(mP) == len(muts) > 50
    np.testing.assert_allclose(mP, mJ, rtol=0, atol=1e-8)


def test_trim_on_off_identical_f64(run_dir):
    outs = []
    for trim in (True, False):
        d = AlignData.from_session(_load(run_dir, trim=trim))
        assert any(ev.trim for ev in d.events) == trim
        outs.append(_score(TorchEngine("cpu", torch.float64), d))
    (s1, l1, ra1, rl1, _), (s0, l0, ra0, rl0, _) = outs
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-9)
    np.testing.assert_allclose(l1, l0, rtol=0, atol=1e-8)
    for a, b in zip(ra1, ra0):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rl1, rl0):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


# the lockstep case: two 2.5 kb regions of a 6 kb genome, reads of 5 kb
NARROW = dict(PARAMS, realign_width=16, scoring_width=8, point_width=6)
LOCKSTEP_REGIONS = ("synthref:500:3000", "synthref:3000:5500")


@pytest.fixture(scope="module")
def lockstep_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("trimlockstep")
    write_run(str(d), np.random.default_rng(9), ref_len=6000, n_reads=6,
              read_len=5000, draft_error=0.02)
    return str(d)


def _lockstep(lockstep_dir, jax_pkg):
    data = JAlignData if jax_pkg else AlignData
    return [data.from_session(_load(lockstep_dir, True, region=r,
                                    params=NARROW, jax_pkg=jax_pkg))
            for r in LOCKSTEP_REGIONS]


def test_lockstep_overhang_score_alignments_multi_matches_jax_f64(
        x64, lockstep_dir):
    """Both regions in one batch: the realignment of every event (scores,
    likes, ref_align, ref_like) against TpuEngine."""
    from poreseq_tpu.engine.tpu import TpuEngine

    runs = {}
    for name, eng in (("torch", TorchEngine("cpu", torch.float64)),
                      ("jax", TpuEngine(dtype=jnp.float64))):
        datas = _lockstep(lockstep_dir, jax_pkg=name == "jax")
        likes = [np.zeros(len(d.sequence)) for d in datas]
        scores = eng.score_alignments_multi(datas, likes_list=likes)
        eng.flush_ref_likes()
        runs[name] = (scores, likes, datas)
    (sP, lP, dP), (sJ, lJ, dJ) = runs["torch"], runs["jax"]
    for r, d in enumerate(dP):
        assert len(d.sequence) >= 2500
        assert sum(bool(ev.trim) for ev in d.events) >= 2
        np.testing.assert_allclose(sP[r], sJ[r], rtol=0, atol=1e-9)
        np.testing.assert_allclose(lP[r], lJ[r], rtol=0, atol=1e-8)
        for a, b in zip(d.events, dJ[r].events):
            np.testing.assert_array_equal(a.ref_align, b.ref_align)
            np.testing.assert_allclose(a.ref_like, b.ref_like, rtol=0,
                                       atol=1e-9)


@pytest.mark.slow
def test_lockstep_overhang_mutate_round_matches_jax_f64(x64, lockstep_dir):
    """One lockstep Mutate round on three candidates a region (copies of the
    draft with 1 % edits) gives TpuEngine's accepted bases and sequences
    (about 100 s on one CPU core: slow)."""
    from poreseq_tpu.engine.tpu import TpuEngine

    out = {}
    for name, eng in (("torch", TorchEngine("cpu", torch.float64)),
                      ("jax", TpuEngine(dtype=jnp.float64))):
        datas = _lockstep(lockstep_dir, jax_pkg=name == "jax")
        rng = np.random.default_rng(3)
        cands = [[mutate_seq(rng, d.sequence, 0.01) for _ in range(3)]
                 for d in datas]
        mutate = jmutate_datas if name == "jax" else mutate_datas
        nbases = mutate(eng, datas, cands, 1)
        out[name] = (nbases, [d.sequence for d in datas])
    assert out["torch"] == out["jax"]
    assert sum(out["torch"][0]) > 0
