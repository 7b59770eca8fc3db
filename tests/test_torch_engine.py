"""TorchEngine as a whole (CPU, plain twins) against TpuEngine(float64) and
the exact engine: ScoreEvents over a two-region batch, one deterministic
lockstep Mutate round, and the engine's guards."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.engine.exact import ExactEngine
from poreseq_tpu.engine.multi import mutate_datas
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import TorchEngine

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _session(seed, ref_len=150, coverage=4, draft_error=0.03):
    pa, truth = simulate_session(np.random.default_rng(seed),
                                 ref_len=ref_len, coverage=coverage,
                                 draft_error=draft_error)
    pa.params.update(realign_width=24, scoring_width=12)
    return pa, truth


def test_score_alignments_multi_f64_matches_jax_and_exact(x64):
    from poreseq_tpu.engine.tpu import TpuEngine

    pas = [_session(42, ref_len=200)[0], _session(43, coverage=3)[0]]
    runs = {}
    for name, eng in (("torch", TorchEngine("cpu", torch.float64)),
                      ("jax", TpuEngine(dtype=jnp.float64))):
        datas = [AlignData.from_session(pa) for pa in pas]
        likes = [np.zeros(len(pa.sequence)) for pa in pas]
        scores = eng.score_alignments_multi(datas, likes_list=likes)
        eng.flush_ref_likes()
        runs[name] = (datas, likes, scores)
    dP, lP, sP = runs["torch"]
    dJ, lJ, sJ = runs["jax"]
    for r, pa in enumerate(pas):
        dE = AlignData.from_session(pa)
        lE = np.zeros(len(pa.sequence))
        sE = ExactEngine().score_alignments(dE, likes=lE)
        for s_ref, l_ref, d_ref in ((sE, lE, dE), (sJ[r], lJ[r], dJ[r])):
            np.testing.assert_allclose(sP[r], s_ref, rtol=0, atol=1e-9)
            np.testing.assert_allclose(lP[r], l_ref, rtol=0, atol=1e-8)
            for evP, evR in zip(dP[r].events, d_ref.events):
                np.testing.assert_array_equal(evP.ref_align, evR.ref_align)
                np.testing.assert_allclose(evP.ref_like, evR.ref_like,
                                           rtol=0, atol=1e-9)


def test_mutate_round_matches_jax_f64(x64):
    """One deterministic lockstep Mutate round ('self' candidates: the
    reads' own basecalls) on two regions gives the JAX engine's
    sequences."""
    from poreseq_tpu.engine.tpu import TpuEngine

    pas = [_session(7, ref_len=120, coverage=5)[0],
           _session(8, ref_len=100, coverage=5)[0]]
    out = {}
    for name, eng in (("torch", TorchEngine("cpu", torch.float64)),
                      ("jax", TpuEngine(dtype=jnp.float64))):
        datas = [AlignData.from_session(pa) for pa in pas]
        seqs = [[ev.sequence for ev in pa.events[::2]] for pa in pas]
        nbases = mutate_datas(eng, datas, seqs, 1)
        out[name] = ([d.sequence for d in datas], nbases)
    assert out["torch"] == out["jax"]
    assert sum(out["torch"][1]) > 0
    assert out["torch"][0] != [pa.sequence for pa in pas]


def test_engine_guards_and_registration(monkeypatch):
    """The engine's guards, and how a session finds its engine: the one it
    is given, else the shared default TorchEngine("cuda"), which needs a
    card.  (The port has no engine table; the JAX package's takes a
    TorchEngine like any backend.)"""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA guard")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(device="cuda")
    with pytest.raises(ValueError):
        TorchEngine(device="cpu", dtype=torch.float16)
    from poreseq_tpu import api as jax_api
    from poreseq_tpu_torch import api

    eng = TorchEngine(device="cpu", dtype=torch.float64, seed=3)
    assert api.PSAlign(engine=eng).engine is eng and eng.seed == 3
    assert api.PSAlign(engine=eng).Copy().engine is eng
    with pytest.raises(RuntimeError, match="CUDA"):
        api.PSAlign().engine
    monkeypatch.setitem(jax_api._ENGINES, "torch", eng)
    assert jax_api.PSAlign(backend="torch").engine is eng


def test_deferred_ref_likes_are_bounded():
    eng = TorchEngine("cpu", torch.float32)

    class Ev:
        def __init__(self):
            self.mean = np.zeros(3)
            self.ref_like = None

    evs = [Ev() for _ in range(8)]
    for i, ev in enumerate(evs):
        eng._defer_rlk(ev, torch.full((2, 3), float(i)), 0)
    assert len({id(d) for _, d, _ in eng._rlk_pending.values()}) <= 4
    eng.flush_ref_likes()
    assert not eng._rlk_pending
    assert [float(ev.ref_like[0]) for ev in evs] == [float(i) for i in
                                                     range(8)]
