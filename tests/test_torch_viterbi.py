"""The port's Viterbi candidate generator against the JAX package: the
observations and the sweep in f64 within 1e-9, the deterministic (nkeep=0)
string equal to the exact engine's, and plausible stochastic candidates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.api import swalign
from poreseq_tpu.engine.exact import ExactEngine
from poreseq_tpu.engine.tpu import viterbi as jv
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine import viterbi as tv


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _session(seed, ref_len=150, coverage=6):
    return simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                            coverage=coverage)


def test_obs_and_sweep_match_jax_f64(x64):
    """Two regions of different lengths in one batch (the second's rows past
    its end pass the carry): obs, liks, fwds and the solo sweep's
    backpointers agree with the JAX programs."""
    evs = [_session(3)[0].events, _session(9, ref_len=110, coverage=4)[0]
           .events]
    stats = [tv._position_stats(e) for e in evs]
    R = max(len(s[0]) for s in stats)
    E = max(len(e) for e in evs)
    lvl = np.zeros((2, R, E))
    sd = np.zeros((2, R, E))
    valid = np.zeros((2, R, E), dtype=bool)
    tabs = np.stack([tv._model_tabs(e, E) for e in evs])
    n_real = np.array([len(s[0]) for s in stats])
    for b, (l, s, v) in enumerate(stats):
        lvl[b, : len(l), : l.shape[1]] = l
        sd[b, : len(l), : l.shape[1]] = s
        valid[b, : len(l), : l.shape[1]] = v
    obs_j = jv._obs_multi_fn()(*(jnp.asarray(x) for x in (lvl, sd, valid,
                                                          tabs)))
    obs_t = tv.obs_multi(*(torch.as_tensor(x) for x in (lvl, sd, valid,
                                                        tabs)))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0,
                               atol=1e-9)
    liks_j, fwds_j = jv._viterbi_sweep_multi(obs_j, jnp.asarray(n_real),
                                             0.05, 0.01)
    liks_t, fwds_t, _ = tv.viterbi_sweep(obs_t, torch.as_tensor(n_real),
                                         0.05, 0.01)
    np.testing.assert_allclose(liks_t.numpy(), np.asarray(liks_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(fwds_t.numpy(), np.asarray(fwds_j), rtol=0,
                               atol=1e-9)
    # backpointers of the solo sweep (the nkeep=0 path)
    n = int(n_real[0])
    _, bps_j, _ = jv._viterbi_sweep(obs_j[0, :n], n, 0.05, 0.01)
    _, _, bps_t = tv.viterbi_sweep(obs_t[:1, :n], torch.tensor([n]), 0.05,
                                   0.01, need_bp=True)
    np.testing.assert_array_equal(bps_t[0].numpy(), np.asarray(bps_j))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_deterministic_viterbi_matches_exact(dtype):
    pa, _ = _session(5)
    se = ExactEngine().viterbi_mutate(AlignData.from_session(pa).events, 0,
                                      0.05, 0.01, 0.33, 0.75)
    st = TorchEngine("cpu", dtype).viterbi_mutate(pa.events, 0, 0.05, 0.01,
                                                  0.33, 0.75)
    assert len(st) == 1 and st[0] == se[0]


def test_stochastic_candidates_plausible_and_seeded():
    pa, truth = _session(3)
    eng = TorchEngine("cpu", torch.float32, seed=7)
    seqs = eng.viterbi_mutate_multi([pa.events, []], 4, 0.05, 0.01, 0.33,
                                    0.75)
    assert len(seqs[0]) == 4 and seqs[1] == []
    for s in seqs[0]:
        # candidates seed proposals only; the engines produce ~55-65% here
        assert swalign(s, truth)[0] > 45.0
    # the generator is re-seeded on every call
    assert eng.viterbi_mutate_multi([pa.events, []], 4, 0.05, 0.01, 0.33,
                                    0.75) == seqs
