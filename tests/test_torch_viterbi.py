"""The port's Viterbi candidate generator against the JAX package: the
observations and the sweep in f64 within 1e-9, the deterministic (nkeep=0)
string equal to the exact engine's, plausible stochastic candidates, the
counter hash behind their draws, and candidates that do not depend on the
batch a region is sampled in."""

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

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


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
    # the draws depend on the engine's seed only
    assert eng.viterbi_mutate_multi([pa.events, []], 4, 0.05, 0.01, 0.33,
                                    0.75) == seqs


def _mix32_reference(x):
    # lowbias32 on Python ints, with plain (unbounded) products
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


# (seed, k, i, w) -> h: the CUDA phase of chip_smoke.py holds the card to
# the same values
PINNED_HASH = [((0, 0, 0, 0), 1106484830), ((7, 0, 0, 0), 993596527),
               ((7, 15, 1234, 1023), 3231325825),
               ((7, 3, 99999, 1541), 3294090134),
               ((2 ** 32 + 7, 3, 99999, 1541), 3294090134),
               ((123456789, 1, 7, 2047), 767034526)]


def test_counter_hash_pinned_and_uniforms_open():
    """The counter hash gives pinned values, the same on Python ints, on
    int64 tensors and by a plain-product reference; the uniforms built on it
    lie strictly inside (0, 1) and keep the hash's top bits."""
    for (seed, k, i, w), h in PINNED_HASH:
        ref = _mix32_reference(_mix32_reference(_mix32_reference(
            _mix32_reference((seed & 0xFFFFFFFF) ^ 0x9E3779B9) ^ k) ^ i) ^ w)
        assert ref == h
        assert tv.counter_hash(seed, k, i, w) == h
    t = torch.tensor
    got = tv.counter_hash(7, t([0, 15, 3]), t([0, 1234, 99999]),
                          t([0, 1023, 1541]))
    assert got.tolist() == [h for _, h in PINNED_HASH[1:4]]
    rows = t([0, 5, 99999])
    for dtype, n in ((torch.float32, 23), (torch.float64, 52)):
        u = tv.counter_uniforms(7, 3, rows, dtype)
        assert u.shape == (3, 3, 1024) and u.dtype == dtype
        assert bool(((u > 0) & (u < 1)).all())
        h = tv.counter_hash(7, torch.arange(3)[:, None, None],
                            rows[None, :, None], torch.arange(1024))
        top = torch.floor(u.double() * 2.0 ** n).long()
        assert torch.equal(top >> (n - 20), h >> 12)
    # the largest draw still maps below 1 in each dtype
    assert torch.tensor(((2 ** 23 - 1) + 0.5) * 2.0 ** -23,
                        dtype=torch.float32) < 1
    assert ((2 ** 52 - 1) + 0.5) * 2.0 ** -52 < 1


@pytest.mark.parametrize("dtype,coverages", [
    (torch.float64, (6, 4, 5)),
    # equal event counts: E_pad adds no padding, so only the draws differ
    (torch.float32, (5, 5, 5))])
def test_candidates_do_not_depend_on_the_batch(dtype, coverages):
    """A region's sampled candidates are the same alone, inside [A, B, C]
    and inside [C, A] (its slot, the batch bucket and the padded row count
    all change)."""
    A, B, C = (_session(seed, ref_len=n, coverage=c)[0].events
               for seed, n, c in zip((3, 9, 4), (150, 110, 200), coverages))
    eng = TorchEngine("cpu", dtype, seed=7)
    run = lambda evs: eng.viterbi_mutate_multi(evs, 16, 0.05, 0.01, 0.33,
                                               0.75)
    solo = [run([x])[0] for x in (A, B, C)]
    assert all(len(s) == 16 for s in solo)
    assert run([A, B, C]) == solo
    assert run([C, A]) == [solo[2], solo[0]]
