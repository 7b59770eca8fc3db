"""The port's Viterbi candidates against TpuEngine's, each engine drawing
its own (no shared candidates): TorchEngine float64 gives TpuEngine
float64's strings exactly, solo and in a batch of two regions of different
lengths; in float32 a candidate may differ only where JAX's draw was a
near-tie."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.engine.tpu import TpuEngine
from poreseq_tpu.engine.tpu import viterbi as jv
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine import viterbi as tv

torch.set_num_threads(1)

ARGS = (16, 0.05, 0.01, 0.33, 0.75)      # the pipeline's nkeep, skip, ...
# (rng seed, ref_len, coverage) of the sessions; A and B have 106 and 90
# retained positions, so their batch pads B's rows
SESSIONS = {"A": (3, 150, 6), "B": (9, 110, 4), "C": (4, 200, 5)}
CALLS = [["A"], ["B"], ["C"], ["A", "B"]]
# a float32 flip needs JAX's top two scores closer than the two engines'
# scores differ: each score within 4.8e-6 of JAX's at a draw's top two on
# these sessions (the noise's 2 ulps of |g| <= 16, 9.5e-7 each, and the
# f32 forward probabilities' rounding), so twice that, rounded up
F32_TIE = 1e-5


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _events(names):
    return [simulate_session(np.random.default_rng(s), ref_len=n,
                             coverage=c)[0].events
            for s, n, c in (SESSIONS[x] for x in names)]


@pytest.mark.parametrize("call", CALLS, ids="+".join)
def test_f64_candidates_equal_tpu_engine(call, x64):
    """TorchEngine("cpu", float64).viterbi_mutate_multi returns exactly
    TpuEngine(float64)'s 16 candidates per region, alone (also against
    TpuEngine's solo viterbi_mutate) and in a batch of two regions of
    different lengths."""
    evs = _events(call)
    got = TorchEngine("cpu", torch.float64).viterbi_mutate_multi(evs, *ARGS)
    eng = TpuEngine(dtype=jnp.float64)
    want = eng.viterbi_mutate_multi(evs, *ARGS)
    assert [len(c) for c in got] == [16] * len(evs)
    assert got == want
    if len(evs) == 1:
        assert got[0] == eng.viterbi_mutate(evs[0], *ARGS)


def _port_paths(evs, dtype):
    """The port's sampled paths [B, nk, R] and real rows [B], through the
    engine's own stages (viterbi_mutate_multi's)."""
    _, obs, n_real = tv.sweep_inputs(evs, "cpu", dtype)
    liks, fwds, _ = tv.viterbi_sweep(obs, n_real, *ARGS[1:3])
    ins = tv.sample_inputs(liks, fwds, n_real, *ARGS[:1], *ARGS[3:])
    return (tv.sample_paths(*ins, *ARGS[1:3], 0).numpy(),
            n_real.numpy())


def _jax_scores(args, b, k, i, cur):
    """JAX's scores of candidate k's draw at row i of region b from state
    cur: _backtrace_one's expressions on the sampler's operands."""
    T, fwds, _, _, attens, keys = args
    probs = T[cur] * jnp.power(fwds[b, i], attens[k])
    probs = probs / jnp.sum(probs)
    return np.asarray(jax.random.gumbel(jax.random.fold_in(keys[k], i),
                                        (1024,), fwds.dtype)
                      + jnp.log(probs + 1e-300))


@pytest.mark.parametrize("call", CALLS, ids="+".join)
def test_f32_candidates_differ_only_at_near_ties(call, monkeypatch):
    """TorchEngine float32 against TpuEngine float32 on the same calls:
    where a candidate's path first differs (scanning down from the start
    state, the order of the draws), JAX's draw there had its top two scores
    within F32_TIE; a differing start state needs the sweep's two best
    final likelihoods within 1e-6 of their size."""
    jax.config.update("jax_enable_x64", False)
    kept = {}
    sweep, sampler = jv._viterbi_sweep_multi, jv._bt_multi_fn

    def sweep_spy(*args):
        out = sweep(*args)
        kept["liks"] = np.asarray(out[0])
        return out

    def sampler_spy():
        fn = sampler()

        def call_(*args):
            kept["args"], kept["paths"] = args, np.asarray(fn(*args))
            return kept["paths"]
        return call_

    monkeypatch.setattr(jv, "_viterbi_sweep_multi", sweep_spy)
    monkeypatch.setattr(jv, "_bt_multi_fn", sampler_spy)
    evs = _events(call)
    want = TpuEngine(dtype=jnp.float32).viterbi_mutate_multi(evs, *ARGS)
    got = TorchEngine("cpu", torch.float32).viterbi_mutate_multi(evs, *ARGS)
    paths, n_real = _port_paths(evs, torch.float32)
    assert [[tv._states_to_seq(paths[b, k, :n_real[b]]) for k in range(16)]
            for b in range(len(evs))] == got
    for b, n in enumerate(n_real[:len(evs)]):
        for k in range(16):
            if got[b][k] == want[b][k]:
                continue
            mine, theirs = paths[b, k, :n], kept["paths"][b, k, :n]
            d = int(np.nonzero(mine != theirs)[0][-1])
            if d == n - 1:
                liks = np.sort(kept["liks"][b])
                assert liks[-1] - liks[-2] <= 1e-6 * abs(liks[-1])
                continue
            top = np.sort(_jax_scores(kept["args"], b, k, d + 1,
                                      int(theirs[d + 1])))
            assert top[-1] - top[-2] <= F32_TIE, (b, k, d)
