"""The backtrace twin and device_likes against the JAX package's
align.backtrace_core / align.device_likes on identical lattices (f64)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.core.sequence import seq_to_states
from poreseq_tpu.engine.tpu import align as ja
from poreseq_tpu.engine.tpu import dp as jdp
from poreseq_tpu.engine.tpu import pack as jp
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine.align import (backtrace, backtrace_reference,
                                            device_likes, likes_reference)

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def jax_fill(x64):
    """JAX forward fill + backtrace of a simulated region, in f64."""
    width = 16
    pa, _ = simulate_session(np.random.default_rng(6), ref_len=160,
                             coverage=5, draft_error=0.03)
    data = AlignData.from_session(pa)
    states = seq_to_states(data.sequence)
    S = len(states)
    C = jp.round_up(S + 8, 64)
    arrays, ris = jp.pack_events(data.events)
    E, T = arrays["mean"].shape
    n = len(data.events)
    S_e = np.zeros(E, np.int64)
    S_e[:n] = S
    states2 = np.full((C, E), -1, np.int32)
    states2[:S, :n] = states[:, None]
    fi = jp.fill_geometry(arrays, ris, S_e, C, width)
    batch = jp.to_device_batch(arrays, jnp.float64)
    i0 = jnp.asarray(fi["i0"])
    w0, rf = jdp.device_window_inputs(batch, i0, False, 2 * width + 1)
    r = jdp.make_fill(width, jnp.float64)(
        batch, jnp.asarray(states2), i0, jnp.asarray(fi["i1"]), w0, rf,
        jnp.asarray(fi["is_pad"]), 4.5, False)
    max_steps = C + 2 * T + 8
    ral, rlk = ja.backtrace_core(r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1,
                                 r.best_i, r.best_j, T, max_steps)
    return r, np.asarray(ral), np.asarray(rlk), T, max_steps, C


def test_backtrace_twin_matches_jax(jax_fill):
    r, ral_j, rlk_j, T, max_steps, _ = jax_fill
    t = lambda x: torch.as_tensor(np.array(x))
    args = (t(r.M), t(r.S), t(r.steps_m), t(r.steps_s), t(r.i0), t(r.i1),
            t(r.best_i), t(r.best_j), T, max_steps)
    ral, rlk = backtrace_reference(*args)
    np.testing.assert_array_equal(ral.numpy(), ral_j)
    np.testing.assert_allclose(rlk.numpy(), rlk_j, rtol=0, atol=1e-12)
    assert (ral_j > 0).sum() > 100          # the walks really ran
    ral2, _ = backtrace(*args)              # the CPU route is the twin
    np.testing.assert_array_equal(ral2.numpy(), ral_j)


def test_device_likes_matches_jax(jax_fill):
    _, ral_j, rlk_j, _, _, C = jax_fill
    ref = np.asarray(ja.device_likes(jnp.asarray(ral_j), jnp.asarray(rlk_j),
                                     C))
    got = device_likes(torch.as_tensor(ral_j), torch.as_tensor(rlk_j), C)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.count_nonzero(ref) > 100


def _np_likes_walk(ral, rlk, n_like):
    """NumPy model of csrc/likes.cu: one walk over the levels carrying A
    (the largest anchor so far, 0 before any) and I (the last anchored
    level); level j writes its value (rlk[I] when A > 0, else 0) at the k
    with A[j] <= k < A[j+1], the last level at every k >= A, and the k below
    A[0] get 0."""
    E, T = ral.shape
    vals = np.full((E, n_like), np.nan, dtype=ral.dtype)
    ks = np.arange(1, n_like + 1)
    anchor = np.where(ral > 0, ral, 0)
    for e in range(E):
        vals[e, ks < anchor[e, 0]] = 0
        A, I = ral.dtype.type(0), -1
        for j in range(T):
            if ral[e, j] > 0:
                A, I = max(A, ral[e, j]), j
            nxt = max(A, anchor[e, j + 1]) if j + 1 < T else np.inf
            vals[e, (ks >= A) & (ks < nxt)] = rlk[e, I] if A > 0 else 0
    return vals


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_likes_twin_equals_numpy_walk(dtype):
    """likes_reference equals the kernel's one-walk merge bit for bit:
    events with no anchor, a plateau (several levels anchored at the same
    index k), anchors at level 0 and past n_like, inserts (-1) between."""
    rng = np.random.default_rng(5)
    E, T, n_like = 12, 70, 40
    ral = np.zeros((E, T), dtype=dtype)
    for e in range(1, E):
        ref, t = int(rng.integers(0, 6)), int(rng.integers(0, 3))
        while t < T:
            u = rng.random()
            if u < 0.45:
                ref += int(rng.integers(0, 3))
                ral[e, t] = ref if ref > 0 else 0
            elif u < 0.55:
                ral[e, t] = -1
            t += 1
    ral[2, :5] = 7                                # plateau at k = 7
    ral[3, 0] = 1                                 # level 0 anchored
    ral[4] = np.where(ral[4] > 0, ral[4] + n_like, ral[4])   # past n_like
    rlk = rng.random((E, T)).astype(dtype)
    got = likes_reference(torch.as_tensor(ral), torch.as_tensor(rlk), n_like)
    np.testing.assert_array_equal(got.numpy(), _np_likes_walk(ral, rlk,
                                                              n_like))
