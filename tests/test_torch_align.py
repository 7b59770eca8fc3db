"""The backtrace twin and device_likes against the JAX package's
align.backtrace_core / align.device_likes on identical lattices (f64)."""

import re
from pathlib import Path

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


def _likes_rows(rng, E, T, n_like, dtype):
    """Backtrace-like ral/rlk [E, T]: event 0 with no anchor, then random
    walks of anchors (monotone where > 0) with inserts (-1) between, a
    plateau in event 2, level 0 anchored in event 3, every anchor of event 4
    past n_like."""
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
    return ral, rng.random((E, T)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_likes_twin_equals_numpy_walk(dtype):
    """likes_reference equals the kernel's one-walk merge bit for bit:
    events with no anchor, a plateau (several levels anchored at the same
    index k), anchors at level 0 and past n_like, inserts (-1) between."""
    ral, rlk = _likes_rows(np.random.default_rng(5), 12, 70, 40, dtype)
    n_like = 40
    got = likes_reference(torch.as_tensor(ral), torch.as_tensor(rlk), n_like)
    np.testing.assert_array_equal(got.numpy(), _np_likes_walk(ral, rlk,
                                                              n_like))


def _np_likes_blocks(ral, rlk, n_like, width):
    """NumPy model of csrc/likes.cu: a block an event takes its levels
    width at a time; per chunk a prefix max of the anchors and of their
    levels, with the chunks before as a carry, gives A and V (rlk at the
    last anchored level when A > 0, else 0); the chunk answers the k from
    the least k >= A at its first level (1 for the first chunk) to below A
    at the next chunk's first level (n_like for the last), each by a binary
    search for the last level with A <= k.  Asserts that every k is
    written exactly once."""
    E, T = ral.shape
    one = ral.dtype.type
    vals = np.full((E, n_like), np.nan, dtype=ral.dtype)
    hits = np.zeros((E, n_like), dtype=int)

    def kceil(a):
        if not a > 1:
            return 1
        return n_like + 1 if a > n_like else int(np.ceil(a))

    for e in range(E):
        cA, cV, klo = one(0), one(0), 1
        for c0 in range(0, T, width):
            n = min(width, T - c0)
            x = ral[e, c0:c0 + n]
            A = np.maximum(np.maximum.accumulate(np.where(x > 0, x, 0)), cA)
            I = np.maximum.accumulate(np.where(x > 0, np.arange(n), -1))
            V = np.where(A > 0, np.where(I >= 0, rlk[e, c0 + I.clip(0)], cV),
                         0).astype(ral.dtype)
            khi = n_like + 1
            if c0 + width < T:
                nx = ral[e, c0 + width]
                khi = kceil(max(A[-1], nx if nx > 0 else one(0)))
            ks = np.arange(klo, khi)
            lo, hi = np.zeros(len(ks), dtype=int), np.full(len(ks), n)
            while (lo < hi).any():
                mid = (lo + hi) >> 1
                le = (lo < hi) & (A[np.minimum(mid, n - 1)] <= ks.astype(
                    ral.dtype))
                lo, hi = np.where(le, mid + 1, lo), np.where(
                    (lo < hi) & ~le, mid, hi)
            vals[e, ks - 1] = np.where(lo > 0, V[np.maximum(lo - 1, 0)], 0)
            hits[e, ks - 1] += 1
            klo, cA, cV = khi, A[-1], V[-1]
    assert (hits == 1).all()
    return vals


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("T,n_like,width", [(70, 40, None), (70, 40, 32),
                                            (2500, 2600, None),
                                            (2500, 1, None),
                                            (1000, 900, 96)])
def test_likes_kernel_model_equals_twin(T, n_like, width, dtype):
    """The likes kernel's decomposition (a block scan per chunk of levels,
    then a search per output), bit for bit against likes_reference on
    test_likes_twin_equals_numpy_walk's kind of rows: T within one block
    (the kernel's width, None) and over several chunks (T = 2500, not a
    multiple of the width; narrower chunks of 32 and 96 levels), n_like > T
    and n_like = 1, an event whose first anchor is past n_like."""
    text = (Path(likes_reference.__code__.co_filename).resolve().parents[1]
            / "csrc" / "likes.cu").read_text()
    width = width or int(re.search(r"constexpr int NT = (\d+);",
                                   text).group(1))
    ral, rlk = _likes_rows(np.random.default_rng(T + n_like), 12, T, n_like,
                           dtype)
    ref = likes_reference(torch.as_tensor(ral), torch.as_tensor(rlk), n_like)
    np.testing.assert_array_equal(_np_likes_blocks(ral, rlk, n_like, width),
                                  ref.numpy())
    assert T <= width or T % width
    assert ((ral > 0).any(axis=1) & ((ral <= 0) | (ral > n_like)).all(
        axis=1)).any()
