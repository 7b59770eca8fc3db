"""The port's fill (its plain twin on CPU tensors) against the JAX fills:
dp.make_fill in f64 (lattices within 1e-9, backpointers and best
coordinates equal) and the Pallas kernel in interpret mode in f32 (the
tolerances of test_pallas_fill.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.core.sequence import seq_to_states
from poreseq_tpu.engine.tpu import dp as jdp
from poreseq_tpu.engine.tpu import pack as jp
from poreseq_tpu.engine.tpu.pallas_fill import make_pallas_fill
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import pack as tp
from poreseq_tpu_torch.engine.fill import get_fill

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _inputs(ref_len, coverage, width, seed):
    """Packed arrays and per-event fill geometry of one simulated region,
    laid out as the engines lay out a one-region batch."""
    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                             coverage=coverage)
    data = AlignData.from_session(pa)
    states = seq_to_states(data.sequence)
    S = len(states)
    C = jp.round_up(S + 8, 64)
    arrays, ris = jp.pack_events(data.events)
    E = len(arrays["n0"])
    n = len(data.events)
    S_e = np.zeros(E, np.int64)
    S_e[:n] = S
    states2 = np.full((C, E), -1, np.int32)
    states2[:S, :n] = states[:, None]
    fi = jp.fill_geometry(arrays, ris, S_e, C, width)
    return arrays, states2, fi


def _jax_fill(fill_fn, batch, states2, fi, width, backward):
    i0 = jnp.asarray(fi["i0"])
    w0, rf = jdp.device_window_inputs(batch, i0, backward, 2 * width + 1)
    return fill_fn(batch, jnp.asarray(states2), i0, jnp.asarray(fi["i1"]),
                   w0, rf, jnp.asarray(fi["is_pad"]), 4.5, backward)


def _port_fill(jax_batch, states2, fi, width, dtype, backward, need_steps):
    # the JAX package's packed batch, carried over: identical inputs
    batch = tp.from_jax_arrays(jax_batch, dtype, "cpu")
    t = torch.as_tensor
    return get_fill(width, need_steps)(batch, t(states2), t(fi["i0"]),
                                       t(fi["i1"]), t(fi["is_pad"]), 4.5,
                                       backward)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("need_steps", [True, False])
def test_fill_twin_matches_make_fill_f64(x64, backward, need_steps):
    width = 20
    arrays, states2, fi = _inputs(200, 4, width, seed=1)
    jbatch = jp.to_device_batch(arrays, jnp.float64)
    ref = _jax_fill(jdp.make_fill(width, jnp.float64, need_steps), jbatch,
                    states2, fi, width, backward)
    got = _port_fill(jbatch, states2, fi, width, torch.float64, backward,
                     need_steps)
    for name in ("M", "S", "best", "best_pfx"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    for name in ("steps_m", "steps_s", "best_i", "best_j", "i0", "i1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("backward", [False, True])
def test_fill_twin_matches_pallas_f32(backward):
    width = 16
    arrays, states2, fi = _inputs(120, 4, width, seed=3)
    jbatch = jp.to_device_batch(arrays, jnp.float32)
    ref = _jax_fill(make_pallas_fill(width, need_steps=True, interpret=True),
                    jbatch, states2, fi, width, backward)
    got = _port_fill(jbatch, states2, fi, width, torch.float32, backward,
                     True)
    for name in ("M", "S", "best", "best_pfx"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=2e-5, atol=2e-4, err_msg=name)
    if not backward:
        for name in ("steps_m", "steps_s"):
            agree = (getattr(got, name).numpy()
                     == np.asarray(getattr(ref, name))).mean()
            assert agree > 0.9995, f"{name} agreement {agree}"
        for name in ("best_i", "best_j"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))


def test_fill_rejects_operands_off_cpu_and_cuda():
    # the wrapper routes by device: CPU -> twin, CUDA -> kernel, else raise
    arrays, states2, fi = _inputs(90, 3, 12, seed=7)
    batch = tp.to_device_batch(arrays, torch.float32, "meta")
    t = lambda x: torch.as_tensor(x).to("meta")
    with pytest.raises(ValueError, match="meta"):
        get_fill(12)(batch, t(states2), t(fi["i0"]), t(fi["i1"]),
                     t(fi["is_pad"]), 4.5, False)


def _np_running_best(cmax, carg, i0, backward):
    """NumPy model of csrc/fill.cu's running best: one pass over the
    columns in processing order carrying the running max, best_pfx = max(it,
    0) per column, the column and argmax of the last strict raise; best,
    best_i, best_j from that raise when the final max is above 0, else 0."""
    C, E = cmax.shape
    pfx = np.zeros_like(cmax)
    best = np.zeros(E, dtype=cmax.dtype)
    best_i = np.zeros(E, dtype=np.int32)
    best_j = np.zeros(E, dtype=np.int32)
    for e in range(E):
        run, c_star, a_star = None, 0, 0
        for tt in range(C):
            c = C - 1 - tt if backward else tt
            if tt == 0 or cmax[c, e] > run:
                run, c_star, a_star = cmax[c, e], c, carg[c, e]
            pfx[c, e] = run if run > 0 else 0
        if run > 0:
            best[e] = run
            best_i[e] = i0[e, c_star + 1] + a_star
            best_j[e] = c_star + 1
    return pfx, best, best_i, best_j


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_finish_fill_equals_one_pass_running_best(dtype, backward):
    """dp.finish_fill (the twin) equals the kernel's one-pass running best
    bit for bit: ties of the column max (the first in processing order
    wins), events whose columns are all negative or padding (-1e30 in f32
    and f64's sentinel), padded column suffixes, and a best reached on the
    first or the last column."""
    from poreseq_tpu_torch.engine.dp import finish_fill, neg_big

    rng = np.random.default_rng(3)
    C, E = 37, 24
    nb = neg_big(torch.float64 if dtype == np.float64 else torch.float32)
    pool = np.array([0.0, 1.5, 1.5, 2.25, 7.0, 7.0, 3.1, 0.7], dtype=dtype)
    cmax = rng.choice(pool, (C, E)).astype(dtype)
    cmax += (rng.random((C, E)) < 0.2) * rng.random((C, E)).astype(dtype)
    carg = rng.integers(0, 41, (C, E)).astype(np.int32)
    for e in range(E):
        n_live = int(rng.integers(0, C + 1))
        cmax[n_live:, e] = nb                      # padded suffix
        carg[n_live:, e] = 0
    cmax[:, 0] = -rng.random(C).astype(dtype) - 1.0   # all negative
    cmax[:, 1] = nb                                     # all padding
    cmax[:, 2] = 0.0                                    # best 0: no hit
    cmax[0, 3] = cmax[-1, 4] = 99.0                     # ends
    i0 = np.cumsum(rng.integers(0, 4, (E, C + 1)), axis=1).astype(np.int32)
    t = torch.as_tensor
    r = finish_fill(None, None, None, None, t(cmax), t(carg), t(i0), None,
                    backward)
    pfx, best, best_i, best_j = _np_running_best(cmax, carg, i0, backward)
    np.testing.assert_array_equal(r.best_pfx.numpy(), pfx)
    np.testing.assert_array_equal(r.best.numpy(), best)
    np.testing.assert_array_equal(r.best_i.numpy(), best_i)
    np.testing.assert_array_equal(r.best_j.numpy(), best_j)
