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
