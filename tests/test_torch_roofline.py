"""The least-time counts of engine/roofline.py count the work a launch's data
needs: padding the launch carries (event rows without a seed alignment,
padded columns, padded levels; for the Viterbi sweep, sampler and Gumbel
kernel padded rows and padded regions) changes neither the bytes nor the
operations of a launch, and the sampler's noise, which every region of a
call shares, is counted once per call, its threefry2x32 at the INT32
peak."""

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine.align import backtrace
from poreseq_tpu_torch.engine.fill import get_fill
from poreseq_tpu_torch.engine.pack import fill_geometry
from poreseq_tpu_torch.engine.roofline import (BITS_OPS, GUMBEL_OPS,
                                               HBM_BYTES_PER_S,
                                               INT32_OPS_PER_S,
                                               PEAK_OPS_PER_S, SAMPLE_OPS,
                                               THREEFRY_OPS, backtrace_work,
                                               bound_ms, fill_work, geom_work,
                                               likes_work, viterbi_gumbel_work,
                                               viterbi_obs_work,
                                               viterbi_sample_work,
                                               viterbi_sweep_work,
                                               windows_work)
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.engine.viterbi import (obs_inputs, sample_inputs,
                                              sweep_inputs, viterbi_sweep)
from poreseq_tpu_torch.sim import simulate_session

torch.set_num_threads(1)

WIDTH = 8


def _fill_inputs():
    pa, _ = simulate_session(np.random.default_rng(0), ref_len=120,
                             coverage=3, draft_error=0.03)
    pa.params.update(realign_width=WIDTH)
    data = AlignData.from_session(pa)
    ctx = TorchEngine("cpu", torch.float32)._prepare_multi([data])
    fi = fill_geometry(ctx["arrays"], ctx["ref_indexes"], ctx["S_e"],
                       ctx["C"], WIDTH)
    t = torch.as_tensor
    return (ctx["batch"], t(ctx["states2"]), t(fi["i0"]), t(fi["i1"]),
            t(fi["is_pad"]))


def _padded(batch, states, is_pad, rows=5, cols=7, levels=64):
    """The same launch with `rows` inactive event rows, `cols` padded
    columns and `levels` more padded levels."""
    def grow(x):
        x = torch.cat([x, torch.zeros_like(x[:1]).expand(rows, *x.shape[1:])])
        if x.dim() == 2 and x.shape[1] == batch.mean.shape[1]:
            x = torch.cat([x, torch.zeros(x.shape[0], levels, dtype=x.dtype)],
                          1)
        return x

    big = type(batch)(*(grow(x) for x in batch))
    C, E = states.shape
    st = torch.full((C + cols, E + rows), -1, dtype=states.dtype)
    st[:C, :E] = states
    pad = torch.ones((C + cols, E + rows), dtype=is_pad.dtype)
    pad[:C, :E] = is_pad
    return big, st, pad


def _viterbi_padded(kernel, rows=64, regions=3):
    """(work, work of the same launch with `rows` more padded rows and
    `regions` more padded regions) for a sweep or sampler launch on two
    simulated regions."""
    evs = [simulate_session(np.random.default_rng(s), ref_len=n,
                            coverage=3)[0].events for s, n in ((1, 110),
                                                               (2, 130))]
    _, obs, n_real = sweep_inputs(evs, "cpu", torch.float32)
    B, R, _ = obs.shape
    big = torch.zeros((B + regions, R + rows, 1024), dtype=obs.dtype)
    big[:B, :R] = obs
    big_n = torch.cat([n_real, torch.zeros(regions, dtype=n_real.dtype)])
    if kernel.startswith("viterbi_sweep"):
        bp = kernel.endswith("backpointers")
        return (viterbi_sweep_work(obs, n_real, bp),
                viterbi_sweep_work(big, big_n, bp))
    liks, fwds, _ = viterbi_sweep(obs, n_real, 0.05, 0.01)
    fwds, valid, _, attens = sample_inputs(liks, fwds, n_real, 4, 0.33, 0.75)
    big_f = torch.full((B + regions, R + rows, 1024), 1.0 / 1024.0)
    big_f[:B, :R] = fwds
    big_v = torch.arange(R + rows)[None, :] < big_n[:, None]
    if kernel == "viterbi_gumbel":
        return (viterbi_gumbel_work(valid, 4, fwds.dtype),
                viterbi_gumbel_work(big_v, 4, fwds.dtype))
    return (viterbi_sample_work(fwds, valid, attens),
            viterbi_sample_work(big_f, big_v, attens))


@pytest.mark.parametrize("kernel", ["fill", "fill with steps", "backtrace",
                                    "viterbi_sweep",
                                    "viterbi_sweep with backpointers",
                                    "viterbi_sample", "viterbi_gumbel"])
def test_work_counts_leave_out_padding(kernel):
    if kernel.startswith("viterbi"):
        work, padded = _viterbi_padded(kernel)
        assert work == padded
        assert work[0] > 0 and work[1] > 0
        return
    batch, states, i0, i1, is_pad = _fill_inputs()
    big, st, pad = _padded(batch, states, is_pad)
    assert not bool(big.active[batch.active.shape[0]:].any())
    W = 2 * WIDTH + 1
    if kernel.startswith("fill"):
        steps = kernel.endswith("steps")
        work = fill_work(batch, states, is_pad, W, steps)
        assert work == fill_work(big, st, pad, W, steps)
        assert work[0] > 0 and work[1] > 0
        return
    r = get_fill(WIDTH)(batch, states, i0, i1, is_pad, 4.5, False)
    T = batch.mean.shape[1]
    ral, _ = backtrace(r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1, r.best_i,
                       r.best_j, T, states.shape[0] + 2 * T + 8)
    work = backtrace_work(ral, r.best_i, batch.n0, batch.mean.dtype)
    E, rows, levels = ral.shape[0], 5, 64
    big_ral = torch.zeros((E + rows, T + levels), dtype=ral.dtype)
    big_ral[:E, :T] = ral
    big_best = torch.cat([r.best_i, torch.zeros(rows, dtype=r.best_i.dtype)])
    big_n0 = torch.cat([batch.n0, torch.ones(rows, dtype=batch.n0.dtype)])
    assert work == backtrace_work(big_ral, big_best, big_n0,
                                  batch.mean.dtype)
    assert work[0] > 0 and work[1] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sampler_work_counts_the_noise_once_per_call(dtype):
    """Twice the regions (the same rows) doubles the chains' arithmetic but
    not the Gumbel noise's: the sampler's operations grow by the chains'
    SAMPLE_OPS alone, and the Gumbel launch's work does not grow."""
    n = torch.tensor([70, 45, 0])
    valid = torch.arange(80)[None, :] < n[:, None]
    fwds = torch.full((3, 80, 1024), 1.0 / 1024.0, dtype=dtype)
    attens = torch.full((16,), 0.5, dtype=dtype)
    one = viterbi_sample_work(fwds, valid, attens)
    two = viterbi_sample_work(torch.cat([fwds, fwds]),
                              torch.cat([valid, valid]), attens)
    draws = int((n - 1).clamp(min=0).sum()) * 16
    assert two[1] - one[1] == draws * 1024 * SAMPLE_OPS
    noise = viterbi_gumbel_work(valid, 16, dtype)
    assert noise == viterbi_gumbel_work(torch.cat([valid, valid]), 16, dtype)
    assert one[1] == draws * 1024 * SAMPLE_OPS + noise[1]
    assert noise[0] == 16 * 69 * 1024 * fwds.element_size()
    # the noise's integer operations, the call's only ones
    assert one[2] == two[2] == noise[2] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gumbel_bound_counts_threefry_at_the_int32_peak(dtype):
    """The Gumbel launch's integer work is a threefry2x32 and the fraction
    bits per state and two threefry2x32 (and the index split) per row; the
    bound is the longest of its bytes at the memory rate, its float
    operations at the dtype's peak and its integer ones at the INT32
    peak, which the integers set at phase 2's 16 candidates."""
    valid = torch.arange(80)[None, :] < torch.tensor([70, 45])[:, None]
    nbytes, ops, int_ops = viterbi_gumbel_work(valid, 16, dtype)
    rows = 16 * 69
    assert ops == rows * 1024 * GUMBEL_OPS
    assert int_ops == rows * (1024 * (THREEFRY_OPS + BITS_OPS[dtype])
                              + 2 * THREEFRY_OPS + 2)
    ms, by = bound_ms(nbytes, ops, dtype, int_ops)
    assert ms == max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype],
                     int_ops / INT32_OPS_PER_S) * 1e3
    assert (by == "operations") == (dtype == torch.float32)
    assert (bound_ms(nbytes, ops, dtype)[0] < ms) == (dtype == torch.float32)


def _grown(x, rows, levels, fill=0):
    """x [E, T] with `rows` more rows and `levels` more levels of `fill`."""
    big = torch.full((x.shape[0] + rows, x.shape[1] + levels), fill,
                     dtype=x.dtype)
    big[: x.shape[0], : x.shape[1]] = x
    return big


@pytest.mark.parametrize("kernel", ["viterbi_obs", "likes", "geom",
                                    "windows"])
def test_prologue_work_counts_leave_out_padding(kernel):
    """The observation, likes, geometry and windows launches: padded
    regions, rows, events and levels change neither bytes nor operations."""
    if kernel == "viterbi_obs":
        evs = [simulate_session(np.random.default_rng(s), ref_len=n,
                                coverage=3)[0].events
               for s, n in ((1, 110), (2, 130))]
        _, (lvl, sd, valid, tabs), _ = obs_inputs(evs, "cpu", torch.float32)
        B, R, E = valid.shape
        big_v = torch.zeros((B + 2, R + 64, E + 3), dtype=torch.bool)
        big_v[:B, :R, :E] = valid
        work = viterbi_obs_work(lvl, valid, tabs)
        assert work == viterbi_obs_work(
            torch.zeros(big_v.shape), big_v,
            torch.zeros((B + 2, 6, E + 3, 1024)))
        assert work[0] > 0 and work[1] > 0
        return
    batch, states, i0, i1, is_pad = _fill_inputs()
    r = get_fill(WIDTH)(batch, states, i0, i1, is_pad, 4.5, False)
    T = batch.mean.shape[1]
    ral, _ = backtrace(r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1, r.best_i,
                       r.best_j, T, states.shape[0] + 2 * T + 8)
    C = states.shape[0]
    big_ral = _grown(ral, 5, 64)
    if kernel == "likes":
        work, padded = likes_work(ral, C), likes_work(big_ral, C)
    elif kernel == "geom":
        big_n0 = torch.cat([batch.n0, torch.ones(5, dtype=batch.n0.dtype)])
        work = geom_work(ral, batch.n0, C)
        padded = geom_work(big_ral, big_n0, C)
    else:
        big, _, _ = _padded(batch, states, is_pad)
        i0r = i0[:, : C + 1]
        work = windows_work(batch, i0r, 2 * WIDTH + 1)
        padded = windows_work(big, _grown(i0r, 5, 0), 2 * WIDTH + 1)
    assert work == padded
    assert work[0] > 0 and (work[1] > 0 or kernel == "windows")
