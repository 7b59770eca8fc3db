"""Each hand kernel of the port against its plain PyTorch twin on the GPU
(small regions at the main path's band widths; chip_smoke.py repeats this
at main-path shapes).  The fill runs at W = 41, 201, 601 and 801 (one or
two warps of scan, a ragged last warp, the realign width, and a band wide
enough for the block without a spare warp), forward with steps and
backward with and without, the group scorer at
Ws = 41 and 201 (Refine's point width and Mutate's scoring width): f64 must
equal the twin exactly, f32 within tolerances, with the step bytes, best
coordinates and accept signs held.  The backtrace, the Viterbi sweep (with
and without backpointers, one region with all rows real or none) and the
sampler (1 and 16 candidates) and its Gumbel kernel alone must equal their
twins exactly in f64 and f32.  A 2x2 mesh of the one card gives the single
device's group totals bit for bit, and the fill, backtrace and scorer on
cuda:1 equal their twins (skipped with one card).  Marked `cuda`: they skip
where torch sees no GPU.  Run them on the card with

    PSQ_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.core.regions import MutationInfo
from poreseq_tpu_torch.engine.driver import find_point_mutations
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.sim import simulate_session

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def engine(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from poreseq_tpu_torch.engine import TorchEngine

    return TorchEngine("cuda", request.param)


def _data(realign=24, scoring=12, seed=0, coverage=6, ref_len=240):
    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                             coverage=coverage, draft_error=0.03)
    pa.params.update(realign_width=realign, scoring_width=scoring)
    return AlignData.from_session(pa)


def _fill_args(engine, data, backward, steps=True):
    from poreseq_tpu_torch.engine.pack import fill_geometry

    ctx = engine._prepare_multi([data])
    fi = fill_geometry(ctx["arrays"], ctx["ref_indexes"], ctx["S_e"],
                       ctx["C"], data.params.realign_width)
    t = lambda x: torch.as_tensor(x, device=engine.device)
    return (ctx["batch"], t(ctx["states2"]), t(fi["i0"]), t(fi["i1"]),
            t(fi["is_pad"]), 4.5, backward, 2 * data.params.realign_width + 1,
            steps)


def _tols(dtype):
    return (1e-11, 1e-9) if dtype == torch.float64 else (2e-5, 2e-4)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("backward,steps",
                         [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("realign", [20, 100, 300, 400])
def test_fill_kernel_matches_twin(engine, backward, steps, realign):
    from poreseq_tpu_torch.engine.dp import fill_reference, finish_fill
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda

    data = _data(realign=realign, ref_len=max(240, 2 * realign))
    args = _fill_args(engine, data, backward, steps)
    n = FILL.launches
    got = fill_cuda(*args)
    assert FILL.launches == n + 1
    ref = fill_reference(*args)
    if engine.dtype == torch.float64:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        return
    rtol, atol = _tols(engine.dtype)
    for a, b in zip(got, ref):
        if a.dtype in (torch.float32, torch.float64):
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        elif a.numel():                          # step bytes, when asked for
            assert (a == b).double().mean().item() > 0.9995
    i0, i1 = args[2], args[3]
    rg, rr = finish_fill(*got, i0, i1, backward), finish_fill(*ref, i0, i1,
                                                              backward)
    assert torch.equal(rg.best_i, rr.best_i)
    assert torch.equal(rg.best_j, rr.best_j)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_backtrace_kernel_matches_twin(engine):
    from poreseq_tpu_torch.engine.align import (backtrace_cuda,
                                                backtrace_reference)
    from poreseq_tpu_torch.engine.fill import get_fill

    batch, states, i0, i1, pad, off, _, W, _ = _fill_args(engine, _data(),
                                                          False)
    r = get_fill((W - 1) // 2)(batch, states, i0, i1, pad, off, False)
    T = batch.mean.shape[1]
    args = (r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1, r.best_i, r.best_j,
            T, states.shape[0] + 2 * T + 8)
    ral_k, rlk_k = backtrace_cuda(*args)
    ral_r, rlk_r = backtrace_reference(*args)
    assert torch.equal(ral_k, ral_r)
    assert torch.equal(rlk_k, rlk_r)


def _viterbi_events():
    """Three simulated regions of 110-200 b, of different lengths."""
    return [simulate_session(np.random.default_rng(s), ref_len=n,
                             coverage=c)[0].events
            for s, n, c in ((3, 150, 6), (9, 110, 4), (4, 200, 5))]


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("need_bp", [False, True])
def test_viterbi_sweep_kernel_matches_twin(engine, need_bp):
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_SWEEP, sweep_inputs,
                                                  viterbi_sweep_cuda,
                                                  viterbi_sweep_reference)

    # 3 regions in a bucket of 4: one padded region, and padded rows
    _, obs, n_real = sweep_inputs(_viterbi_events(), "cuda", engine.dtype)
    n = VITERBI_SWEEP.launches
    got = viterbi_sweep_cuda(obs, n_real, 0.05, 0.01, need_bp)
    assert VITERBI_SWEEP.launches == n + 1
    ref = viterbi_sweep_reference(obs, n_real, 0.05, 0.01, need_bp)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("nk", [1, 16])
def test_viterbi_sample_kernel_matches_twin(engine, nk):
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_GUMBEL,
                                                  VITERBI_SAMPLE,
                                                  sample_inputs,
                                                  sample_paths_cuda,
                                                  sample_paths_reference,
                                                  sweep_inputs,
                                                  transition_matrix,
                                                  viterbi_sweep)

    _, obs, n_real = sweep_inputs(_viterbi_events(), "cuda", engine.dtype)
    liks, fwds, _ = viterbi_sweep(obs, n_real, 0.05, 0.01)
    args = sample_inputs(liks, fwds, n_real, nk, 0.33, 0.75)
    n, g = VITERBI_SAMPLE.launches, VITERBI_GUMBEL.launches
    got = sample_paths_cuda(*args, 0.05, 0.01, 7)
    assert VITERBI_SAMPLE.launches == n + 1
    assert VITERBI_GUMBEL.launches == g + 1
    T = transition_matrix(0.05, 0.01, engine.dtype, "cuda")
    assert torch.equal(got, sample_paths_reference(T, *args, 7))


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("real", ["all", "none"])
def test_viterbi_kernels_one_region_match_twins(engine, real):
    """B = 1: one region with all its rows real, or with none (n_real = 0:
    the sweep passes the carry, the sampler keeps the start state)."""
    from poreseq_tpu_torch.engine.viterbi import (sample_inputs,
                                                  sample_paths_cuda,
                                                  sample_paths_reference,
                                                  sweep_inputs,
                                                  transition_matrix,
                                                  viterbi_sweep_cuda,
                                                  viterbi_sweep_reference)

    _, obs, n_real = sweep_inputs(_viterbi_events()[:1], "cuda",
                                  engine.dtype)
    obs, n_real = obs[:1].contiguous(), n_real[:1].contiguous()
    if real == "none":
        n_real = torch.zeros_like(n_real)
    for bp in (False, True):
        got = viterbi_sweep_cuda(obs, n_real, 0.05, 0.01, bp)
        ref = viterbi_sweep_reference(obs, n_real, 0.05, 0.01, bp)
        for a, b in zip(got, ref):
            assert (a is None and b is None) or torch.equal(a, b)
    args = sample_inputs(ref[0], ref[1], n_real, 16, 0.33, 0.75)
    T = transition_matrix(0.05, 0.01, engine.dtype, "cuda")
    assert torch.equal(sample_paths_cuda(*args, 0.05, 0.01, 3),
                       sample_paths_reference(T, *args, 3))


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_viterbi_gumbel_kernel_matches_twin(engine):
    """The sampler's Gumbel kernel equals -log(-log(u)) on the counter
    uniforms, bit for bit, and counts its own launches only."""
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_GUMBEL,
                                                  VITERBI_SAMPLE, gumbel_cuda,
                                                  gumbel_reference)

    n, g = VITERBI_SAMPLE.launches, VITERBI_GUMBEL.launches
    got = gumbel_cuda(7, 16, 70, engine.dtype, "cuda")
    assert (VITERBI_SAMPLE.launches, VITERBI_GUMBEL.launches) == (n, g + 1)
    ref = gumbel_reference(7, 16, torch.arange(70, device="cuda"),
                           engine.dtype)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("coverages", [(6,), (24, 22, 18)])
@pytest.mark.parametrize("scoring", [20, 100])
def test_group_kernel_matches_twin(engine, coverages, scoring):
    # (24, 22, 18): three regions fill the 64-row event bucket, so the last
    # region's row slice overruns it and is clamped to E - E_g
    from poreseq_tpu_torch.engine.mutscore import (group_deltas_reference,
                                                   group_launches,
                                                   group_totals_cuda,
                                                   sum_rows_reference)

    datas, mlists = [], []
    for r, cov in enumerate(coverages):
        data = _data(realign=scoring + 50, scoring=scoring, seed=r,
                     coverage=cov)
        tail = MutationInfo()
        tail.start, tail.orig, tail.mut = len(data.sequence), "", "ACGTACGTA"
        datas.append(data)
        mlists.append(find_point_mutations(data) + [tail])
    clamped = 0
    for gp, _, args in group_launches(engine, datas, mlists,
                                      [True] * len(datas)):
        E, E_g = args[1].shape[1], args[21]
        clamped += int((gp["g_evoff"][: gp["G"]] > E - E_g).sum())
        tot_k, d_k = group_totals_cuda(*args)
        d_r = group_deltas_reference(*args)
        tot_r = sum_rows_reference(d_r)
        if engine.dtype == torch.float64:
            assert torch.equal(tot_k, tot_r)
        else:
            torch.testing.assert_close(tot_k, tot_r, rtol=2e-4, atol=3e-3)
            valid = args[13]["s_valid"].bool()
            assert not bool(((((tot_k - 1e-6) > 0) != ((tot_r - 1e-6) > 0))
                             & valid).any())
    assert (clamped > 0) == (len(coverages) > 1)


@pytest.mark.parametrize("engine", [torch.float32], indirect=True)
def test_kernel_wrappers_reject_bad_operands(engine):
    from poreseq_tpu_torch.engine.fill import fill_cuda

    from poreseq_tpu_torch.engine.viterbi import (sample_inputs,
                                                  sample_paths_cuda,
                                                  sweep_inputs,
                                                  viterbi_sweep_cuda)

    args = list(_fill_args(engine, _data(), False))
    args[1] = args[1].to(torch.int64)            # states must be int32
    with pytest.raises(ValueError, match="states"):
        fill_cuda(*args)
    _, obs, n_real = sweep_inputs(_viterbi_events()[:1], "cuda",
                                  engine.dtype)
    with pytest.raises(ValueError, match="n_real"):
        viterbi_sweep_cuda(obs, n_real.int(), 0.05, 0.01)
    with pytest.raises(ValueError, match="obs"):        # 1024 states
        viterbi_sweep_cuda(obs[..., :512].contiguous(), n_real, 0.05, 0.01)
    liks, fwds, _ = viterbi_sweep_cuda(obs, n_real, 0.05, 0.01)
    fwds, valid, startst, attens = sample_inputs(liks, fwds, n_real, 4, 0.33,
                                                 0.75)
    with pytest.raises(ValueError, match="valid_rows"):
        sample_paths_cuda(fwds, valid.long(), startst, attens, 0.05, 0.01, 0)
    with pytest.raises(ValueError, match="startst"):
        sample_paths_cuda(fwds, valid, startst.int(), attens, 0.05, 0.01, 0)
    with pytest.raises(ValueError, match="attens"):
        sample_paths_cuda(fwds, valid, startst, attens.double(), 0.05, 0.01,
                          0)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_sum_rows_kernel_matches_twin(engine):
    from poreseq_tpu_torch.engine.mutscore import (MUTSCORE, sum_rows,
                                                   sum_rows_reference)

    g = torch.Generator().manual_seed(0)
    deltas = torch.randn((37, 9, 23), generator=g, dtype=engine.dtype)
    n = MUTSCORE.launches
    got = sum_rows(deltas.cuda())
    assert MUTSCORE.launches == n + 1
    assert torch.equal(got.cpu(), sum_rows_reference(deltas))


def _mesh_regions(scoring=6):
    """Three regions whose rows straddle the 'ev' shards of a 2-row mesh,
    each with every point mutation."""
    datas, mlists = [], []
    for r, cov in enumerate((14, 20, 16)):
        data = _data(realign=16, scoring=scoring, seed=r, coverage=cov,
                     ref_len=80)
        datas.append(data)
        mlists.append(find_point_mutations(data))
    return datas, mlists


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_mesh_on_one_card_equals_single_device(engine):
    """A 2x2 mesh of cuda:0 four times: the group scorer's totals equal the
    single-device launch's bit for bit on the same (host) band geometry,
    and every shard launched the fill, the backtrace and the scorer."""
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.mutscore import (group_launches,
                                                   group_totals,
                                                   group_totals_sharded)
    from poreseq_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2, [torch.device("cuda:0")] * 4)
    out = {}
    for name, eng in (("single", engine),
                      ("mesh", TorchEngine("cuda", engine.dtype,
                                           mesh=mesh))):
        datas, mlists = _mesh_regions()
        run = group_totals if eng.mesh is None else group_totals_sharded
        out[name] = [run(*args) for _, _, args in group_launches(
            eng, datas, mlists, [True] * 3, host_geometry=True)]
    assert len(out["single"]) == len(out["mesh"]) > 0
    for a, b in zip(out["single"], out["mesh"]):
        assert torch.equal(a, b)
    for shard, launches in mesh.shard_launches().items():
        for k in ("fill", "backtrace", "mutscore"):
            assert launches.get(k, 0) > 0, (shard, k)


@pytest.mark.parametrize("engine", [torch.float64], indirect=True)
def test_kernels_on_second_card_match_twins(engine):
    """The fill, the backtrace and the group scorer launched on cuda:1 (the
    wrappers enter their operands' device) equal their twins."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA GPU")
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.align import (backtrace_cuda,
                                                backtrace_reference)
    from poreseq_tpu_torch.engine.dp import fill_reference
    from poreseq_tpu_torch.engine.fill import fill_cuda, get_fill
    from poreseq_tpu_torch.engine.mutscore import (group_deltas_reference,
                                                   group_launches,
                                                   group_totals_cuda,
                                                   sum_rows_reference)

    eng = TorchEngine("cuda:1", torch.float64)
    data = _data()
    args = _fill_args(eng, data, False)
    got = fill_cuda(*args)
    assert got[0].device == torch.device("cuda:1")
    for a, b in zip(got, fill_reference(*args)):
        assert torch.equal(a, b)
    r = get_fill(24)(*args[:7])
    T = args[0].mean.shape[1]
    bt = (r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1, r.best_i, r.best_j,
          T, args[1].shape[0] + 2 * T + 8)
    for a, b in zip(backtrace_cuda(*bt), backtrace_reference(*bt)):
        assert torch.equal(a, b)
    datas, mlists = _mesh_regions()
    for _, _, ga in group_launches(eng, datas, mlists, [True] * 3):
        tot, _ = group_totals_cuda(*ga)
        assert tot.device == torch.device("cuda:1")
        assert torch.equal(tot, sum_rows_reference(
            group_deltas_reference(*ga)))
