"""Each hand kernel of the port against its plain PyTorch twin on the GPU
(small shapes; chip_smoke.py repeats this at main-path shapes).  Marked
`cuda`: they skip where torch sees no GPU.  Run them on the card with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from poreseq_tpu.core.regions import MutationInfo
from poreseq_tpu.engine.driver import find_point_mutations
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def engine(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from poreseq_tpu_torch.engine import TorchEngine

    return TorchEngine("cuda", request.param)


def _data(realign=24, scoring=12, seed=0, coverage=6):
    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=240,
                             coverage=coverage, draft_error=0.03)
    pa.params.update(realign_width=realign, scoring_width=scoring)
    return AlignData.from_session(pa)


def _fill_args(engine, data, backward):
    from poreseq_tpu_torch.engine.pack import fill_geometry

    ctx = engine._prepare_multi([data])
    fi = fill_geometry(ctx["arrays"], ctx["ref_indexes"], ctx["S_e"],
                       ctx["C"], data.params.realign_width)
    t = lambda x: torch.as_tensor(x, device="cuda")
    return (ctx["batch"], t(ctx["states2"]), t(fi["i0"]), t(fi["i1"]),
            t(fi["is_pad"]), 4.5, backward, 2 * data.params.realign_width + 1,
            True)


def _tols(dtype):
    return (1e-11, 1e-9) if dtype == torch.float64 else (2e-5, 2e-4)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("backward", [False, True])
def test_fill_kernel_matches_twin(engine, backward):
    from poreseq_tpu_torch.engine.dp import fill_reference
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda

    args = _fill_args(engine, _data(), backward)
    n = FILL.launches
    got = fill_cuda(*args)
    assert FILL.launches == n + 1
    ref = fill_reference(*args)
    rtol, atol = _tols(engine.dtype)
    for a, b in zip(got, ref):
        if a.dtype in (torch.float32, torch.float64):
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        else:
            assert (a == b).double().mean().item() > 0.9995


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
    torch.testing.assert_close(ral_k, ral_r, rtol=0, atol=0)
    rtol, atol = _tols(engine.dtype)
    torch.testing.assert_close(rlk_k, rlk_r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("coverages", [(6,), (24, 22, 18)])
def test_group_kernel_matches_twin(engine, coverages):
    # (24, 22, 18): three regions fill the 64-row event bucket, so the last
    # region's row slice overruns it and is clamped to E - E_g
    from poreseq_tpu_torch.engine.mutscore import (group_deltas_reference,
                                                   group_launches,
                                                   group_totals_cuda,
                                                   sum_rows_reference)

    datas, mlists = [], []
    for r, cov in enumerate(coverages):
        data = _data(scoring=6, seed=r, coverage=cov)
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
            torch.testing.assert_close(tot_k, tot_r, rtol=0, atol=1e-8)
        else:
            torch.testing.assert_close(tot_k, tot_r, rtol=2e-4, atol=3e-3)
            valid = args[13]["s_valid"].bool()
            assert not bool(((((tot_k - 1e-6) > 0) != ((tot_r - 1e-6) > 0))
                             & valid).any())
    assert (clamped > 0) == (len(coverages) > 1)


@pytest.mark.parametrize("engine", [torch.float32], indirect=True)
def test_kernel_wrappers_reject_bad_operands(engine):
    from poreseq_tpu_torch.engine.fill import fill_cuda

    args = list(_fill_args(engine, _data(), False))
    args[1] = args[1].to(torch.int64)            # states must be int32
    with pytest.raises(ValueError, match="states"):
        fill_cuda(*args)
