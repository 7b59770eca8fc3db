"""Each hand kernel of the port against its plain PyTorch twin on the GPU
(small regions at the main path's band widths; chip_smoke.py repeats this
at main-path shapes).  The fill runs at W = 41, 201, 601 and 801 (one or
two warps of scan, a ragged last warp, the realign width, and a band wide
enough for the block without a spare warp) and at W = 1023, 1025, 1401,
2047 and 4095 (one row a thread at the edge, then two and four rows a
thread) and, on a small region, at W = 4097 and 8193 (the wide instance,
its column in shared memory or a device scratch) and at W = 4097, 6450,
8193 and 16,384 (the cluster instance, 5 to 16 CTAs an event, with dead
columns and an inactive event, equal to the twin and to the wide
instance bit for bit), forward with steps and backward with and without,
the group scorer at Ws = 41 and 201 (Refine's point width and Mutate's
scoring width), 1025 and 1201 (two window rows a thread), 4095 (four)
and 4097 (the wide instance, on a small region), and at Ws = 4097, 5001,
8193 and its largest, 32,769 (the cluster instance, 2 to 16 CTAs a pair,
with and without its extra row, equal to the wide instance bit for bit):
f64 must
equal the twin exactly, f32 within tolerances, with the step bytes, best
coordinates and accept signs held, and the fill's running best (best,
best_i, best_j, best_pfx) equal to dp.finish_fill on its own column maxima.
The backtrace (W = 49 and 1401), the Viterbi sweep (with and without backpointers, one region
with all rows real or none), the sampler (1 and 16 candidates) and its
Gumbel kernel alone (R = 1, nk = 1, rows below, at and above one pass of
its grid), the Viterbi observations (E_pad 1 to 32: the tiled
instance; 33 to 64: the tiled64 instance; 65, 100, 257, 8193 and 12,289: the
chunked instance, its register list and its histogram passes over the
order keys' digits; each instance also below its cap; rows with every event
valid, some, one and none; ragged row tiles; and the engine's candidates
on a 30X batch in f64 equal to the CPU twins'), the per-base likes (T up to 3000, and a
backtrace at W = 1401), the scoring geometry (unsorted rows; T 1 to 4000
levels, C 1 to 3000 columns; at, past and twice its shared-memory level
cap; its cluster instance at 256 levels past the cap, twice it and near
its capacity of 16 slices, at several cluster sizes, equal to the memory
instance too, and the memory instance past that capacity; and one engine
call, score_mutations_multi on a 60 kb region, whose geometry runs on the
cluster instance, held to the CPU twin) and its windows (T not a multiple of 32; Ws up to 1201) must equal
their twins exactly in f64 and f32.  A 2x2 mesh of the one card gives the single
device's group totals bit for bit (also at W = 1401, Ws = 1201), and the fill, backtrace and scorer on
cuda:1 equal their twins (skipped with one card).  At the genome-scale
path's shapes (a 10 kb region, C = 10,112, of events trimmed to their
band-reachable range) the fill (an 8-row slice), the backtrace, the
geometry and the group scorer hold to their twins too.  Marked `cuda`: they skip
where torch sees no GPU.  Run them on the card with

    PSQ_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import re
from pathlib import Path

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
@pytest.mark.parametrize("realign", [20, 100, 300, 400, 511, 512, 700, 1023,
                                     2047])
def test_fill_kernel_matches_twin(engine, backward, steps, realign):
    data = _data(realign=realign, ref_len=max(240, 2 * realign))
    _hold_fill(engine, _fill_args(engine, data, backward, steps))


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("backward,steps",
                         [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("realign", [2048, 4096])
def test_fill_wide_instance_matches_twin(engine, backward, steps, realign):
    """W = 4097 and 8193 (the wide instance, named: in f32 at 4097 its
    column in shared memory, else in a device scratch) on a 240 b region at
    6X."""
    from poreseq_tpu_torch.engine.fill import FILL

    n = FILL.instances["wide"]
    _hold_fill(engine, _fill_args(engine, _data(realign=realign), backward,
                                  steps), instance="wide")
    assert FILL.instances["wide"] == n + 1


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("backward,steps",
                         [(False, True), (False, False), (True, False),
                          (True, True)])
@pytest.mark.parametrize("W", [4097, 6450, 8193, 16384])
def test_fill_cluster_instance_matches_twin(engine, backward, steps, W):
    """The cluster instance (ceil(W / 1024) CTAs an event, 5 to 16) at W =
    4097, 6450 (past the wide instance's shared-memory cap in f32), 8193
    and its widest, 16,384, on a 240 b region at 6X whose shorter events
    end in dead columns, one event made inactive: every output equal to
    the twin's (max |diff| 0) and to the wide instance's, its running best
    equal to dp.finish_fill on its own column maxima."""
    from poreseq_tpu_torch.engine.dp import fill_reference, finish_fill
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda, fill_instance

    args = list(_fill_args(engine, _data(realign=(W - 1) // 2), backward,
                           steps))
    args[7] = W
    batch = args[0]
    active = batch.active.clone()
    active[1] = False
    args[0] = batch._replace(active=active)
    E = args[1].shape[1]
    assert bool(args[4].any()) and fill_instance(W, E, engine.dtype) == \
        "cluster"
    n = FILL.instances["cluster"]
    got = fill_cuda(*args, instance="cluster")
    assert FILL.instances["cluster"] == n + 1
    ref = fill_reference(*args)
    own = finish_fill(*got[:6], args[2], args[3], backward)
    for name, k in zip(("best_pfx", "best", "best_i", "best_j"), got[6:]):
        assert torch.equal(k, getattr(own, name)), name
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for a, b in zip(got, fill_cuda(*args, instance="wide")):
        assert torch.equal(a, b)


def _hold_fill(engine, args, instance=None):
    """One fill launch (of the instance named, else the route's) against
    its twin: its running best equal to dp.finish_fill on its own column
    maxima; f64 equal to the twin, f32 within tolerances, the step bytes
    >= 99.95 % equal and the best coordinates equal."""
    from poreseq_tpu_torch.engine.dp import fill_reference, finish_fill
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda

    backward = args[6]
    n = FILL.launches
    got = fill_cuda(*args, instance=instance)
    assert FILL.launches == n + 1
    i0, i1 = args[2], args[3]
    own = finish_fill(*got[:6], i0, i1, backward)
    for name, k in zip(("best_pfx", "best", "best_i", "best_j"), got[6:]):
        assert torch.equal(k, getattr(own, name)), name
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
    rg, rr = own, finish_fill(*ref, i0, i1, backward)
    assert torch.equal(rg.best_i, rr.best_i)
    assert torch.equal(rg.best_j, rr.best_j)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("realign", [24, 700])
def test_backtrace_kernel_matches_twin(engine, realign):
    """At W = 49 and at W = 1401, a fill of two rows a thread."""
    from poreseq_tpu_torch.engine.align import (backtrace_cuda,
                                                backtrace_reference)
    from poreseq_tpu_torch.engine.fill import get_fill

    data = _data(realign=realign, ref_len=max(240, 2 * realign))
    batch, states, i0, i1, pad, off, _, W, _ = _fill_args(engine, data,
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


def _gumbel_grid_rows():
    """Rows the Gumbel kernel's grid takes in one pass: 132 SM_BLOCKS
    blocks of NT / 256 rows (constants read from csrc/viterbi_gumbel.cu)."""
    text = (Path(__file__).resolve().parents[1] / "poreseq_tpu_torch"
            / "csrc" / "viterbi_gumbel.cu").read_text()
    nt, sm_blocks = (int(re.search(rf"constexpr int {n} = (\d+);",
                                   text).group(1))
                     for n in ("NT", "SM_BLOCKS"))
    return 132 * sm_blocks * (nt // 256)


# (nk, R) of the Gumbel kernel's edges, for G rows a grid pass (a warp
# derives the keys of its next 32 rows at once: 32 G rows a key pass)
GUMBEL_SHAPES = {"one row": lambda G: (1, 1),
                 "one candidate": lambda G: (1, 700),
                 "one row each": lambda G: (16, 1),
                 "below the grid": lambda G: (16, 40),
                 "the grid": lambda G: (4, G // 4),
                 "above the grid": lambda G: (3, G // 2 + 1),
                 "a key pass": lambda G: (16, 2 * G),
                 "above a key pass": lambda G: (5, 32 * G // 5 + 1)}


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("shape", ["16 x 70"] + list(GUMBEL_SHAPES))
def test_viterbi_gumbel_kernel_matches_twin(engine, shape):
    """The sampler's Gumbel kernel equals its twin's threefry noise (JAX's
    keys, uniforms and -log(-log(u))), bit for bit, and counts its own
    launches only: 16 candidates of 70 rows, R = 1, nk = 1, and nk R below,
    equal to and above (about 1.5 passes) the rows its grid takes in one
    pass and those of one pass of row keys (32 rows a warp), and one row
    above it."""
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_GUMBEL,
                                                  VITERBI_SAMPLE, gumbel_cuda,
                                                  gumbel_reference)

    nk, R = ((16, 70) if shape == "16 x 70"
             else GUMBEL_SHAPES[shape](_gumbel_grid_rows()))
    n, g = VITERBI_SAMPLE.launches, VITERBI_GUMBEL.launches
    got = gumbel_cuda(7, nk, R, engine.dtype, "cuda")
    assert (VITERBI_SAMPLE.launches, VITERBI_GUMBEL.launches) == (n, g + 1)
    ref = gumbel_reference(7, nk, torch.arange(R, device="cuda"),
                           engine.dtype)
    assert torch.equal(got, ref)


def _obs_inputs(E, dtype, seed=0, B=2, R=70):
    """Observation operands [B, R, E] with plausible model tables: rows of
    every valid count 0..min(E, R - 1) (so every nskip: up to 8 on the
    tiled path, E <= 32, and past the general path's register list of 8 at
    E = 64), event 1 a copy of event 0 (ties), stdv 0 now and then (the
    clamp)."""
    rng = np.random.default_rng(seed)
    lvl = rng.normal(60, 8, (B, R, E))
    sd = np.where(rng.random((B, R, E)) < 0.05, 0.0,
                  rng.uniform(0.5, 3, (B, R, E)))
    valid = np.zeros((B, R, E), dtype=bool)
    for b in range(B):
        for r in range(R):
            valid[b, r, rng.choice(E, r % (E + 1), replace=False)] = True
    lm, ls = rng.normal(60, 8, (B, E, 1024)), rng.uniform(1, 3, (B, E, 1024))
    sm, lam = rng.uniform(0.8, 2, (B, E, 1024)), rng.uniform(1, 4,
                                                             (B, E, 1024))
    tabs = np.stack([lm, ls, np.log(ls), sm, lam, np.log(lam)], 1)
    if E > 1:
        lvl[:, :, 1], sd[:, :, 1] = lvl[:, :, 0], sd[:, :, 0]
        tabs[:, :, 1] = tabs[:, :, 0]
    t = lambda x, d=dtype: torch.as_tensor(x, dtype=d, device="cuda")
    return t(lvl), t(sd), t(valid, torch.bool), t(tabs)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("E,R", [(1, 70), (16, 70), (31, 70), (32, 70),
                                 (33, 70), (60, 70), (64, 70), (65, 70),
                                 (257, 70), (32, 1), (14, 960)])
def test_viterbi_obs_kernel_matches_twin(engine, E, R):
    """E_pad below, at and above the tiled instance's cap of 32 events (33,
    60 (the loader's 30 reads, two rows each) and 64 take the tiled64
    instance, 65 and 257 the chunked one; rows reach nskip > 8), R = 70
    (not a multiple of the 16-row tile nor of the chunked instance's 8
    rows), 960 (phase 2b's rows) and 1."""
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_OBS,
                                                  obs_multi_cuda,
                                                  obs_multi_reference,
                                                  sweep_inputs)

    args = _obs_inputs(E, engine.dtype, R=R)
    n = VITERBI_OBS.launches
    got = obs_multi_cuda(*args)
    assert VITERBI_OBS.launches == n + 1
    assert torch.equal(got, obs_multi_reference(*args))
    # the sweep's operands of three real regions go through the kernel
    n = VITERBI_OBS.launches
    sweep_inputs(_viterbi_events(), "cuda", engine.dtype)
    assert VITERBI_OBS.launches == n + 1


def _obs_rows_inputs(E, dtype, fracs, seed=0):
    """Observation operands of one region [1, R, E], row r with each event
    valid with probability fracs[r] (1.0: all), then rows of 2, 1 and 0
    valid events; event 1 a copy of event 0 (ties), stdv 0 now and then."""
    rng = np.random.default_rng(seed + E)
    R = len(fracs) + 3
    lvl, sd, valid, tabs = (x.cpu().numpy() for x in _obs_inputs(
        E, torch.float64, seed, B=1, R=R))
    for r, frac in enumerate(fracs):
        valid[0, r] = rng.random(E) < frac
    valid[0, len(fracs):] = False
    valid[0, len(fracs), :2] = True
    valid[0, len(fracs) + 1, E // 2] = True
    t = lambda x, d=dtype: torch.as_tensor(x, dtype=d, device="cuda")
    return t(lvl), t(sd), t(valid, torch.bool), t(tabs)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("E,path", [(64, "tiled64"), (100, "chunked"),
                                    (8193, "chunked"), (12289, "chunked")])
def test_viterbi_obs_kernel_bisects_past_its_register_list(engine, E, path):
    """Rows of every event valid, 60 % and 5 % of them (nskip up to 3,072:
    past the chunked instance's register list of 8, its histogram passes
    over the order keys' digits) and of 2, 1 and 0 valid events, at E = 64
    (the tiled64 instance's cap), 100 and past 8192 events (the chunked
    instance, the events in many chunks): equal to the twin in f64 and
    f32, counted under the instance's name."""
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_OBS,
                                                  obs_multi_cuda,
                                                  obs_multi_reference)

    args = _obs_rows_inputs(E, engine.dtype, (1.0, 0.6, 0.05))
    n = VITERBI_OBS.instances[path]
    got = obs_multi_cuda(*args)
    assert VITERBI_OBS.instances[path] == n + 1
    assert torch.equal(got, obs_multi_reference(*args))
    assert int(args[2][0, 0].sum()) // 4 > 8


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("instance", ["tiled64", "chunked"])
def test_viterbi_obs_instances_take_any_events_below_their_cap(engine,
                                                               instance):
    """An instance named in place of the route's choice (the tools time
    them side by side) equals the twin at E_pad below its cap too, and
    the wrapper refuses one whose cap is below E_pad before a launch."""
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_OBS,
                                                  obs_multi_cuda,
                                                  obs_multi_reference)

    for E in (1, 14, 33):
        args = _obs_inputs(E, engine.dtype, R=40)
        n = VITERBI_OBS.instances[instance]
        got = obs_multi_cuda(*args, instance=instance)
        assert VITERBI_OBS.instances[instance] == n + 1
        assert torch.equal(got, obs_multi_reference(*args))
    n = VITERBI_OBS.launches
    with pytest.raises(ValueError, match="at most"):
        obs_multi_cuda(*_obs_inputs(33, engine.dtype, R=4), instance="tiled")
    assert VITERBI_OBS.launches == n


def test_viterbi_mutate_multi_at_30x_equals_the_cpu_twin():
    """The engine's Viterbi candidates on a 30X batch (chip_smoke.py's
    coverage run: three of its regions as the loader gives them, up to 60
    event rows; E_pad past the tiled instance's cap) in f64: the same 16
    candidates a region on the card as on the CPU twins, through the
    tiled64 observation instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import chip_smoke
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.viterbi import VITERBI_OBS

    events = chip_smoke.coverage_events(0, [1, 3, 6])
    assert max(len(e) for e in events) > 32
    run = lambda dev: TorchEngine(dev, torch.float64, seed=5) \
        .viterbi_mutate_multi(events, 16, 0.05, 0.01, 0.33, 0.75)
    n = VITERBI_OBS.instances["tiled64"]
    card = run("cuda")
    assert VITERBI_OBS.instances["tiled64"] == n + 1
    assert card == run("cpu")
    assert all(len(c) == 16 for c in card)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_viterbi_obs_kernel_refuses_misaligned_tables(engine):
    """The tiled path stages tabs 16 bytes a copy: a contiguous view that
    starts off a 16-byte boundary is refused before a launch, and the card
    still runs the kernel on aligned tables after it."""
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_OBS,
                                                  obs_multi_cuda,
                                                  obs_multi_reference)

    lvl, sd, valid, tabs = _obs_inputs(14, engine.dtype, R=16)
    flat = torch.empty(tabs.numel() + 1, dtype=tabs.dtype, device="cuda")
    off = flat[1:].view(tabs.shape)
    off.copy_(tabs)
    n = VITERBI_OBS.launches
    with pytest.raises(ValueError, match="16-byte"):
        obs_multi_cuda(lvl, sd, valid, off)
    assert VITERBI_OBS.launches == n
    got = obs_multi_cuda(lvl, sd, valid, tabs)
    assert VITERBI_OBS.launches == n + 1
    assert torch.equal(got, obs_multi_reference(lvl, sd, valid, tabs))


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("shape", ["backtrace", "wide", "edges", "long"])
def test_likes_kernel_matches_twin(engine, shape):
    """A backtrace's ral/rlk at C columns (W = 49, and W = 1401: "wide"),
    and edge shapes: one event, one
    column, T = 70 (not a multiple of 32), no anchor, a plateau; and long
    rows: T = 1024 (one chunk of the block's 1024 levels), 1025 and 3000
    (several chunks, the last ragged), each with n_like = 1 and n_like > T,
    an event whose first anchor lies past n_like."""
    from poreseq_tpu_torch.engine.align import (LIKES, backtrace_cuda,
                                                likes_cuda, likes_reference)
    from poreseq_tpu_torch.engine.fill import get_fill

    if shape in ("backtrace", "wide"):
        realign = 24 if shape == "backtrace" else 700
        batch, states, i0, i1, pad, off, _, W, _ = _fill_args(
            engine, _data(realign=realign, ref_len=max(240, 2 * realign)),
            False)
        r = get_fill((W - 1) // 2)(batch, states, i0, i1, pad, off, False)
        T = batch.mean.shape[1]
        ral, rlk = backtrace_cuda(r.M, r.S, r.steps_m, r.steps_s, r.i0,
                                  r.i1, r.best_i, r.best_j, T,
                                  states.shape[0] + 2 * T + 8)
        cases = [(ral, rlk, states.shape[0])]
    elif shape == "edges":
        rng = np.random.default_rng(2)
        ral = np.where(rng.random((5, 70)) < 0.5,
                       np.cumsum(rng.integers(0, 3, (5, 70)), 1), 0.0)
        ral[0] = 0.0
        ral[1, :9] = 4.0
        t = lambda x: torch.as_tensor(x, dtype=engine.dtype, device="cuda")
        ral, rlk = t(ral), t(rng.random((5, 70)))
        cases = [(ral, rlk, 40), (ral[2:3].contiguous(),
                                  rlk[2:3].contiguous(), 1)]
    else:
        rng = np.random.default_rng(3)
        t = lambda x: torch.as_tensor(x, dtype=engine.dtype, device="cuda")
        cases = []
        for T in (1024, 1025, 3000):
            steps = np.where(rng.random((6, T)) < 0.45,
                             rng.integers(0, 3, (6, T)), 0)
            ref = np.cumsum(steps, 1) + rng.integers(0, 6, (6, 1))
            ral = np.where(steps > 0, ref, np.where(rng.random((6, T)) < 0.1,
                                                    -1.0, 0.0))
            ral[0] = 0.0                                  # no anchor
            ral[1, :7] = 5.0                              # a plateau
            ral[2] = np.where(ral[2] > 0, ral[2] + T + 7, ral[2])
            for n_like in (1, T + 7):                     # event 2 past it
                cases.append((t(ral), t(rng.random((6, T))), n_like))
    for ral, rlk, n_like in cases:
        n = LIKES.launches
        got = likes_cuda(ral, rlk, n_like)
        assert LIKES.launches == n + 1
        assert torch.equal(got, likes_reference(ral, rlk, n_like))


def _geom_rows(rng, E=48, T=70, C=50):
    """ral [E, T], n0 [E], S_e [E]: one anchored level (NaN flanks), level
    0 anchored then a gap (the level-0 quirk), no anchor, anchors only past
    n0, inactive rows (n0 = 1) and plain monotone rows (C >= 2; at T < 3
    the rows are cut to fit, as n0 = 0 may be)."""
    ral = np.zeros((E, T))
    n0 = rng.integers(T // 2, T + 1, E).astype(np.int32)
    for e in range(E):
        n, kind = int(n0[e]), e % 6
        if kind == 0 and n > 0:
            ral[e, int(rng.integers(0, n))] = rng.integers(1, C)
        elif kind in (1, 5):
            start = min(0 if kind == 1 else 2, T - 1)
            ral[e, start] = 2
            ref = 2
            for t in range(start + (6 if kind == 1 else 1), n):
                if rng.random() < 0.5:
                    ref += int(rng.integers(0, 3))
                    ral[e, t] = ref
                elif rng.random() < 0.2:
                    ral[e, t] = -1
        elif kind == 3:
            n0[e] = T // 3
            ral[e, T // 3 :] = np.arange(1, T - T // 3 + 1)
        elif kind == 4:
            n0[e] = 1
    return ral, n0, rng.integers(0, C + 1, E).astype(np.int32)


def _geom_edge_rows(T, C):
    """_geom_rows for the geometry kernel's edges (S_e up to C), plus an
    anchor at level 0 alone, below n0 = 1 and below n0 = T, and a row whose
    reference index slows to one in 20 levels over refs 500-560 and from
    994 on, so that band starts rise faster than DMAX a column across a
    warp's columns (512) and a pass's end (1024) and the rate limit's
    carries bind there."""
    rng = np.random.default_rng(T * 11 + C)
    ral, n0, S_e = _geom_rows(rng, E=12 if T < 1024 else 6, T=T,
                              C=max(C, 8))
    extra = np.zeros((3, T))
    extra[:2, 0] = 3.0
    t = np.arange(T)
    slow = ((t >= 500) & (t < 1700)) | (t >= 2134)
    extra[2] = np.floor(np.cumsum(np.where(slow, 0.05, 1.0)) + 1e-6)
    return (np.concatenate([ral, extra]),
            np.concatenate([n0, [1, T, T]]).astype(np.int32),
            np.concatenate([np.minimum(S_e, C),
                            [C, max(C - 3, 0), C]]).astype(np.int32))


GEOM_EDGES = ([(70, 1), (70, 50)]
              + [(T, C) for T in (1, 31, 255, 256, 257, 1024, 4000)
                 for C in (1, 255, 256, 257, 1024, 1025, 3000)])


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("T,C", GEOM_EDGES)
def test_geom_kernel_matches_twin(engine, T, C):
    """The geometry kernel equals its twin exactly: at T = 70 on
    _geom_rows' unsorted rows (C = 1 and 50), and at the CPU model's edges
    (_geom_edge_rows: T from 1 to 4000 levels, rows off 16-byte
    boundaries, C from 1 to 3000 columns, S_e < C, the carries across
    warps and passes; odd T puts rows off 16-byte boundaries)."""
    from poreseq_tpu_torch.engine.mutscore import (GEOM, geom_cuda,
                                                   geom_reference)

    if T == 70:
        ral, n0, S_e = _geom_rows(np.random.default_rng(C), C=max(C, 8))
        S_e = np.minimum(S_e, C).astype(np.int32)
    else:
        ral, n0, S_e = _geom_edge_rows(T, C)
    t = lambda x: torch.as_tensor(x, device="cuda")
    args = (t(ral).to(engine.dtype), t(n0), t(S_e), 8, C)
    n = GEOM.launches
    got = geom_cuda(*args)
    assert GEOM.launches == n + 1
    for a, b in zip(got, geom_reference(*args)):
        assert torch.equal(a, b.to(torch.int32))


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_geom_kernel_at_the_level_cap(engine):
    """At GEOM_MAX_LEVELS (57,344 f32 / 28,672 f64 levels, 224 KB of
    staged row) the geometry kernel's staged instance equals its twin, on
    its first launch (which raises the card's shared memory limit) and its
    second; one level more and twice the cap run the instance the route
    gives them (geom_instance: the cluster instance), equal to the twin bit
    for bit too."""
    from poreseq_tpu_torch.engine.mutscore import (GEOM, GEOM_MAX_LEVELS,
                                                   geom_cuda, geom_reference)

    cap, C = GEOM_MAX_LEVELS[engine.dtype], 1024
    t = lambda x: torch.as_tensor(x, device="cuda")
    for T, reps in ((cap, 2), (cap + 1, 1), (2 * cap, 1)):
        ral, n0, S_e = _geom_rows(np.random.default_rng(3), E=6, T=T, C=C)
        args = (t(ral).to(engine.dtype), t(n0), t(np.minimum(S_e, C)), 8, C)
        ref = geom_reference(*args)
        for _ in range(reps):
            n = GEOM.launches
            got = geom_cuda(*args)
            assert GEOM.launches == n + 1
            for a, b in zip(got, ref):
                assert torch.equal(a, b.to(torch.int32))


def _geom_long_rows(T, C, E=6, seed=0):
    """Geometry operands of E reads T levels long whose reference index
    rises by 0-2 a level (one level in ten unanchored) over about C
    columns: row 0 has no anchor, row 1 one anchor (NaN flanks), row 2 an
    anchor at level 0 then a gap (the level-0 quirk), row 3 ends at T / 3
    levels; S_e up to C."""
    rng = np.random.default_rng(seed + T)
    step = rng.integers(0, 3, (E, T)) * (C / T)
    ral = np.floor(np.cumsum(step, axis=1)) + 1.0
    ral[rng.random((E, T)) < 0.1] = -1.0
    n0 = np.full(E, T, dtype=np.int32)
    ral[0] = 0.0
    ral[1] = 0.0
    ral[1, T // 2] = C // 2
    ral[2, 1:9] = 0.0
    n0[3] = T // 3
    S_e = np.minimum(ral.max(axis=1) + 1, C).clip(0).astype(np.int32)
    S_e[4] = C
    return ral, n0, S_e


# the geometry's cluster instance: rows 256 levels past the staged cap,
# twice it, and near its capacity (16 CTAs of a cap's levels); the C
# columns of each row take several passes of the cluster's threads
GEOM_CLUSTER_ROWS = {"cap + 256": lambda cap: cap + 256,
                     "2 cap": lambda cap: 2 * cap,
                     "near capacity": lambda cap: 16 * cap - 1000}


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("where", list(GEOM_CLUSTER_ROWS))
def test_geom_cluster_instance_matches_twin_and_memory_instance(engine,
                                                                where):
    """Past GEOM_MAX_LEVELS the route gives 6 events the cluster instance
    (counted under "cluster"); it equals the twin and the instance that reads the
    row from device memory bit for bit, at the route's CTAs and at the
    fewest that hold the row, one more, and 16; one level past its
    capacity the route gives the memory instance, equal to the twin."""
    from poreseq_tpu_torch.engine.mutscore import (GEOM, GEOM_MAX_LEVELS,
                                                   geom_cuda, geom_instance,
                                                   geom_reference)

    dt = engine.dtype
    cap = GEOM_MAX_LEVELS[dt]
    T = GEOM_CLUSTER_ROWS[where](cap)
    C = T // 3
    t = lambda x: torch.as_tensor(x, device="cuda")
    ral, n0, S_e = _geom_long_rows(T, C)
    args = (t(ral).to(dt), t(n0), t(S_e), 100, C)
    ref = [r.to(torch.int32) for r in geom_reference(*args)]
    name, ctas = geom_instance(T, 6, dt)
    assert name == "cluster"
    n = GEOM.instances["cluster"]
    for a, b in zip(geom_cuda(*args), ref):
        assert torch.equal(a, b)
    assert GEOM.instances["cluster"] == n + 1
    need = -(-T // cap)
    for k in sorted({need, min(need + 1, 16), 16}):
        for a, b in zip(geom_cuda(*args, instance=("cluster", k)), ref):
            assert torch.equal(a, b), k
    for a, b in zip(geom_cuda(*args, instance=("memory", 0)), ref):
        assert torch.equal(a, b)
    if where == "near capacity":
        T = 16 * cap + 1
        assert geom_instance(T, 6, dt) == ("memory", 0)
        ral, n0, S_e = _geom_long_rows(T, 2048)
        args = (t(ral).to(dt), t(n0), t(S_e), 100, 2048)
        n = GEOM.instances["memory"]
        for a, b in zip(geom_cuda(*args), geom_reference(*args)):
            assert torch.equal(a, b.to(torch.int32))
        assert GEOM.instances["memory"] == n + 1


def test_score_mutations_past_the_geometry_cap_equals_the_cpu_twin(
        monkeypatch):
    """One engine call past GEOM_MAX_LEVELS: score_mutations_multi on a
    simulated 60 kb region of 2 reads (T past 57,344 levels; f32, so the
    geometry runs on the card, on its cluster instance), its lattices
    4 C1 E W 4 bytes, a few GB.  The geometry equals the CPU twin on the
    call's own ral, and every scorer launch's totals the CPU twin's
    (groups in chunks) within phase 2's f32 tolerance, with no accept-sign
    flip."""
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine import mutscore as ms

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    pa, _ = simulate_session(np.random.default_rng(58), ref_len=60000,
                             coverage=2, draft_error=0.01)
    data = AlignData.from_session(pa)
    T = max(len(ev.mean) for ev in data.events)
    assert T > ms.GEOM_MAX_LEVELS[torch.float32]
    rng = np.random.default_rng(3)
    muts = []
    for _ in range(40):
        m = MutationInfo()
        m.start = int(rng.integers(0, len(data.sequence) - 6))
        m.orig, m.mut = data.sequence[m.start], "ACGT"[int(rng.integers(4))]
        muts.append(m)
    geoms, launches = [], []

    def geom_body(*a):
        out = ms.geom_cuda(*a)
        geoms.append(([x.cpu() if torch.is_tensor(x) else x for x in a],
                      [o.cpu() for o in out]))
        return out

    memo = {}                   # the lattices, copied once

    def cpu(x):
        if torch.is_tensor(x):
            key = (x.data_ptr(), x.shape)
            if key not in memo:
                memo[key] = x.cpu()
            return memo[key]
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, tuple):
            vals = [cpu(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    def group_totals(*a):
        out = ms.group_totals_cuda(*a)[0]
        launches.append((cpu(a), out.cpu()))
        return out

    monkeypatch.setattr(ms, "geom_body", geom_body)
    monkeypatch.setattr(ms, "group_totals", group_totals)
    n = ms.GEOM.instances["cluster"]
    engine = TorchEngine("cuda", torch.float32)
    scores = engine.score_mutations_multi([data], [muts])[0]
    assert ms.GEOM.instances["cluster"] == n + len(geoms) and geoms
    assert all(np.isfinite(m.score) for m in scores)
    for a, out in geoms:
        for got, ref in zip(out, ms.geom_reference(*a)):
            assert torch.equal(got, ref.to(torch.int32))
    assert launches
    for a, tot_k in launches:
        gp, G = a[13], a[13]["g_start"].shape[0]
        tot_r = torch.cat([ms.sum_rows_reference(ms.group_deltas_reference(
            *a[:13], {k: v[at : at + 64] for k, v in gp.items()}, *a[14:]))
            for at in range(0, G, 64)])
        torch.testing.assert_close(tot_k, tot_r, rtol=2e-4, atol=3e-3)
        valid = gp["s_valid"].bool()
        assert not bool(((((tot_k - 1e-6) > 0) != ((tot_r - 1e-6) > 0))
                         & valid).any())


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("Ws", [41, 201, 1201])
def test_windows_kernel_matches_twin(engine, Ws):
    from poreseq_tpu_torch.engine.mutscore import (WINDOWS, windows_cuda,
                                                   windows_reference)

    rng = np.random.default_rng(Ws)
    E, T, Q1 = 7, 70, 33
    t = lambda x, d=engine.dtype: torch.as_tensor(x, dtype=d, device="cuda")
    src = [t(rng.random((E, T))) for _ in range(3)]
    i0r = t(rng.integers(-Ws, T + 5, (E, Q1)), torch.int32)
    n = WINDOWS.launches
    got = windows_cuda(*src, i0r, Ws)
    assert WINDOWS.launches == n + 1
    for a, b in zip(got, windows_reference(*src, i0r, Ws)):
        assert torch.equal(a, b)


def _group_deltas_in_chunks(args):
    """group_deltas_reference over a launch's groups a chunk at a time, so
    that its [G, P, E_g, max(W, Ws)] temporaries stay near 2^22 elements
    at any width: groups are independent in the twin (it only takes maxima
    within a group), so the deltas are the whole call's bit for bit."""
    from poreseq_tpu_torch.engine.mutscore import group_deltas_reference

    gp, (W, Ws, P, E_g) = args[13], (args[15], args[16], args[19], args[21])
    G = gp["g_start"].shape[0]
    step = max(1, (1 << 22) // (P * E_g * max(W, Ws)))
    return torch.cat([group_deltas_reference(
        *args[:13], {k: v[at : at + step] for k, v in gp.items()},
        *args[14:]) for at in range(0, G, step)])


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("coverages", [(6,), (24, 22, 18)])
@pytest.mark.parametrize("scoring", [20, 100, 512, 600, 2047])
def test_group_kernel_matches_twin(engine, coverages, scoring):
    # (24, 22, 18): three regions fill the 64-row event bucket, so the last
    # region's row slice overruns it and is clamped to E - E_g; scoring 512
    # and 600 (Ws 1025 and 1201, realign 562 and 650) run two window rows a
    # thread, 2047 (Ws 4095, realign 2047) four, on regions as long as the
    # scoring width
    from poreseq_tpu_torch.engine.mutscore import (group_launches,
                                                   group_totals_cuda,
                                                   sum_rows_reference)

    datas, mlists = [], []
    for r, cov in enumerate(coverages):
        data = _data(realign=min(scoring + 50, 2047), scoring=scoring,
                     seed=r, coverage=cov, ref_len=max(240, scoring))
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
        d_r = _group_deltas_in_chunks(args)
        tot_r = sum_rows_reference(d_r)
        if engine.dtype == torch.float64:
            assert torch.equal(tot_k, tot_r)
        else:
            torch.testing.assert_close(tot_k, tot_r, rtol=2e-4, atol=3e-3)
            valid = args[13]["s_valid"].bool()
            assert not bool(((((tot_k - 1e-6) > 0) != ((tot_r - 1e-6) > 0))
                             & valid).any())
    assert (clamped > 0) == (len(coverages) > 1)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_group_kernel_wide_instance_matches_twin(engine):
    """Ws = 4097 (scoring and realign width 2048: the wide instance, in f32
    its arrays in shared memory, in f64 in a device scratch striding over
    132 blocks) on a 240 b region at 6X: point mutations at every 8th base
    and a tail insertion, every group held to the twin."""
    from poreseq_tpu_torch.engine.mutscore import (MUTSCORE, group_launches,
                                                   group_totals_cuda,
                                                   sum_rows_reference)

    data = _data(realign=2048, scoring=2048)
    tail = MutationInfo()
    tail.start, tail.orig, tail.mut = len(data.sequence), "", "ACGTACGTA"
    muts = [m for m in find_point_mutations(data) if m.start % 8 == 0]
    n, launches, nonzero = MUTSCORE.instances["wide"], 0, 0
    for gp, _, args in group_launches(engine, [data], [muts + [tail]],
                                      [True]):
        assert args[16] == 4097
        args = (*args[:13], {k: v[: gp["G"]] for k, v in args[13].items()},
                *args[14:])
        tot_k, _ = group_totals_cuda(*args, instance="wide")
        launches += 1
        tot_r = sum_rows_reference(_group_deltas_in_chunks(args))
        if engine.dtype == torch.float64:
            assert torch.equal(tot_k, tot_r)
        else:
            torch.testing.assert_close(tot_k, tot_r, rtol=2e-4, atol=3e-3)
            valid = args[13]["s_valid"].bool()
            assert not bool(((((tot_k - 1e-6) > 0) != ((tot_r - 1e-6) > 0))
                             & valid).any())
        nonzero += int((tot_r != 0).sum())
    assert launches > 0 and MUTSCORE.instances["wide"] == n + launches
    assert nonzero > 0


# the group scorer's cluster instance: Ws = 4097, 5001, 8193 and its
# largest, 16 spans + 1 (at 2048 window rows a CTA 2, 3, 4 and 16 CTAs:
# the extra row at 4097, 8193 and the largest, a partial last CTA at 5001)
GROUP_CLUSTER_WIDTHS = {"4097": 2048, "5001": 2500, "8193": 4096,
                        "largest": None}


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("which", list(GROUP_CLUSTER_WIDTHS))
def test_group_kernel_cluster_instance_matches_twin(engine, which):
    """The cluster instance, named, on a 240 b region at 6X (point
    mutations at every 8th base and a tail insertion): its deltas and
    totals equal the wide instance's bit for bit (max |diff| 0), and its
    totals the twin's (f64 exactly, f32 within tolerance and with no
    accept-sign flip); counted under "cluster"."""
    from poreseq_tpu_torch.engine.mutscore import (CLUSTER_MAX,
                                                   GROUP_CLUSTER_SPAN,
                                                   MUTSCORE, group_launches,
                                                   group_totals_cuda,
                                                   sum_rows_reference)

    scoring = (GROUP_CLUSTER_WIDTHS[which]
               or CLUSTER_MAX * GROUP_CLUSTER_SPAN // 2)
    data = _data(realign=scoring, scoring=scoring)
    tail = MutationInfo()
    tail.start, tail.orig, tail.mut = len(data.sequence), "", "ACGTACGTA"
    muts = [m for m in find_point_mutations(data) if m.start % 8 == 0]
    n, launches, nonzero = MUTSCORE.instances["cluster"], 0, 0
    for gp, _, args in group_launches(engine, [data], [muts + [tail]],
                                      [True]):
        assert args[16] == 2 * scoring + 1
        args = (*args[:13], {k: v[: gp["G"]] for k, v in args[13].items()},
                *args[14:])
        tot_c, d_c = group_totals_cuda(*args, instance="cluster")
        tot_w, d_w = group_totals_cuda(*args, instance="wide")
        launches += 1
        assert torch.equal(d_c, d_w) and torch.equal(tot_c, tot_w)
        tot_r = sum_rows_reference(_group_deltas_in_chunks(args))
        if engine.dtype == torch.float64:
            assert torch.equal(tot_c, tot_r)
        else:
            torch.testing.assert_close(tot_c, tot_r, rtol=2e-4, atol=3e-3)
            valid = args[13]["s_valid"].bool()
            assert not bool(((((tot_c - 1e-6) > 0) != ((tot_r - 1e-6) > 0))
                             & valid).any())
        nonzero += int((tot_r != 0).sum())
    assert launches > 0 and MUTSCORE.instances["cluster"] == n + launches
    assert nonzero > 0


# the genome-scale path's shapes: a 10,050 b region of a 14 kb genome whose
# four whole-genome reads overhang it by about 2 kb a side, loaded with
# trimming at widths 300/100/20 (C = 10,112 columns; each event's level axis
# is its band-reachable range); the kernels run on its first LONG_ROWS rows
LONG_REGION, LONG_ROWS = "synthref:2000:12050", 8
LONG_PARAMS = dict(realign_width=300, scoring_width=100, point_width=20,
                   min_overlap=300, min_coverage=0, max_coverage=30,
                   max_length=20000, lik_offset=4.5, verbose=0)


@pytest.fixture(scope="module")
def long_region(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from poreseq_tpu_torch.core.regions import RegionInfo
    from poreseq_tpu_torch.io import npz_h5
    from poreseq_tpu_torch.io.load import load_aligned_events
    from poreseq_tpu_torch.sim import write_run

    npz_h5.use_where_missing()
    d = str(tmp_path_factory.mktemp("long"))
    write_run(d, np.random.default_rng(12), ref_len=14000, n_reads=4,
              draft_error=0.02)
    pa = load_aligned_events(f"{d}/ref.fasta", f"{d}/reads.bam",
                             f"{d}/reads", RegionInfo(LONG_REGION),
                             dict(LONG_PARAMS), backend="exact")
    assert len(pa.events) == LONG_ROWS
    assert all(ev.trim for ev in pa.events)
    return AlignData.from_session(pa)


def _first_rows(args, n):
    """A fill launch's operands cut to its first n event rows (rows are
    independent in the fill)."""
    from poreseq_tpu_torch.engine.dp import EventBatch

    batch, states, i0, i1, pad, *rest = args
    return (EventBatch(*(x[:n] for x in batch)), states[:, :n].contiguous(),
            i0[:n].contiguous(), i1[:n].contiguous(),
            pad[:, :n].contiguous(), *rest)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("backward,steps", [(False, True), (True, False)])
def test_fill_kernel_on_trimmed_events_at_10kb(engine, long_region, backward,
                                               steps):
    """The main path's fills (forward with steps, backward without) at C =
    10,112 on trimmed events: T is the trimmed range, below the reads'
    level counts."""
    args = _first_rows(_fill_args(engine, long_region, backward, steps),
                       LONG_ROWS)
    assert args[1].shape[0] >= 10050
    assert args[0].mean.shape[1] < max(len(ev.mean)
                                       for ev in long_region.events)
    _hold_fill(engine, args)


def _long_backtrace(engine, long_region):
    """The 8 rows' forward fill and backtrace operands on the card."""
    from poreseq_tpu_torch.engine.fill import get_fill

    batch, states, i0, i1, pad, off, _, W, _ = _first_rows(
        _fill_args(engine, long_region, False), LONG_ROWS)
    r = get_fill((W - 1) // 2)(batch, states, i0, i1, pad, off, False)
    T = batch.mean.shape[1]
    return batch, (r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1, r.best_i,
                   r.best_j, T, states.shape[0] + 2 * T + 8)


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_backtrace_and_geometry_on_trimmed_events_at_10kb(engine,
                                                          long_region):
    """The backtrace walks the trimmed rows at C = 10,112 as its twin does,
    and the scoring geometry of its ref_align (the staged instance, T far
    below its cap) equals its twin."""
    from poreseq_tpu_torch.engine.align import (backtrace_cuda,
                                                backtrace_reference)
    from poreseq_tpu_torch.engine.mutscore import geom_cuda, geom_reference

    batch, args = _long_backtrace(engine, long_region)
    ral_k, rlk_k = backtrace_cuda(*args)
    ral_r, rlk_r = backtrace_reference(*args)
    assert torch.equal(ral_k, ral_r)
    assert torch.equal(rlk_k, rlk_r)
    assert int((ral_k > 0).sum(dim=1).min()) > 5000
    C = args[0].shape[0]
    S_e = torch.full((LONG_ROWS,), len(long_region.sequence) - 4,
                     dtype=torch.int32, device="cuda")
    geom_args = (ral_k, batch.n0, S_e, LONG_PARAMS["scoring_width"], C)
    for a, b in zip(geom_cuda(*geom_args), geom_reference(*geom_args)):
        assert torch.equal(a, b.to(torch.int32))


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
def test_group_kernel_on_trimmed_events_at_10kb(engine, long_region):
    """A Mutate round's scoring call (scoring width 100, every 40th point
    mutation of the 10 kb region) on trimmed events: every group of every
    launch against the twin."""
    from poreseq_tpu_torch.engine.mutscore import (group_launches,
                                                   group_totals_cuda,
                                                   sum_rows_reference)

    muts = find_point_mutations(long_region)[::40]
    n = 0
    for gp, _, args in group_launches(engine, [long_region], [muts], [True]):
        assert args[1].shape[0] > 10050
        tot_k, _ = group_totals_cuda(*args)
        tot_r = sum_rows_reference(_group_deltas_in_chunks(args))
        n += tot_k.shape[0]
        if engine.dtype == torch.float64:
            assert torch.equal(tot_k, tot_r)
        else:
            torch.testing.assert_close(tot_k, tot_r, rtol=2e-4, atol=3e-3)
            valid = args[13]["s_valid"].bool()
            assert not bool(((((tot_k - 1e-6) > 0) != ((tot_r - 1e-6) > 0))
                             & valid).any())
    assert n > 1000


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


def _mesh_regions(scoring=6, realign=16):
    """Three regions whose rows straddle the 'ev' shards of a 2-row mesh,
    each with every point mutation (regions as long as the scoring width
    past 80)."""
    datas, mlists = [], []
    for r, cov in enumerate((14, 20, 16)):
        data = _data(realign=realign, scoring=scoring, seed=r, coverage=cov,
                     ref_len=max(80, scoring))
        datas.append(data)
        mlists.append(find_point_mutations(data))
    return datas, mlists


@pytest.mark.parametrize("engine", DTYPES, indirect=True)
@pytest.mark.parametrize("realign,scoring", [(16, 6), (700, 600)])
def test_mesh_on_one_card_equals_single_device(engine, realign, scoring):
    """A 2x2 mesh of cuda:0 four times: the group scorer's totals equal the
    single-device launch's bit for bit on the same (host) band geometry,
    and every shard launched the fill, the backtrace and the scorer; also
    at W = 1401 and Ws = 1201 (two rows a thread)."""
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
        datas, mlists = _mesh_regions(scoring, realign)
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
