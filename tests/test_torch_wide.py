"""The port past 1024 band rows and past the geometry's level cap, on the
CPU: the plain twins the wide kernel instances are held to against the JAX
package at widths the kernels run two or four rows a thread (the fill at
realign width 600 and 1023 against dp.make_fill, the group scorer at
scoring width 600 against _group_kernel_body, a scoring width above the
realign width against TpuEngine, the geometry at 57,600 levels against
_geom_body, and TorchEngine against TpuEngine at widths 600/600/20 in f64:
ScoreEvents, and ScoreMutations marked `slow`), and the kernel wrappers with the
C library stubbed: each width reaches its C entry with its instance's
arguments, and past the limits the wrappers raise; the observation
kernel's event cap ends a Viterbi call in EngineError."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.engine.tpu import dp as jdp
from poreseq_tpu.engine.tpu import mutscore as jm
from poreseq_tpu.engine.tpu import pack as jp
from poreseq_tpu.engine.tpu.dp import EventBatch as JaxEventBatch
from poreseq_tpu.engine.types import AlignData as JaxAlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine.types import AlignData

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _session(seed, widths, ref_len=150, coverage=3, draft_error=0.03):
    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                             coverage=coverage, draft_error=draft_error)
    pa.params.update(dict(zip(("realign_width", "scoring_width",
                               "point_width"), widths)))
    return pa


def _wide_engines():
    from poreseq_tpu.engine.tpu import TpuEngine

    return (("torch", TorchEngine("cpu", torch.float64),
             AlignData.from_session),
            ("jax", TpuEngine(dtype=jnp.float64), JaxAlignData.from_session))


def test_engine_at_wide_bands_scores_events_as_jax_f64(x64):
    """Widths 600/600/20 (W = 1201, two rows a thread on the card):
    ScoreEvents within 1e-9 and ref_align identical, TorchEngine(cpu, f64)
    against TpuEngine(f64)."""
    pa = _session(5, (600, 600, 20))
    out = {}
    for name, eng, make in _wide_engines():
        data = make(pa)
        scores = eng.score_alignments_multi([data])[0]
        out[name] = (scores, [ev.ref_align for ev in data.events])
    (sP, raP), (sJ, raJ) = out["torch"], out["jax"]
    np.testing.assert_allclose(sP, sJ, rtol=0, atol=1e-9)
    for a, b in zip(raP, raJ):
        np.testing.assert_array_equal(a, b)
    assert len(raP) == 3


@pytest.mark.slow
def test_engine_at_wide_bands_scores_mutations_as_jax_f64(x64):
    """Widths 600/600/20 (Ws = 1201): ScoreMutations' deltas within 1e-8
    of TpuEngine(f64)'s on indels, substitutions and tail mutations (slow:
    the JAX group scorer alone takes about 80 CPU seconds at Ws = 1201 on
    the CPU, whatever the region's size; test_group_twin_at_scoring_width_
    600_matches_jax holds the twin to it on the real groups only)."""
    from test_torch_mutscore import _rand_muts

    pa = _session(5, (600, 600, 20))
    muts = _rand_muts(np.random.default_rng(6), pa.sequence, 6)
    out = {name: [m.score for m in eng.score_mutations_multi(
        [make(pa)], [muts])[0]] for name, eng, make in _wide_engines()}
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-8)
    assert np.count_nonzero(out["torch"]) > 3


@pytest.mark.parametrize("width,backward", [(600, False), (1023, True)])
def test_fill_twin_at_wide_bands_matches_make_fill_f64(x64, width,
                                                       backward):
    """W = 1201 forward and W = 2047 backward, with steps: the twin's
    lattices within 1e-9 of dp.make_fill's, backpointers, best coordinates
    and bands equal."""
    from test_torch_fill import _inputs, _jax_fill, _port_fill

    arrays, states2, fi = _inputs(60, 2, width, seed=4)
    jbatch = jp.to_device_batch(arrays, jnp.float64)
    ref = _jax_fill(jdp.make_fill(width, jnp.float64, True), jbatch,
                    states2, fi, width, backward)
    got = _port_fill(jbatch, states2, fi, width, torch.float64, backward,
                     True)
    for name in ("M", "S", "best", "best_pfx"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    for name in ("steps_m", "steps_s", "best_i", "best_j", "i0", "i1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert float(got.best.max()) > 0


def _point_subs(seq, starts):
    from poreseq_tpu_torch.core.regions import MutationInfo

    out = []
    for st in starts:
        m = MutationInfo()
        m.start, m.orig = st, seq[st]
        m.mut = "A" if seq[st] != "A" else "C"
        out.append(m)
    return out


def _jax_group_totals(args):
    """mutscore._group_kernel_body on the port's group_launches arguments
    (the same arrays, as JAX arrays)."""
    (batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb, evr, gpd,
     off, W, Ws, RS, K, P, DM, E_g) = args
    from poreseq_tpu_torch.engine.mutscore import GROUP_FIELDS

    j = lambda x: jnp.asarray(x.numpy())
    jbatch = JaxEventBatch(*(j(getattr(batch, f))
                             for f in JaxEventBatch._fields))
    kern = jax.jit(jm._group_kernel_body(W, Ws, RS, K, P, DM, jnp.float64))
    return np.asarray(kern(jbatch, j(Mf), j(Sf), j(Mb), j(Sb), j(i0f),
                           j(i1f), j(i0r), j(i1r), *(j(w) for w in win),
                           j(bpf), j(bpb), j(evr),
                           *(j(gpd[k]) for k in GROUP_FIELDS), off))


def test_group_twin_at_scoring_width_600_matches_jax(x64):
    """Ws = 1201 (two window rows a thread on the card), point
    substitutions: the twin's totals on the launch's real groups equal
    _group_kernel_body's within 1e-8."""
    from poreseq_tpu_torch.engine.mutscore import group_launches, group_totals

    pa = _session(5, (600, 600, 20), ref_len=100)
    data = AlignData.from_session(pa)
    muts = _point_subs(data.sequence, (20, 50, 77))
    eng = TorchEngine("cpu", torch.float64)
    n = 0
    for gp, _, args in group_launches(eng, [data], [muts], [True]):
        assert args[16] == 1201
        sub = {k: v[: gp["G"]] for k, v in args[13].items()}
        args = args[:13] + (sub,) + args[14:]
        got = group_totals(*args).numpy()
        np.testing.assert_allclose(got, _jax_group_totals(args), rtol=0,
                                   atol=1e-8)
        n += np.count_nonzero(got)
    assert n == 3


def test_scoring_width_above_realign_width_matches_jax(x64, monkeypatch):
    """scoring_width 12 > realign_width 8: group_launches' clamp of the
    scoring bands to Ws = 17 rows (engine/mutscore.py) cuts bands the
    geometry placed 25 rows wide, and ScoreMutations still equals
    TpuEngine(f64) within 1e-8."""
    from poreseq_tpu.engine.tpu import TpuEngine

    from poreseq_tpu_torch.engine import mutscore as mutscore_mod

    seen = []
    real = mutscore_mod.limited_geometry

    def spy(*a, **kw):
        i0, i1 = real(*a, **kw)
        seen.append(int((i1 - i0).max()))
        return i0, i1

    monkeypatch.setattr(mutscore_mod, "limited_geometry", spy)
    pa = _session(9, (8, 12, 6), ref_len=120, coverage=4)
    muts = _point_subs(pa.sequence, range(5, 115, 9))
    port = TorchEngine("cpu", torch.float64).score_mutations_multi(
        [AlignData.from_session(pa)], [muts])[0]
    jaxs = TpuEngine(dtype=jnp.float64).score_mutations_multi(
        [JaxAlignData.from_session(pa)], [muts])[0]
    assert seen and max(seen) > 16          # the clamp cut a band
    np.testing.assert_allclose([m.score for m in port],
                               [m.score for m in jaxs], rtol=0, atol=1e-8)


def test_geom_twin_past_the_level_cap_matches_jax():
    """57,600 levels (past the f32 staged instance's 57,344): the twin
    equals _geom_body on _geom_rows' unsorted rows, f32."""
    from poreseq_tpu_torch.engine.mutscore import geom_reference

    from test_torch_kernels_cuda import _geom_rows

    T, C = 57600, 256
    ral, n0, S_e = _geom_rows(np.random.default_rng(4), E=6, T=T, C=C)
    S_e = np.minimum(S_e, C).astype(np.int32)
    ral = ral.astype(np.float32)
    got = geom_reference(torch.as_tensor(ral), torch.as_tensor(n0),
                         torch.as_tensor(S_e), 8, C)
    ref = jm._geom_body(jnp.asarray(ral), jnp.asarray(n0),
                        jnp.asarray(S_e), 8, C)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# --- the wrappers with the C library stubbed: what reaches the C entry ----


class _Lib:
    """Stand-in for a kernel library: records each C entry's arguments and
    returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        return lambda *a: self.calls.append((fn, a)) or 0


@pytest.fixture
def stub(monkeypatch):
    """Every Kernel's library stubbed, no device guard and a null stream, so
    a wrapper runs on CPU operands up to its C entry."""
    import contextlib

    from poreseq_tpu_torch import _build
    from poreseq_tpu_torch.engine import fill, mutscore

    lib = _Lib()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for k in _build.KERNELS:
        monkeypatch.setattr(k, "_lib", lib)
    for mod in (fill, mutscore):
        monkeypatch.setattr(mod, "stream", lambda dev: None)
    return lib


def _fill_operands(W):
    from poreseq_tpu_torch.engine.dp import MODEL_FIELDS, EventBatch

    E, T, C = 2, 40, 3
    f = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    batch = EventBatch(**{n: f(E, T) for n in ("mean", "stdv", "lsr",
                                                "lsd")},
                       **{n: f(E, 1024) for n in MODEL_FIELDS},
                       **{n: f(E) for n in ("lik_skip", "lik_stay",
                                            "lik_extend", "lik_insert")},
                       n0=torch.full((E,), T, dtype=torch.int32),
                       active=torch.ones(E, dtype=torch.bool))
    i = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    return (batch, i(C, E), i(E, C + 1), i(E, C + 1),
            torch.zeros((C, E), dtype=torch.bool), 4.5)


@pytest.mark.parametrize("W,rpt", [(1024, 1), (1401, 2), (2048, 2),
                                   (4095, 4)])
@pytest.mark.parametrize("backward", [False, True])
def test_fill_cuda_reaches_its_instance(stub, W, rpt, backward):
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda

    n = FILL.launches
    M = fill_cuda(*_fill_operands(W), backward, W, True)[0]
    (fn, (args, _)), = stub.calls
    a = args._obj
    assert fn == "psq_fill_f32" and FILL.launches == n + 1
    assert (a.W, a.rpt, a.backward, a.need_steps) == (W, rpt, backward, 1)
    assert M.shape == (3, 2, W)


@pytest.mark.parametrize("W", [0, 4096, 4097])
def test_fill_cuda_refuses_widths_past_its_instances(stub, W):
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda

    n = FILL.launches
    with pytest.raises(ValueError, match="4095"):
        fill_cuda(*_fill_operands(W), False, W, True)
    assert stub.calls == [] and FILL.launches == n


def _group_operands(W, Ws):
    from poreseq_tpu_torch.engine.mutscore import GROUP_FIELDS

    C1, E, Q1, G, P, K = 3, 2, 3, 2, 9, 7
    batch = _fill_operands(W)[0]
    f = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    i = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    shapes = dict(g_start=(G,), g_startind=(G,), g_S=(G,), g_region=(G,),
                  g_evoff=(G,), s_mlen=(G, P), s_nst=(G, P),
                  s_win=(G, P, K), s_valid=(G, P))
    gp = {k: (torch.zeros(shapes[k], dtype=torch.bool) if k == "s_valid"
              else i(*shapes[k])) for k in GROUP_FIELDS}
    return (batch, f(C1, E, W), f(C1, E, W), f(C1, E, W), f(C1, E, W),
            i(E, C1), i(E, C1), i(E, C1), i(E, C1),
            tuple(f(Q1, E, Ws) for _ in range(3)), f(C1, E), f(C1, E),
            i(E), gp, 4.5, W, Ws, max((W - Ws) // 2, 0), K, P, 1, E)


@pytest.mark.parametrize("Ws,rpt", [(201, 1), (1201, 2), (4095, 4)])
def test_group_scorer_reaches_its_instance(stub, Ws, rpt):
    from poreseq_tpu_torch.engine.mutscore import (MUTSCORE,
                                                   group_totals_cuda)

    n = MUTSCORE.launches
    totals, deltas = group_totals_cuda(*_group_operands(Ws, Ws))
    (fn, (args, _)), = stub.calls
    a = args._obj
    assert fn == "psq_mutscore_f32" and MUTSCORE.launches == n + 1
    assert (a.W, a.Ws, a.rpt, a.G, a.P) == (Ws, Ws, rpt, 2, 9)
    assert totals.shape == (2, 9) and deltas.shape == (2, 9, 2)


@pytest.mark.parametrize("Ws", [4096, 4097])
def test_group_scorer_refuses_widths_past_its_instances(stub, Ws):
    from poreseq_tpu_torch.engine.mutscore import (MUTSCORE,
                                                   group_totals_cuda)

    n = MUTSCORE.launches
    with pytest.raises(ValueError, match="4095"):
        group_totals_cuda(*_group_operands(Ws, Ws))
    assert stub.calls == [] and MUTSCORE.launches == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_geom_cuda_takes_the_scratch_instance_past_the_cap(stub, dtype):
    """At GEOM_MAX_LEVELS the staged instance (no scratch); at 256 levels
    past it the C entry gets a scratch row [E, T] of the row's dtype."""
    import ctypes

    from poreseq_tpu_torch.engine.mutscore import (GEOM, GEOM_MAX_LEVELS,
                                                   geom_cuda)

    E, C = 2, 5
    n0 = torch.full((E,), 9, dtype=torch.int32)
    S_e = torch.full((E,), C, dtype=torch.int32)
    cap = GEOM_MAX_LEVELS[dtype]
    n = GEOM.launches
    for T in (cap, cap + 256):
        i0, i1 = geom_cuda(torch.zeros((E, T), dtype=dtype), n0, S_e, 8, C)
        assert i0.shape == i1.shape == (E, C + 1)
    suffix = "f32" if dtype == torch.float32 else "f64"
    (f1, a1), (f2, a2) = stub.calls
    assert f1 == f2 == f"psq_geom_{suffix}" and GEOM.launches == n + 2
    assert a1[5] is None and a1[7] == cap
    assert isinstance(a2[5], ctypes.c_void_p) and a2[5].value
    assert a2[6:10] == (E, cap + 256, C, 8)


def test_viterbi_obs_cap_ends_in_engine_error(monkeypatch):
    """A region of 8193 events (max_coverage past the observation kernel's
    8192) ends in EngineError naming the limit and max_coverage, before any
    launch (the route stubbed to the kernel's, the operands stand-ins of
    the region's shape)."""
    from poreseq_tpu_torch.engine import EngineError
    from poreseq_tpu_torch.engine import viterbi as vit

    def obs_inputs(events_lists, device, dtype):
        E = len(events_lists[0])
        z = torch.zeros((1, 64, E), dtype=dtype)
        return [0], (z, z, z.bool(), None), torch.tensor([60])

    monkeypatch.setattr(vit, "obs_inputs", obs_inputs)
    monkeypatch.setattr(vit, "route", lambda *t: "cuda")
    n = vit.VITERBI_OBS.launches
    with pytest.raises(EngineError, match="at most 8192 events.*8193.*"
                                          "max_coverage"):
        TorchEngine("cpu", torch.float32).viterbi_mutate_multi(
            [[None] * 8193], 16, 0.05, 0.01, 0.33, 0.75)
    assert vit.VITERBI_OBS.launches == n
