"""The port past 1024 band rows, past the geometry's level cap and past
8192 events a region, on the CPU: the plain twins the wide kernel instances
are held to against the JAX package at widths the kernels run two or four
rows a thread or their wide instance (the fill at realign width 600, 1023
and 2048 against dp.make_fill, the group scorer at scoring width 600 and
2048 against _group_kernel_body, a scoring width above the realign width
against TpuEngine, the geometry at 57,600 levels against _geom_body, the
observations at 8193 events against _obs_multi_fn, and TorchEngine against
TpuEngine at widths 600/600/20 in f64: ScoreEvents, and ScoreMutations
marked `slow`), and the kernel wrappers with the C library stubbed: each
width reaches its C entry with its instance's arguments (a width below 1
is refused), and a region of 8193 events reaches the observations'
chunked instance."""

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


@pytest.mark.parametrize("width,backward", [(600, False), (1023, True),
                                            (2048, False)])
def test_fill_twin_at_wide_bands_matches_make_fill_f64(x64, width,
                                                       backward):
    """W = 1201 forward, W = 2047 backward and W = 4097 (the wide instance's
    width on the card) forward, with steps: the twin's lattices within 1e-9
    of dp.make_fill's, backpointers, best coordinates and bands equal."""
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


def _group_twin_against_jax(width, ref_len):
    """The twin's totals on the real groups of a Mutate launch at widths
    (width, width, 20), point substitutions at 3 starts, against
    _group_kernel_body's within 1e-8; returns the count of nonzero
    totals."""
    from poreseq_tpu_torch.engine.mutscore import group_launches, group_totals

    pa = _session(5, (width, width, 20), ref_len=ref_len)
    data = AlignData.from_session(pa)
    muts = _point_subs(data.sequence, (ref_len // 5, ref_len // 2,
                                       ref_len - 23))
    eng = TorchEngine("cpu", torch.float64)
    n = 0
    for gp, _, args in group_launches(eng, [data], [muts], [True]):
        assert args[16] == 2 * width + 1
        sub = {k: v[: gp["G"]] for k, v in args[13].items()}
        args = args[:13] + (sub,) + args[14:]
        got = group_totals(*args).numpy()
        np.testing.assert_allclose(got, _jax_group_totals(args), rtol=0,
                                   atol=1e-8)
        n += np.count_nonzero(got)
    return n


def test_group_twin_at_scoring_width_600_matches_jax(x64):
    """Ws = 1201 (two window rows a thread on the card), point
    substitutions: the twin's totals on the launch's real groups equal
    _group_kernel_body's within 1e-8."""
    assert _group_twin_against_jax(600, 100) == 3


def test_group_twin_at_scoring_width_2048_matches_jax(x64):
    """Ws = 4097 (the wide instance on the card), point substitutions: the
    twin's totals on the launch's real groups equal _group_kernel_body's
    within 1e-8."""
    assert _group_twin_against_jax(2048, 60) == 3


def test_obs_twin_past_the_staged_events_matches_jax(x64):
    """E = 8193 events a region (the chunked instance on the card, many
    chunks), R = 2 rows:
    every event valid, and half of them; obs_multi_reference within 1e-9 of
    _obs_multi_fn (the JAX package's sort-based trim) in f64."""
    from poreseq_tpu.engine.tpu import viterbi as jv

    from poreseq_tpu_torch.engine import viterbi as tv

    rng = np.random.default_rng(8193)
    B, R, E = 1, 2, 8193
    lvl = rng.normal(60, 8, (B, R, E))
    sd = rng.uniform(0.5, 3, (B, R, E))
    valid = np.ones((B, R, E), dtype=bool)
    valid[:, 1] = rng.random(E) < 0.5
    tabs = np.empty((B, 6, E, 1024))
    tabs[:, 0] = rng.normal(60, 8, (E, 1024))
    tabs[:, 1] = rng.uniform(1, 3, (E, 1024))
    tabs[:, 2] = np.log(tabs[:, 1])
    tabs[:, 3] = rng.uniform(0.8, 2, (E, 1024))
    tabs[:, 4] = rng.uniform(1, 4, (E, 1024))
    tabs[:, 5] = np.log(tabs[:, 4])
    got = tv.obs_multi(*(torch.as_tensor(x) for x in (lvl, sd, valid,
                                                      tabs))).numpy()
    ref = np.asarray(jv._obs_multi_fn()(*(jnp.asarray(x) for x in (
        lvl, sd, valid, tabs))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    assert tv.obs_path(E)[1] == "chunked"


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
    from poreseq_tpu_torch.engine import fill, mutscore, viterbi

    lib = _Lib()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for k in _build.KERNELS:
        monkeypatch.setattr(k, "_lib", lib)
    for mod in (fill, mutscore, viterbi):
        monkeypatch.setattr(mod, "stream", lambda dev: None)
    return lib


def _fill_operands(W, dtype=torch.float32):
    from poreseq_tpu_torch.engine.dp import MODEL_FIELDS, EventBatch

    E, T, C = 2, 40, 3
    f = lambda *shape: torch.zeros(shape, dtype=dtype)
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


@pytest.mark.parametrize("W,dtype,in_shared", [
    (0, torch.float32, None), (4096, torch.float32, True),
    (4097, torch.float32, True), (8193, torch.float32, False),
    (4097, torch.float64, False)])
def test_fill_cuda_refuses_widths_past_its_instances(stub, W, dtype,
                                                     in_shared):
    """W = 0 is refused before any launch; the wide (memory) instance,
    named, takes any width past the register instances (rows a thread 0),
    its column arrays in shared memory where 9 W values fit 227 KB (f32 up
    to W = 6,449), else in a device scratch [E, 9, W] given to the C entry;
    counted under "wide"."""
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda

    n, wide = FILL.launches, FILL.instances["wide"]
    if W == 0:
        with pytest.raises(ValueError, match="at least 1"):
            fill_cuda(*_fill_operands(W, dtype), False, W, True,
                      instance="wide")
        assert stub.calls == [] and FILL.launches == n
        return
    M = fill_cuda(*_fill_operands(W, dtype), False, W, True,
                  instance="wide")[0]
    (fn, (args, _)), = stub.calls
    a = args._obj
    assert fn == f"psq_fill_{'f32' if dtype == torch.float32 else 'f64'}"
    assert (a.W, a.rpt) == (W, 0) and M.shape == (3, 2, W)
    assert (a.scratch is None) == in_shared
    assert FILL.launches == n + 1 and FILL.instances["wide"] == wide + 1


# (W, E, dtype) -> the fill's instance past the register-held scan: the
# cluster instance up to 16 CTAs of 1024 rows and up to the event rows at
# which it measured faster (engine/fill.py CLUSTER_ROWS), the wide one
# past either
FILL_ROUTES = [
    (4096, 2, torch.float32, "cluster"), (4097, 8, torch.float32, "cluster"),
    (4097, 64, torch.float32, "cluster"), (4097, 96, torch.float32, "wide"),
    (4097, 128, torch.float64, "cluster"),
    (6450, 8, torch.float32, "cluster"), (6450, 256, torch.float32, "cluster"),
    (8193, 96, torch.float32, "cluster"), (8193, 128, torch.float32, "wide"),
    (10241, 128, torch.float32, "wide"), (12289, 160, torch.float64, "wide"),
    (16384, 2, torch.float64, "cluster"), (16385, 2, torch.float32, "wide"),
    (20001, 8, torch.float64, "wide")]


@pytest.mark.parametrize("W,E,dtype,name", FILL_ROUTES)
def test_fill_cuda_reaches_its_instance_past_the_registers(stub, W, E, dtype,
                                                           name):
    """fill_instance's table past 4095 rows (the wide instance past the
    cluster's 16 CTAs), and the C entry reached with that instance's
    FillArgs.rpt (the cluster instance -1, no scratch: its column lives in
    registers), counted under its name; below the table the register
    instances keep their routes and W = 0 is refused."""
    from poreseq_tpu_torch.engine.fill import (FILL, INSTANCE_RPT,
                                               cluster_ctas, fill_cuda,
                                               fill_instance)

    assert fill_instance(W, E, dtype) == name
    assert name == "wide" or cluster_ctas(W) <= 16
    for w, rows in ((1024, "1 row"), (2048, "2 rows"), (4095, "4 rows")):
        assert fill_instance(w, E, dtype) == rows
    with pytest.raises(ValueError, match="at least 1"):
        fill_instance(0, E, dtype)
    ops = list(_fill_operands(W, dtype))
    idx = torch.arange(E) % 2
    b = ops[0]
    ops[0] = type(b)(*(x[idx] for x in b))
    ops[1:5] = [ops[1][:, idx], ops[2][idx], ops[3][idx], ops[4][:, idx]]
    n, k = FILL.launches, FILL.instances[name]
    M = fill_cuda(*ops, True, W, False)[0]
    (fn, (args, _)), = stub.calls
    a = args._obj
    assert fn == f"psq_fill_{'f32' if dtype == torch.float32 else 'f64'}"
    assert (a.W, a.E, a.rpt) == (W, E, INSTANCE_RPT[name])
    assert (a.backward, a.need_steps) == (1, 0) and M.shape == (3, E, W)
    if name == "cluster":
        assert a.scratch is None
    assert FILL.launches == n + 1 and FILL.instances[name] == k + 1


def test_fill_cluster_constants_match_the_source():
    """engine/fill.py's cluster constants are csrc/fill.cu's."""
    import re
    from pathlib import Path

    from poreseq_tpu_torch.engine import fill

    src = (Path(fill.__file__).parents[1] / "csrc" / "fill.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (-?\d+);",
                                          src)}
    assert c["CL_THREADS"] * c["CL_RPT"] == fill.CLUSTER_SPAN
    assert c["CL_MAX"] == fill.CLUSTER_MAX
    assert c["RPT_CLUSTER"] == fill.INSTANCE_RPT["cluster"]
    assert c["RPT_ROWS"] == fill.RPT_ROWS
    assert c["CL_THREADS"] in (512, 1024) and c["CL_RPT"] in (1, 2)


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


def _group_routes():
    """(Ws, pairs, dtype, instance) past the register instances, from
    GROUP_CLUSTER_PAIRS: at each measured cluster size the most pairs it
    takes and one more, and a width past its largest cluster."""
    from poreseq_tpu_torch.engine.mutscore import (GROUP_CLUSTER_PAIRS,
                                                   GROUP_CLUSTER_SPAN)

    out = []
    for dt, rows in GROUP_CLUSTER_PAIRS.items():
        for ctas, most in sorted(rows.items()):
            for Ws in (ctas * GROUP_CLUSTER_SPAN,
                       ctas * GROUP_CLUSTER_SPAN + 1):
                out += [(Ws, 2, dt, "cluster"), (Ws, most, dt, "cluster"),
                        (Ws, most + 1, dt, "wide")]
        out.append((16 * GROUP_CLUSTER_SPAN + 2, 2, dt, "wide"))
    return out


@pytest.mark.parametrize("Ws,pairs,dtype,name", _group_routes())
def test_group_instance_routes_by_the_measured_table(Ws, pairs, dtype, name):
    """group_instance past 4095 window rows: the cluster instance up to its
    16 CTAs and GROUP_CLUSTER_PAIRS pairs, else the wide one; below, the
    register instances by rows a thread; Ws = 0 is refused."""
    from poreseq_tpu_torch.engine.mutscore import group_instance

    assert group_instance(Ws, pairs, dtype) == name
    for w, rows in ((201, "1 row"), (1201, "2 rows"), (4095, "4 rows")):
        assert group_instance(w, pairs, dtype) == rows
    with pytest.raises(ValueError, match="at least 1"):
        group_instance(0, pairs, dtype)


@pytest.mark.parametrize("Ws,name", [(4096, "cluster"), (8193, "cluster"),
                                     ("16 spans", "cluster"),
                                     ("16 spans + 1", "cluster"),
                                     ("16 spans + 2", "wide")])
def test_group_scorer_reaches_the_cluster_instance(stub, Ws, name):
    """At few pairs past 4095 window rows the scorer launches the route's
    instance: the cluster one (MutArgs.rpt -1, no scratch) up to 16 CTAs
    (Ws up to 16 spans and the extra row), the wide one past; counted under
    its name."""
    from poreseq_tpu_torch.engine.fill import INSTANCE_RPT
    from poreseq_tpu_torch.engine.mutscore import (GROUP_CLUSTER_SPAN,
                                                   MUTSCORE,
                                                   group_totals_cuda)

    if isinstance(Ws, str):
        Ws = 16 * GROUP_CLUSTER_SPAN + int(Ws.split("+")[-1]
                                           if "+" in Ws else 0)
    n, k = MUTSCORE.launches, MUTSCORE.instances[name]
    totals, deltas = group_totals_cuda(*_group_operands(Ws, Ws))
    (fn, (args, _)), = stub.calls
    a = args._obj
    assert fn == "psq_mutscore_f32"
    assert (a.Ws, a.rpt, a.G, a.E_g) == (Ws, INSTANCE_RPT[name], 2, 2)
    if name == "cluster":
        assert a.scratch is None
    assert totals.shape == (2, 9) and deltas.shape == (2, 9, 2)
    assert MUTSCORE.launches == n + 1 and MUTSCORE.instances[name] == k + 1


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
    """Scoring windows past the register instances reach the wide one,
    named (rows a thread 0), counted under "wide": in f32 its arrays fit
    shared memory,
    in f64 the C entry gets a device scratch for min(G E_g, SCRATCH_BLOCKS)
    blocks, the grid's; Ws = 0 is refused before any launch."""
    from poreseq_tpu_torch.engine.mutscore import (MUTSCORE, SCRATCH_BLOCKS,
                                                   group_totals_cuda)

    n, wide = MUTSCORE.launches, MUTSCORE.instances["wide"]
    ops = _group_operands(Ws, Ws)
    totals, deltas = group_totals_cuda(*ops, instance="wide")
    to64 = lambda x: (x.double() if torch.is_tensor(x) and x.is_floating_point()
                      else x)
    batch64 = type(ops[0])(*(to64(x) for x in ops[0]))
    f64 = (batch64, *(to64(x) for x in ops[1:9]),
           tuple(to64(w) for w in ops[9]), *(to64(x) for x in ops[10:]))
    group_totals_cuda(*f64, instance="wide")
    (f1, (a1, _)), (f2, (a2, _)) = stub.calls
    a1, a2 = a1._obj, a2._obj
    assert (f1, f2) == ("psq_mutscore_f32", "psq_mutscore_f64")
    assert (a1.Ws, a1.rpt, a2.Ws, a2.rpt) == (Ws, 0, Ws, 0)
    assert a1.scratch is None and a1.scratch_blocks == 0
    assert a2.scratch and a2.scratch_blocks == min(2 * 2, SCRATCH_BLOCKS)
    assert totals.shape == (2, 9) and deltas.shape == (2, 9, 2)
    assert MUTSCORE.launches == n + 2 and MUTSCORE.instances["wide"] == \
        wide + 2
    with pytest.raises(ValueError, match="at least 1"):
        group_totals_cuda(*_group_operands(Ws, 0))
    assert MUTSCORE.launches == n + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_geom_cuda_takes_the_scratch_instance_past_the_cap(stub, dtype):
    """At GEOM_MAX_LEVELS the staged instance (no scratch, no cluster);
    past the cluster instance's capacity (GEOM_CLUSTER_MAX slices of that
    many levels), and named ("memory") at 256 levels past the cap, the C
    entry gets a scratch row [E, T] of the row's dtype; each counted under
    its name."""
    import ctypes

    from poreseq_tpu_torch.engine.mutscore import (GEOM, GEOM_CLUSTER_MAX,
                                                   GEOM_MAX_LEVELS, geom_cuda)

    E, C = 2, 5
    n0 = torch.full((E,), 9, dtype=torch.int32)
    S_e = torch.full((E,), C, dtype=torch.int32)
    cap = GEOM_MAX_LEVELS[dtype]
    n, staged, mem = (GEOM.launches, GEOM.instances["staged"],
                      GEOM.instances["memory"])
    big = GEOM_CLUSTER_MAX * cap + 1
    for T, inst in ((cap, None), (cap + 256, ("memory", 0)), (big, None)):
        i0, i1 = geom_cuda(torch.zeros((E, T), dtype=dtype), n0, S_e, 8, C,
                           instance=inst)
        assert i0.shape == i1.shape == (E, C + 1)
    suffix = "f32" if dtype == torch.float32 else "f64"
    (f1, a1), (f2, a2), (f3, a3) = stub.calls
    assert f1 == f2 == f3 == f"psq_geom_{suffix}"
    assert GEOM.launches == n + 3
    assert a1[5] is None and a1[7] == cap and a1[10] == 0
    for a, T in ((a2, cap + 256), (a3, big)):
        assert isinstance(a[5], ctypes.c_void_p) and a[5].value
        assert a[6:11] == (E, T, C, 8, 0)
    assert GEOM.instances["staged"] == staged + 1
    assert GEOM.instances["memory"] == mem + 2


# rows past the staged cap, as multiples of it -> the cluster instance's
# CTAs: the fewest that hold the row, or GEOM_CLUSTER_CTAS where more
GEOM_CLUSTER_ROUTES = [1.0001, 1.5, 2, 3.9, 8, 15.5, 16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mult", GEOM_CLUSTER_ROUTES)
def test_geom_cuda_reaches_the_cluster_instance_past_the_cap(stub, dtype,
                                                              mult):
    """geom_instance's table past GEOM_MAX_LEVELS up to GEOM_CLUSTER_MAX
    slices: up to GEOM_CLUSTER_ROWS events the cluster instance on max(the
    CTAs holding the row, GEOM_CLUSTER_CTAS) CTAs, no scratch (the C entry
    gets that count and the launch is counted under "cluster"), one event
    more the memory instance; one level past the capacity the memory
    instance, at the cap the staged one."""
    from poreseq_tpu_torch.engine.fill import measured_at
    from poreseq_tpu_torch.engine.mutscore import (GEOM, GEOM_CLUSTER_CTAS,
                                                   GEOM_CLUSTER_MAX,
                                                   GEOM_CLUSTER_ROWS,
                                                   GEOM_MAX_LEVELS, geom_cuda,
                                                   geom_instance)

    cap = GEOM_MAX_LEVELS[dtype]
    T = int(mult * cap)
    need = -(-T // cap)
    ctas = max(need, min(GEOM_CLUSTER_CTAS[dtype], GEOM_CLUSTER_MAX))
    most = measured_at(GEOM_CLUSTER_ROWS[dtype], need)
    assert 2 <= need <= ctas <= GEOM_CLUSTER_MAX and most >= 2
    assert geom_instance(T, most, dtype) == ("cluster", ctas)
    assert geom_instance(T, most + 1, dtype) == ("memory", 0)
    assert geom_instance(cap, 2, dtype) == ("staged", 0)
    assert geom_instance(GEOM_CLUSTER_MAX * cap + 1, 2, dtype) == \
        ("memory", 0)
    E, C = 2, 5
    n, k = GEOM.launches, GEOM.instances["cluster"]
    i0, i1 = geom_cuda(torch.zeros((E, T), dtype=dtype),
                       torch.full((E,), 9, dtype=torch.int32),
                       torch.full((E,), C, dtype=torch.int32), 8, C)
    assert i0.shape == i1.shape == (E, C + 1)
    (fn, a), = stub.calls
    assert a[5] is None and a[6:11] == (E, T, C, 8, ctas)
    assert GEOM.launches == n + 1 and GEOM.instances["cluster"] == k + 1


def test_cluster_constants_match_the_sources():
    """engine/mutscore.py's cluster constants are csrc/mutscore.cu's and
    csrc/geom.cu's: the scorer's span, largest cluster and rpt code, the
    geometry's largest cluster and its staged cap (ROW_BYTES of a dtype)."""
    import re
    from pathlib import Path

    from poreseq_tpu_torch.engine import fill, mutscore

    csrc = Path(mutscore.__file__).parents[1] / "csrc"
    const = lambda name: {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (-?\d+);", (csrc / name).read_text())}
    m, g = const("mutscore.cu"), const("geom.cu")
    assert m["GCL_THREADS"] * m["GCL_RPT"] == mutscore.GROUP_CLUSTER_SPAN
    assert m["GCL_MAX"] == fill.CLUSTER_MAX
    assert m["RPT_CLUSTER"] == fill.INSTANCE_RPT["cluster"]
    assert m["RPT_ROWS"] == fill.RPT_ROWS
    span = mutscore.GROUP_CLUSTER_SPAN
    assert span & (span - 1) == 0 and m["GCL_RPT"] in (1, 2, 4)
    for Ws, n in ((4096, 4096 // span), (4097, 4096 // span),
                  (4098, 4096 // span + 1), (2, 1)):
        assert mutscore.group_cluster_ctas(Ws) == max(n, 1)
    assert 32 <= m["GCL_THREADS"] <= 1024 and m["GCL_THREADS"] % 32 == 0
    assert g["GEOM_CL_MAX"] == mutscore.GEOM_CLUSTER_MAX
    for dt, size in ((torch.float32, 4), (torch.float64, 8)):
        assert g["ROW_BYTES"] // size == mutscore.GEOM_MAX_LEVELS[dt]
        assert set(mutscore.GROUP_CLUSTER_PAIRS[dt]) <= set(
            range(2, fill.CLUSTER_MAX + 1))
        assert set(mutscore.GEOM_CLUSTER_ROWS[dt]) <= set(
            range(2, mutscore.GEOM_CLUSTER_MAX + 1))


def test_viterbi_obs_cap_ends_in_engine_error(stub, monkeypatch):
    """A region of 8193 events (past the 8192 the port once refused) does
    not end in EngineError: the engine's observation call (sweep_inputs,
    the route stubbed to the kernel's, the operands of the region's shape)
    reaches the C entry with E = 8193 and the chunked instance, counted
    under its name."""
    from poreseq_tpu_torch.engine import viterbi as vit

    def obs_inputs(events_lists, device, dtype):
        E = len(events_lists[0])
        z = torch.zeros((1, 64, E), dtype=dtype)
        tabs = torch.empty((1, 6, E, 1024), dtype=dtype)   # never touched
        return [0], (z, z, z.bool(), tabs), torch.tensor([60])

    monkeypatch.setattr(vit, "obs_inputs", obs_inputs)
    monkeypatch.setattr(vit, "route", lambda *t: "cuda")
    n, chunked = vit.VITERBI_OBS.launches, \
        vit.VITERBI_OBS.instances["chunked"]
    act, obs, _ = vit.sweep_inputs([[None] * 8193], "cpu", torch.float32)
    (fn, a), = stub.calls
    assert fn == "psq_viterbi_obs_f32" and a[5:9] == (1, 64, 8193, 2)
    assert act == [0] and obs.shape == (1, 64, 1024)
    assert vit.VITERBI_OBS.launches == n + 1
    assert vit.VITERBI_OBS.instances["chunked"] == chunked + 1
