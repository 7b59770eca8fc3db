"""The port's mutation scoring against the JAX package: the group-scorer
twin against mutscore._group_kernel_body on identical inputs, geom_body
against _geom_body and the host geometry, ScoreMutations in f64 against
TpuEngine(float64) and the exact engine, and f32 accept-sign agreement."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.core.events import update_refs
from poreseq_tpu.core.regions import MutationInfo
from poreseq_tpu.engine.exact import ExactEngine
from poreseq_tpu.engine.tpu import mutscore as jm
from poreseq_tpu.engine.tpu.dp import EventBatch as JaxEventBatch
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine.align import fwd_dev
from poreseq_tpu_torch.engine.mutscore import (GROUP_FIELDS, geom_body,
                                               group_launches, group_totals)
from poreseq_tpu_torch.engine.pack import fill_geometry, limited_geometry
from test_torch_kernels_cuda import _geom_rows

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _session(seed, ref_len=160, coverage=4, realign=20, scoring=10):
    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                             coverage=coverage, draft_error=0.04)
    pa.params.update(realign_width=realign, scoring_width=scoring)
    return pa


def _rand_muts(rng, seq, n):
    muts = []
    for _ in range(n):
        start = int(rng.integers(0, len(seq) - 6))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            o, mu = seq[start], "ACGT"[int(rng.integers(0, 4))]
        elif kind == 1:
            o, mu = "", "ACGT"[int(rng.integers(0, 4))]
        else:
            o, mu = seq[start : start + int(rng.integers(1, 4))], ""
        muts.append((start, o, mu))
    # tail mutations exercise the k_star < 0 copied-column join, a long
    # insertion the K=16 class, past-the-end starts the invalid slots
    muts += [(len(seq) - 1, seq[-1], ""), (len(seq) - 1, seq[-1], "A"),
             (len(seq), "", "C"), (len(seq) + 3, "", "G"),
             (40, "", "ACGTACGTAC")]
    out = []
    for start, o, mu in muts:
        mi = MutationInfo()
        mi.start, mi.orig, mi.mut = start, o, mu
        out.append(mi)
    return out


def test_group_twin_matches_jax_group_kernel(x64):
    """Both regions' classes, on the inputs the port builds: the twin's
    totals equal the JAX kernel's (unsliced: E_g=None) within 1e-9."""
    rng = np.random.default_rng(5)
    pas = [_session(21), _session(22, ref_len=120, coverage=3)]
    datas = [AlignData.from_session(pa) for pa in pas]
    muts_list = [_rand_muts(rng, d.sequence, 14) for d in datas]
    eng = TorchEngine("cpu", torch.float64)
    n_classes = n_scored = 0
    for gp, _, args in group_launches(eng, datas, muts_list, [True, True]):
        (batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb, evr, gpd,
         off, W, Ws, RS, K, P, DM, E_g) = args
        got = group_totals(*args).numpy()
        j = lambda x: jnp.asarray(x.numpy())
        jbatch = JaxEventBatch(*(j(getattr(batch, f))
                                 for f in JaxEventBatch._fields))
        kern = jax.jit(jm._group_kernel_body(W, Ws, RS, K, P, DM,
                                             jnp.float64))
        ref = np.asarray(kern(jbatch, j(Mf), j(Sf), j(Mb), j(Sb), j(i0f),
                              j(i1f), j(i0r), j(i1r), *(j(w) for w in win),
                              j(bpf), j(bpb), j(evr),
                              *(j(gpd[k]) for k in GROUP_FIELDS), off))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
        n_scored += np.count_nonzero(ref)
        n_classes += 1
    assert n_classes >= 2 and n_scored > 20


def test_geom_body_matches_jax_and_host(x64):
    pa = _session(3, ref_len=150, coverage=5, realign=16, scoring=8)
    data = AlignData.from_session(pa)
    eng = TorchEngine("cpu", torch.float64)
    ctx = eng._prepare_multi([data])
    fi = fill_geometry(ctx["arrays"], ctx["ref_indexes"], ctx["S_e"],
                       ctx["C"], 16)
    T = ctx["arrays"]["mean"].shape[1]
    t = torch.as_tensor
    _, ral, _, _ = fwd_dev(ctx["batch"], t(ctx["states2"]), t(fi["i0"]),
                           t(fi["i1"]), t(fi["is_pad"]), 4.5, 16, T,
                           ctx["C"] + 2 * T + 8, ctx["C"])
    n0, S_e, C = ctx["n0"], ctx["S_e"], ctx["C"]
    got = geom_body(ral, ctx["batch"].n0, t(S_e), 8, C)
    ref = jm._geom_body(jnp.asarray(ral.numpy()), jnp.asarray(n0),
                        jnp.asarray(S_e, jnp.int32), 8, C)
    ral_h = ral.numpy()
    ris = [update_refs(ral_h[e, : n0[e]])[0] if ctx["arrays"]["active"][e]
           else np.zeros(0) for e in range(len(n0))]
    host = limited_geometry(ris, n0, S_e, C, 8)
    for g, r, h in zip(got, ref, host):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), h)


def test_score_mutations_f64_matches_jax_and_exact(x64):
    from poreseq_tpu.engine.tpu import TpuEngine

    rng = np.random.default_rng(1)
    pas = [_session(11, ref_len=200), _session(12, ref_len=140, coverage=3)]
    muts_list = [_rand_muts(rng, pa.sequence, 20) for pa in pas]
    port = TorchEngine("cpu", torch.float64).score_mutations_multi(
        [AlignData.from_session(pa) for pa in pas], muts_list)
    jaxs = TpuEngine(dtype=jnp.float64).score_mutations_multi(
        [AlignData.from_session(pa) for pa in pas], muts_list)
    for r, pa in enumerate(pas):
        sP = np.array([m.score for m in port[r]])
        sJ = np.array([m.score for m in jaxs[r]])
        sE = np.array([m.score for m in ExactEngine().score_mutations(
            AlignData.from_session(pa), muts_list[r])])
        np.testing.assert_allclose(sP, sJ, rtol=0, atol=1e-8)
        np.testing.assert_allclose(sP, sE, rtol=0, atol=1e-8)


def test_score_mutations_f32_sign_agreement():
    rng = np.random.default_rng(2)
    pa = _session(13, ref_len=300, coverage=6, realign=24, scoring=12)
    muts = _rand_muts(rng, pa.sequence, 40)
    sE = np.array([m.score for m in ExactEngine().score_mutations(
        AlignData.from_session(pa), muts)])
    sP = np.array([m.score for m in TorchEngine(
        "cpu", torch.float32).score_mutations(AlignData.from_session(pa),
                                              muts)])
    assert np.max(np.abs(sE - sP)) < 0.01
    assert np.all((sE > 0) == (sP > 0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_geom_body_equals_jax_on_unsorted_rows(x64, dtype, seed):
    """The device geometry's bisection is JAX's on every row, the unsorted
    ones too: a single anchored level (NaN flanks), the level-0 quirk, no
    anchor, anchors past n0 and inactive rows give identical i0/i1."""
    ral, n0, S_e = _geom_rows(np.random.default_rng(seed))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    got = geom_body(torch.as_tensor(ral, dtype=dtype), torch.as_tensor(n0),
                    torch.as_tensor(S_e), 8, 50)
    ref = jm._geom_body(jnp.asarray(ral, jdt), jnp.asarray(n0),
                        jnp.asarray(S_e), 8, 50)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _monotone_rows(rng, E, T, C):
    """ral [E, T] as a backtrace leaves it: anchors (ral > 0) monotone,
    level 0 and the last levels unanchored, inserts (-1) between."""
    ral = np.zeros((E, T))
    n0 = rng.integers(T // 2, T + 1, E).astype(np.int32)
    for e in range(E):
        ref = int(rng.integers(1, 8))
        for t in range(int(rng.integers(1, 5)), int(n0[e]) - 2):
            u = rng.random()
            if u < 0.55:
                ref += int(rng.integers(0, 3))
                ral[e, t] = min(ref, C)
            elif u < 0.65:
                ral[e, t] = -1.0
    return ral, n0


def test_geom_body_f32_moves_rows_by_one_against_host():
    """f32 device geometry against the host's f64 limited_geometry on
    random monotone rows: f32 interpolation can move a band edge across a
    reference index, so an entry of i0/i1 may differ, by one row only.
    The count of moved entries is printed (ROADMAP §C)."""
    rng = np.random.default_rng(7)
    E, T, C, width = 64, 160, 120, 8
    moved = total = 0
    for _ in range(6):
        ral, n0 = _monotone_rows(rng, E, T, C)
        S_e = rng.integers(C // 2, C + 1, E).astype(np.int32)
        got = geom_body(torch.as_tensor(ral, dtype=torch.float32),
                        torch.as_tensor(n0), torch.as_tensor(S_e), width, C)
        ris = [update_refs(ral[e, : n0[e]])[0] for e in range(E)]
        host = limited_geometry(ris, n0, S_e, C, width)
        for g, h in zip(got, host):
            d = np.abs(g.numpy().astype(np.int64) - h)
            assert d.max() <= 1
            moved += int(np.count_nonzero(d))
            total += d.size
    print(f"f32 device geometry vs host f64: {moved} of {total} i0/i1 "
          "entries moved by one row")
