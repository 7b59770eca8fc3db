"""The port's mutation scoring against the JAX package: the group-scorer
twin against mutscore._group_kernel_body on identical inputs, geom_body
against _geom_body and the host geometry, ScoreMutations in f64 against
TpuEngine(float64) and the exact engine, and f32 accept-sign agreement."""

import re
from pathlib import Path

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
from poreseq_tpu_torch.engine import mutscore as mutscore_mod
from poreseq_tpu_torch.engine.align import fwd_dev
from poreseq_tpu_torch.engine.mutscore import (GROUP_FIELDS, geom_body,
                                               geom_reference, group_launches,
                                               group_totals)
from poreseq_tpu_torch.engine.pack import fill_geometry, limited_geometry
from test_torch_kernels_cuda import _geom_edge_rows, _geom_rows

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


def _geom_consts():
    """The geometry kernel's block size GNT and columns a thread CPT
    (csrc/geom.cu's `constexpr int NAME = n;`)."""
    text = (Path(mutscore_mod.__file__).resolve().parents[1] / "csrc"
            / "geom.cu").read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in ("GNT", "CPT")]


def _geom_kernel_model(ral, n0, S_e, width, C, fdt):
    """NumPy model of csrc/geom.cu's geom_kernel, one block an event, its
    threads in lockstep: the ral row staged (16-byte copies of the aligned
    body of a row at byte e T sizeof(T), plain loads at its ends; each
    level once), each thread's run of ceil(T / GNT) levels and its first
    and last anchors, the four block scans (in-warp shuffle steps, then the
    warp totals), ri written over ral in place (asserting that every value
    read from another level is an anchor's, never rewritten, and that a
    look-ahead reads only levels not yet rewritten), then passes of GNT CPT
    columns, CPT bisections a thread advancing together, the rate limit's
    prefix minimum by a block scan with the earlier passes' carry, and
    columns past S_e stored unsearched.  Returns i0, i1 [E, C + 1]."""
    NT, CPT = _geom_consts()
    NW, IMAX, DMAX = NT // 32, np.iinfo(np.int64).max, 8
    E, T = ral.shape
    isz = np.dtype(fdt).itemsize
    i0 = np.full((E, C + 1), -7, np.int64)
    i1 = np.full((E, C + 1), -7, np.int64)
    for e in range(E):
        head = min(T, ((16 - (e * T * isz) % 16) % 16) // isz)
        tail = head + (T - head) // (16 // isz) * (16 // isz)
        cover = np.zeros(T, int)
        cover[head:tail] += 1                       # the 16-byte copies
        cover[np.arange(NT)[np.arange(NT) < head]] += 1
        cover[tail + np.arange(NT)[np.arange(NT) < T - tail]] += 1
        assert np.all(cover == 1)
        s = ral[e].astype(fdt)
        written = np.zeros(T, bool)
        n, th = int(n0[e]), np.arange(NT)
        L = -(-T // NT)
        t0 = np.minimum(th * L, T)
        t1 = np.minimum(t0 + L, T)
        lev = t0[:, None] + np.arange(L)[None, :]
        anc = (lev < t1[:, None]) & (lev < n) & (s[np.minimum(lev, T - 1)]
                                                > 0)
        first = np.where(anc, lev, T).min(1).reshape(NW, 32)
        last = np.where(anc, lev, -1).max(1).reshape(NW, 32)
        pmax = np.maximum.accumulate(last, axis=1)
        smin = np.minimum.accumulate(first[:, ::-1], axis=1)[:, ::-1]
        wl, wf = pmax[:, -1], smin[:, 0]
        left = np.concatenate([np.full((NW, 1), -1), pmax[:, :-1]], 1)
        right = np.concatenate([smin[:, 1:], np.full((NW, 1), T)], 1)
        for w in range(NW):
            left[w] = np.maximum(left[w], wl[:w].max(initial=-1))
            right[w] = np.minimum(right[w], wf[w + 1:].min(initial=T))
        left, right = left.ravel(), right.ravel()
        ra0, ra1 = int(wf.min()), int(wl.max())
        has = ra1 >= 0
        al_m = al_b = fdt(0)
        with np.errstate(invalid="ignore", divide="ignore"):
            if has:
                f0, f1 = s[ra0], s[ra1]
                al_m = (f1 - f0) / fdt(ra1 - ra0)
                al_b = f0 - al_m * fdt(ra0)
            lt, rt = left.copy(), np.full(NT, -1)
            for i in range(L):
                t = t0 + i
                tc = np.minimum(t, T - 1)
                act = t < t1
                assert not written[tc[act]].any()
                x = s[tc]
                is_anc = act & (t < n) & (x > 0)
                lt = np.where(is_anc, t, lt)
                rest = act & ~is_anc
                inval = rest & ~((t < n) & has)
                flank = rest & ~inval & ((t < ra0) | (t > ra1))
                interp = rest & ~inval & ~flank & (lt > 0)
                srch = interp & (rt < t)
                c = t + 1
                while srch.any():                   # the look-ahead
                    out = srch & (c >= t1)
                    rt = np.where(out, right, rt)
                    srch &= ~out
                    cc = np.minimum(c, T - 1)
                    assert not written[cc[srch]].any()
                    hit = srch & (c < n) & (s[cc] > 0)
                    rt = np.where(hit, c, rt)
                    srch &= ~hit
                    c = c + 1
                ltc, rtc = np.clip(lt, 0, T - 1), np.clip(rt, 0, T - 1)
                assert not written[ltc[interp]].any()
                assert not written[rtc[interp]].any()
                lv, rv = s[ltc], s[rtc]
                m = (rv - lv) / (rt - lt).astype(fdt)
                v = np.where(inval, fdt(np.inf),
                             np.where(flank, al_m * t.astype(fdt) + al_b,
                                      m * (t - lt).astype(fdt) + lv))
                wr = inval | flank | interp
                s[t[wr]] = v[wr].astype(fdt)
                written[t[wr]] = True
        qmax, carry = max(min(int(S_e[e]), C), 0), IMAX
        o0, o1 = i0[e], i1[e]
        for base in range(0, qmax, NT * CPT):
            q = base + 1 + th[:, None] * CPT + np.arange(CPT)[None, :]
            low, high = np.zeros_like(q), np.full_like(q, T)
            for _ in range(T.bit_length()):
                mid = (low + high) >> 1
                go = ~(s[np.minimum(mid, T - 1)] < q.astype(fdt))
                low, high = np.where(go, low, mid), np.where(go, mid, high)
            imid = np.minimum(np.maximum(high, 1), max(n, 1))
            lo = np.maximum(imid - width, 1)
            hi = np.minimum(imid + width, n)
            inc = np.minimum.accumulate((lo - q * DMAX).min(1).reshape(
                NW, 32), axis=1)
            ex = np.concatenate([np.full((NW, 1), IMAX), inc[:, :-1]], 1)
            wpre = np.minimum.accumulate(np.concatenate([[IMAX],
                                                         inc[:-1, -1]]))
            ex = np.minimum(np.minimum(ex, wpre[:, None]).ravel(), carry)
            carry = min(carry, int(inc[:, -1].min()))
            for j in range(CPT):
                ex = np.minimum(ex, lo[:, j] - q[:, j] * DMAX)
                start = q[:, j] * DMAX + ex
                ok = q[:, j] <= qmax
                o0[q[ok, j]] = start[ok]
                o1[q[ok, j]] = np.minimum(hi[ok, j], start[ok] + 2 * width)
        o0[0], o1[0] = 0, min(n, 2 * width)
        o0[qmax + 1:] = o0[qmax] if qmax > 0 else 0
        o1[qmax + 1:] = 0
    assert np.all(i0 != -7) and np.all(i1 != -7)
    return i0, i1


@pytest.mark.parametrize("C", [1, 255, 256, 257, 1024, 1025, 3000])
@pytest.mark.parametrize("T", [1, 31, 255, 256, 257, 1024, 4000])
def test_geom_kernel_model_equals_twin(T, C):
    """The geometry kernel's decomposition (per-thread level runs, the
    four block scans, ri staged and written in place, the interleaved
    bisections, the column passes and their carry) equals geom_reference
    bit for bit in f64 and f32, on rows with one anchor (NaN flanks), the
    level-0 quirk, no anchor, anchors only past n0, n0 = 1, an anchor at
    level 0 only, a slowing row whose rate limit carries across warps and
    passes, and S_e below C (test_torch_kernels_cuda._geom_edge_rows;
    constants GNT, CPT read from the source); at GNT = 512 and CPT = 2,
    T = 4000 takes 8 levels a thread, C = 1024 one pass of two columns a
    thread, 1025 and 3000 two and three passes."""
    ral, n0, S_e = _geom_edge_rows(T, C)
    for dt, fdt in ((torch.float64, np.float64), (torch.float32, np.float32)):
        ref = geom_reference(torch.as_tensor(ral, dtype=dt),
                             torch.as_tensor(n0), torch.as_tensor(S_e), 8, C)
        got = _geom_kernel_model(ral, n0, S_e, 8, C, fdt)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r.numpy())
