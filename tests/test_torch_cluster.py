"""NumPy models of the cluster instances of the group scorer and of the
scoring geometry (csrc/mutscore.cu group_kernel<T, RPT, CL>, csrc/geom.cu
geom_cluster_kernel), held to their plain twins bit for bit in f64 and f32
before the kernels run on the card.

The scorer's model splits a (group, event row) pair's window over CTAs of
SPAN rows (here 64: a 201-row window takes 4 CTAs, a 193-row one 3 and
its last row, a destination of one level-0 down-sweep combine only, is
the last CTA's extra row, combined after the scan): each CTA keeps
its rows of the carried column and a halo of the row below and the DMAX
rows above, which its neighbours send after each step; a step's reads of
the carried column are asserted to fall in the CTA's own rows or its halo
and never on a row not yet written; the scan is the cluster scan's model
(test_torch_warp_scan.cluster_scan_model); each CTA keeps the running max
of its rows' column maxima and its value at k_star, and takes the joins'
maxima over its rows only; the pair's delta is the max of the CTAs' new
scores less the max of their old ones.  The geometry's model splits an
event's levels into ncta slices: each CTA's threads take runs of its slice,
the anchor carries take the other CTAs' first and last anchors, ri is
rewritten per slice (a read of another slice asserted to be an anchor's),
and the columns go in passes of the cluster's threads, the rate limit's
prefix minimum taking the lower ranks' pass minima and every rank's for
the carry."""

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.core.regions import MutationInfo
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine.dp import DMAX, emission, neg_big, window
from poreseq_tpu_torch.engine.mutscore import (_spans, geom_reference,
                                               group_deltas_reference,
                                               group_launches)
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.sim import simulate_session
from test_torch_kernels_cuda import _geom_edge_rows, _geom_rows
from test_torch_warp_scan import cluster_scan_model

torch.set_num_threads(1)

#: the model's window rows a CTA, and rows a thread: a 201-row window
#: (scoring width 100) over 4 CTAs
MODEL_SPAN, MODEL_RPT = 64, 2


def _elements(D, a_stay, a_ext, lin, cut, nb):
    """A step's scan elements [6, Ws], as dp.column_solve builds them."""
    z = torch.zeros_like(D)
    return torch.stack([torch.where(cut, nb, torch.maximum(lin + z, a_stay)),
                        torch.where(cut, nb, a_ext),
                        torch.where(cut, nb, a_stay),
                        torch.where(cut, nb, a_ext), D,
                        torch.where(cut, nb, z)])


def group_cluster_model(args, span=MODEL_SPAN, rpt=MODEL_RPT, stats=None):
    """The cluster instance's schedule on group_deltas_reference's
    arguments: deltas [G, P, E_g].  stats, if given, counts the carried
    column's reads across a CTA's edge ("halo"), the slots whose k_star is
    their last step ("k_star last") and those joining the copied column
    ("copied")."""
    (batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb, ev_region,
     gp, off, W, Ws, RS, K, P, DM, E_g) = args
    C1, E, _ = Mf.shape
    Q1 = win[0].shape[0]
    dt = Mf.dtype
    nb = neg_big(dt)
    sp = _spans(W, RS, DM)
    # ceil((Ws - 1) / span) CTAs; at Ws = n span + 1 the last row is the
    # last CTA's extra row, combined from the row below after the scan
    ncta = max(1, -(-(Ws - 1) // span))
    nscan = min(Ws, ncta * span)
    G = gp["g_start"].shape[0]
    stats = {} if stats is None else stats
    for k in ("halo", "k_star last", "copied", "extra row"):
        stats.setdefault(k, 0)
    out = torch.zeros((G, P, E_g), dtype=dt)
    rows = torch.arange(Ws)
    cut = rows == 0
    # the CTAs' rows of a window and of the joins' W rows
    mine = [(q * span, min((q + 1) * span, Ws) if q + 1 < ncta else Ws)
            for q in range(ncta)]
    joins = [(q * span, (q + 1) * span if q + 1 < ncta else W)
             for q in range(ncta)]
    g_ = {k: v.long() for k, v in gp.items()}
    cl = lambda x, lo, hi: min(max(int(x), lo), hi)
    for g in range(G):
        start, si, sS = (int(g_[k][g]) for k in ("g_start", "g_startind",
                                                  "g_S"))
        st0 = cl(si, 0, C1 - 1)
        mlen, nst = g_["s_mlen"][g], g_["s_nst"][g]
        nfill = [cl(min(si + int(mlen[p]) + 6, int(nst[p])) - si, 0, K)
                 for p in range(P)]
        for el in range(E_g):
            e = cl(g_["g_evoff"][g], 0, E - E_g) + el
            if not (bool(batch.active[e])
                    and int(ev_region[e]) == int(g_["g_region"][g])):
                continue
            n0e = int(batch.n0[e])
            Mw, Sw = Mf[st0, e], Sf[st0, e]
            wi0, wi1 = int(i0f[e, st0]), int(i1f[e, st0])
            wbest = bpf[st0, e]
            lsk, lst, lex, lin = (getattr(batch, n)[e] for n in (
                "lik_skip", "lik_stay", "lik_extend", "lik_insert"))
            cik, ci0 = [], wi0 + RS               # group_anchors
            for k in range(K):
                cik.append(ci0)
                if any(k < int(mlen[p]) + 6 and si + 1 + k <= int(nst[p])
                       and k < nfill[p] for p in range(P)):
                    ci0 = int(i0r[e, cl(st0 + 1 + k, 0, C1 - 1)])
            # the old score: each CTA's part over its join rows
            q_old = cl(min(max(start - 3, 1), sS), 0, C1 - 1)
            fao = int(i0f[e, q_old])
            rr = torch.arange(W)
            ok = (fao + rr >= 1) & (fao + rr <= n0e)
            term = torch.where(ok, torch.maximum(Mf[q_old, e] + Mb[q_old, e],
                                                 Sf[q_old, e] + Sb[q_old, e]),
                               torch.zeros((), dtype=dt))
            old = max(torch.maximum(torch.maximum(
                torch.clamp(term[a:b].max(), min=0.0), bpf[q_old, e]),
                bpb[q_old, e]) for a, b in joins)
            for p in range(P):
                if not bool(gp["s_valid"][g, p]):
                    continue
                Lf = si + nfill[p]
                refind_used = min(start + int(mlen[p]) + 1, max(Lf, si))
                k_star = refind_used - si - 1
                # each CTA's carried rows: the row below at 0, its own at
                # 1.., the DMAX rows above after them; NaN: not written
                Mc = [np.full(span + DMAX + 1, np.nan) for _ in range(ncta)]
                for q, (a, b) in enumerate(mine):
                    Mc[q][1:1 + b - a] = 0.0
                sel = [None] * ncta
                tbest = [wbest.item()] * ncta
                tsb = list(tbest)
                sa = wi0 + RS

                def carried(w, x):
                    """Row x of the carried column as row w's CTA reads it."""
                    if not 0 <= x < Ws:
                        return 0.0
                    owner = lambda r: min(r // span, ncta - 1)
                    q = owner(w)
                    i = x - q * span + 1
                    assert 0 <= i < span + DMAX + 1
                    v = Mc[q][i]
                    assert not np.isnan(v), (w, x)
                    stats["halo"] += owner(x) != q
                    return v

                for k in range(K):
                    if not (k < int(mlen[p]) + 6 and si + 1 + k <= int(nst[p])
                            and k < nfill[p]):
                        break
                    q = cl(st0 + 1 + k, 0, C1 - 1)
                    qw = cl(st0 + 1 + k, 0, Q1 - 1)
                    i0c, i1c = int(i0r[e, q]), int(i1r[e, q])
                    st = int(gp["s_win"][g, p, k])
                    stc = cl(st, 0, 1023)
                    live = (i0c + rows <= i1c) & (st >= 0)
                    lm, ls, ll, smn, lam, llam = (
                        getattr(batch, f)[e, stc] for f in (
                            "lev_mean", "lev_stdv", "log_lev", "sd_mean",
                            "sd_lambda", "log_lambda"))
                    eo = torch.where(live, emission(
                        win[0][qw, e], win[1][qw, e], win[2][qw, e], lm, ls,
                        ll, smn, lam, llam, off), torch.zeros((), dtype=dt))
                    if k == 0:
                        s = i0c - wi0 - 1
                        inr = sp["FSMIN"] - 1 <= s <= sp["FSMAX"]
                        sh = lambda x: torch.where(
                            torch.tensor(inr), window(Mw[None], torch.tensor(
                                [x]), Ws)[0], torch.zeros((), dtype=dt))
                        pm_im1, pm_i = sh(s), sh(s + 1)
                        p0, p1 = wi0, wi1
                    else:
                        d = i0c - cik[k]
                        okd = 0 <= d <= DMAX
                        pm_i = torch.tensor([carried(w, w + d) if okd else 0.0
                                             for w in range(Ws)], dtype=dt)
                        pm_im1 = torch.tensor([carried(w, w + d - 1) if okd
                                               else 0.0 for w in range(Ws)],
                                              dtype=dt)
                        p0, p1 = cik[k], cik[k] + Ws - 1
                    i = i0c + rows
                    valid_i = (i >= p0) & (i <= p1)
                    valid_ul = (i > p0) & (i <= p1)
                    zero = torch.zeros((), dtype=dt)
                    skip_c = torch.where(valid_i, pm_i, zero) + lsk
                    match_c = torch.where(valid_ul, pm_im1, zero) + eo
                    ignore_c = torch.where(valid_ul, pm_im1 + lin, zero)
                    D = torch.maximum(torch.clamp(skip_c, min=0.0),
                                      torch.maximum(match_c, ignore_c))
                    el6 = _elements(D, eo + lst, eo + lex, lin, cut, nb)
                    u = cluster_scan_model(el6[:, :nscan].numpy(), ncta, rpt)
                    if nscan < Ws:              # the extra row
                        x = el6[:, -1].numpy()
                        u = np.concatenate([u, np.stack([
                            np.maximum(np.maximum(x[0] + u[0, -1],
                                                  x[1] + u[1, -1]), x[4]),
                            np.maximum(np.maximum(x[2] + u[0, -1],
                                                  x[3] + u[1, -1]), x[5])
                        ])[:, None]], axis=1)
                        stats["extra row"] += 1
                    u = torch.as_tensor(u)
                    Mn = torch.where(live, u[0], zero)
                    Sn = torch.where(live, u[1], zero)
                    for c, (a, b) in enumerate(mine):
                        Mc[c][1:1 + b - a] = Mn[a:b].numpy()
                        if c > 0:                  # to the CTA below
                            top = min(b, a + DMAX)
                            Mc[c - 1][span + 1:span + 1 + top - a] = \
                                Mn[a:top].numpy()
                        if c + 1 < ncta:           # to the CTA above
                            Mc[c + 1][0] = Mn[b - 1].item()
                        tbest[c] = max(tbest[c], torch.where(
                            live[a:b], Mn[a:b], nb).max().item())
                        if k == k_star:
                            sel[c] = (Mn[a:b], Sn[a:b])
                    if k == k_star:
                        tsb, sa = list(tbest), i0c
                        stats["k_star last"] += k == nfill[p] - 1
                # the new score: each CTA's part over its join rows
                rab = min(max(int(nst[p]) - refind_used + 1, 0), sS)
                q_b = cl(sS - rab + 1, 0, C1 - 1)
                ba = int(i0f[e, q_b])
                BM, BS, bbest = Mb[q_b, e], Sb[q_b, e], bpb[q_b, e]
                use_sel = k_star >= 0
                stats["copied"] += not use_sel
                if use_sel:
                    FM = torch.zeros(W, dtype=dt)
                    FS = torch.zeros(W, dtype=dt)
                    for c, (a, b) in enumerate(mine):
                        FM[a:b], FS[a:b] = sel[c]
                    fa, lo, hi = sa, sp["JMIN"], sp["JMAX"]
                else:
                    FM, FS, fa = Mw, Sw, wi0
                    lo, hi = sp["CMIN"], sp["CMAX"]
                s = fa - ba
                inr = lo <= s <= hi
                BMs = window(BM[None], torch.tensor([s]), W)[0] if inr \
                    else torch.zeros(W, dtype=dt)
                BSs = window(BS[None], torch.tensor([s]), W)[0] if inr \
                    else torch.zeros(W, dtype=dt)
                okF = (fa + rr >= 1) & (fa + rr <= n0e)
                okB = (ba + rr >= 1) & (ba + rr <= n0e)
                A = torch.maximum(torch.maximum(FM + BMs, FS + BSs),
                                  torch.maximum(FM, FS))
                term = torch.maximum(torch.where(okF, A, zero),
                                     torch.where(okB, torch.maximum(BM, BS),
                                                 zero))
                new = max(torch.maximum(torch.maximum(
                    torch.clamp(term[a:b].max(), min=0.0),
                    torch.tensor(tsb[c] if use_sel else wbest.item(),
                                 dtype=dt)), bbest)
                    for c, (a, b) in enumerate(joins))
                out[g, p, el] = new - old
    return out


def _scorer_args(dtype, scoring):
    """group_launches' arguments on a 150 b region at 3X, at a scoring
    width and realign width 10 more: substitutions, insertions and
    deletions through the region and at its tail (the copied column, and
    slots stopped by the sequence's end)."""
    pa, _ = simulate_session(np.random.default_rng(44), ref_len=150,
                             coverage=3, draft_error=0.03)
    pa.params.update(realign_width=scoring + 10, scoring_width=scoring)
    data = AlignData.from_session(pa)
    seq = data.sequence
    muts = []
    for start, o, m in [(20, seq[20], "A"), (20, "", "CG"),
                        (57, seq[57:59], ""), (90, seq[90], "T"),
                        (len(seq) - 3, seq[-3], "G"),
                        (len(seq) - 1, seq[-1], ""),
                        (len(seq) - 1, "", "ACGTAC"), (len(seq), "", "C")]:
        mi = MutationInfo()
        mi.start, mi.orig, mi.mut = start, o, m
        muts.append(mi)
    engine = TorchEngine("cpu", dtype)
    return [args for _, _, args in group_launches(engine, [data], [muts],
                                                  [True])]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("scoring,ctas", [(100, 4), (96, 3)])
def test_group_cluster_model_equals_twin(dtype, scoring, ctas):
    """The scorer's cluster schedule (CTAs of 64 rows: at Ws = 201 four,
    the last partial; at Ws = 193 three and the extra row) gives
    group_deltas_reference's deltas bit for bit, with carried-column reads
    across CTA edges (shifts d past a CTA's top rows, and d - 1 below its
    first), slots whose k_star is their last step, and copied-column
    joins."""
    stats = {}
    n = 0
    for args in _scorer_args(dtype, scoring):
        Ws = args[16]
        assert Ws == 2 * scoring + 1
        assert max(1, -(-(Ws - 1) // MODEL_SPAN)) == ctas
        ref = group_deltas_reference(*args)
        got = group_cluster_model(args, stats=stats)
        assert got.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        n += int((ref != 0).sum())
    assert n > 0
    assert stats["halo"] > 0 and stats["k_star last"] > 0
    assert stats["copied"] > 0
    assert (stats["extra row"] > 0) == (Ws == ctas * MODEL_SPAN + 1)


def geom_cluster_model(ral, n0, S_e, width, C, fdt, ncta, nt=64, cpt=2,
                       stats=None):
    """csrc/geom.cu geom_cluster_kernel on NumPy rows: ncta CTAs of nt
    threads an event, CTA q holding levels [q TS, (q + 1) TS), TS = ceil(T /
    ncta).  Returns i0, i1 [E, C + 1]; stats, if given, counts the reads of
    another CTA's slice ("remote") and the passes over the columns
    ("passes")."""
    IMAX, DM = np.iinfo(np.int64).max, DMAX
    E, T = ral.shape
    stats = {} if stats is None else stats
    for k in ("remote", "passes"):
        stats.setdefault(k, 0)
    TS = -(-T // ncta)
    nw = nt // 32
    i0 = np.full((E, C + 1), -7, np.int64)
    i1 = np.full((E, C + 1), -7, np.int64)
    for e in range(E):
        s = ral[e].astype(fdt)
        n = int(n0[e])
        owner = np.arange(T) // TS

        def at(t, q):
            """Level t read by CTA q while ri is written: an anchor's, which
            no CTA rewrites."""
            stats["remote"] += owner[t] != q
            assert t < n and s[t] > 0
            return s[t]

        # each CTA: its threads' runs, first and last anchors, the block
        # scans' carries within it, then the CTA's own first and last
        runs = []
        cf, cl = np.full(ncta, T), np.full(ncta, -1)
        for q in range(ncta):
            lo = min(q * TS, T)
            nk = min(TS, T - lo)
            L = -(-nk // nt)
            for k in range(nt):
                t0 = lo + min(k * L, nk)
                t1 = min(t0 + L, lo + nk)
                anc = [t for t in range(t0, t1) if t < n and s[t] > 0]
                runs.append((q, t0, t1, anc[0] if anc else T,
                             anc[-1] if anc else -1))
            f = [r[3] for r in runs[q * nt:(q + 1) * nt]]
            la = [r[4] for r in runs[q * nt:(q + 1) * nt]]
            cf[q], cl[q] = min(f), max(la)
        ra0, ra1 = int(cf.min()), int(cl.max())
        has = ra1 >= 0
        ends = []
        for j, (q, t0, t1, f, la) in enumerate(runs):
            k = j % nt
            base = q * nt
            left = max([r[4] for r in runs[base:base + k]] +
                       [int(cl[:q].max(initial=-1))] + [-1])
            right = min([r[3] for r in runs[base + k + 1:base + nt]] +
                        [int(cf[q + 1:].min(initial=T))] + [T])
            ends.append((left, right))
        al_m = al_b = fdt(0)
        with np.errstate(invalid="ignore", divide="ignore"):
            if has:
                f0, f1 = at(ra0, -1), at(ra1, -1)
                al_m = (f1 - f0) / fdt(ra1 - ra0)
                al_b = f0 - al_m * fdt(ra0)
            new = s.copy()
            for (q, t0, t1, _, _), (left, right) in zip(runs, ends):
                lt, rt = left, -1
                for t in range(t0, t1):
                    x = s[t]
                    if t < n and x > 0:
                        lt = t
                        continue
                    if not (t < n and has):
                        v = fdt(np.inf)
                    elif t < ra0 or t > ra1:
                        v = al_m * fdt(t) + al_b
                    elif lt > 0:
                        if rt < t:
                            rt = t + 1
                            while rt < t1 and not (rt < n and s[rt] > 0):
                                rt += 1
                            if rt == t1:
                                rt = right
                        lv, rv = at(lt, q), at(rt, q)
                        m = (rv - lv) / fdt(rt - lt)
                        v = m * fdt(t - lt) + lv
                    else:
                        continue
                    new[t] = fdt(v)
            s = new                 # the bisection reads every slice's ri
        qmax, carry = max(min(int(S_e[e]), C), 0), IMAX
        step = ncta * nt * cpt
        o0, o1 = i0[e], i1[e]
        gk = np.arange(ncta * nt)
        for base in range(0, qmax, step):
            stats["passes"] += 1
            qs = base + 1 + gk[:, None] * cpt + np.arange(cpt)[None, :]
            low, high = np.zeros_like(qs), np.full_like(qs, T)
            for _ in range(T.bit_length()):
                mid = (low + high) >> 1
                go = ~(s[np.minimum(mid, T - 1)] < qs.astype(fdt))
                low, high = np.where(go, low, mid), np.where(go, mid, high)
            imid = np.minimum(np.maximum(high, 1), max(n, 1))
            lo_ = np.maximum(imid - width, 1)
            hi = np.minimum(imid + width, n)
            run = (lo_ - qs * DM).min(1)               # [ncta nt]
            # in-warp inclusive scans, the CTA's warps, then the CTAs
            inc = np.minimum.accumulate(run.reshape(ncta, nw, 32), axis=2)
            ex = np.concatenate([np.full((ncta, nw, 1), IMAX),
                                 inc[:, :, :-1]], 2)
            wtot = inc[:, :, -1]                       # [ncta, nw]
            wpre = np.concatenate([np.full((ncta, 1), IMAX),
                                   np.minimum.accumulate(wtot, 1)[:, :-1]], 1)
            ex = np.minimum(ex, wpre[:, :, None])
            ctot = wtot.min(1)                         # [ncta]
            cpre = np.concatenate([[IMAX],
                                   np.minimum.accumulate(ctot)[:-1]])
            ex = np.minimum(np.minimum(ex, cpre[:, None, None]).ravel(),
                            carry)
            carry = min(carry, int(ctot.min()))
            for j in range(cpt):
                ex = np.minimum(ex, lo_[:, j] - qs[:, j] * DM)
                start = qs[:, j] * DM + ex
                ok = qs[:, j] <= qmax
                o0[qs[ok, j]] = start[ok]
                o1[qs[ok, j]] = np.minimum(hi[ok, j], start[ok] + 2 * width)
        o0[0], o1[0] = 0, min(n, 2 * width)
        o0[qmax + 1:] = o0[qmax] if qmax > 0 else 0
        o1[qmax + 1:] = 0
    assert np.all(i0 != -7) and np.all(i1 != -7)
    return i0, i1


# (T, C, ncta): rows over 2-16 CTAs, columns over one to several passes of
# the cluster's threads (64 a CTA in the model, 2 columns each)
GEOM_CLUSTER_CASES = [(70, 50, 2), (70, 50, 3), (255, 257, 4),
                      (1024, 1025, 3), (1024, 3000, 16), (4000, 1024, 5),
                      (4000, 3000, 8)]


@pytest.mark.parametrize("T,C,ncta", GEOM_CLUSTER_CASES)
def test_geom_cluster_model_equals_twin(T, C, ncta):
    """The geometry's cluster schedule equals geom_reference bit for bit
    in f64 and f32: at T = 70 on _geom_rows' unsorted rows (one anchored
    level: NaN flanks; the level-0 quirk; no anchor), else on
    _geom_edge_rows (S_e below C, carries across warps, CTAs and passes),
    with reads of other CTAs' slices that are anchors only."""
    if T == 70:
        ral, n0, S_e = _geom_rows(np.random.default_rng(C + ncta),
                                  C=max(C, 8))
        S_e = np.minimum(S_e, C).astype(np.int32)
    else:
        ral, n0, S_e = _geom_edge_rows(T, C)
    for dt, fdt in ((torch.float64, np.float64), (torch.float32, np.float32)):
        ref = geom_reference(torch.as_tensor(ral, dtype=dt),
                             torch.as_tensor(n0), torch.as_tensor(S_e), 8, C)
        stats = {}
        got = geom_cluster_model(ral, n0, S_e, 8, C, fdt, ncta, stats=stats)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r.numpy())
        assert stats["remote"] > 0
        assert stats["passes"] >= (2 if C > ncta * 128 else 1)
