"""Batched mutation delta-scoring (ScoreMutations) on device.

Counterpart of ``poreseq_tpu/engine/tpu/mutscore.py`` (unstrided layout).
The reference's splice-and-refill trick (Alignment.cpp:447-512): per
(event, mutation), restart the forward DP from the column before the
mutation against the mutated states at scoring width, join the refilled
column with the precomputed backward lattice (columnMax, Alignment.h:181-214)
and difference against the pre-mutation join.  Mutations sharing a start
form a group of up to P=9 slots.

Kernel 2 of the port is the group scorer (csrc/mutscore.cu) with the
semantics of ``mutscore._group_kernel_body``; ``group_deltas_reference`` is
its plain twin.  Both write one delta per (group, slot, event row of the
group's region slice) and reduce the event axis in a fixed order.  The
post-backtrace band geometry (``geom_body``) and the scoring-band data
windows (``build_windows``) are kernels 9 and 10 (csrc/geom.cu) with the
plain twins ``geom_reference`` and ``windows_reference``.  The NumPy group
builders are copies of the JAX module's host helpers.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .._build import Kernel, check, dtype_suffix, ptr, route, stream
from ..parallel.mesh import pad_axis, shard_rows
from ..core.sequence import (_POW4, apply_mutation, seq_to_codes,
                              seq_to_states)
from .align import both_dev, both_dev_sharded
from .dp import (DMAX, MODEL_FIELDS, column_solve, emission,
                 level_windows, neg_big, window)
from .fill import rows_per_thread
from .pack import (event_ref_indexes, fill_geometry, limited_geometry,
                   place_full, round_up)
from .types import make_mutscores

P_SLOTS = 9

# ---------------------------------------------------------------- host side


def _k_bucket(k: int) -> int:
    for b in (7, 16, 46, 160):
        if k <= b:
            return b
    return round_up(k, 128)


def _d_bucket(d: int) -> int:
    return 4 if d <= 4 else 32


def _g_bucket(g: int) -> int:
    for b in (32, 64, 128, 256, 512, 1024, 2048, 4096):
        if g <= b:
            return b
    return round_up(g, 4096)


def _partition_classes(datas, muts_list, participate):
    """Each region's mutations split into (K, D) classes, one scorer launch
    each: {(K, D): [(muts_subset, original_indexes), ...] per region}."""
    classes: dict = {}
    for r, muts in enumerate(muts_list):
        if not participate[r]:
            continue
        for i, m in enumerate(muts):
            kb = _k_bucket(len(m.mut) + 6)
            db = _d_bucket(abs(len(m.mut) - len(m.orig)))
            cls = classes.setdefault(
                (kb, db), [([], []) for _ in range(len(datas))])
            cls[r][0].append(m)
            cls[r][1].append(i)
    return classes


def _mut_windows_fast(sequence, muts, K_all):
    """Vectorized per-mutation state windows for pure-ACGT sequence+muts.
    Returns (states [N, K_all] int32 with -1 padding, nst [N])."""
    N = len(muts)
    S0 = len(sequence)
    codes = seq_to_codes(sequence)
    starts = np.fromiter((m.start for m in muts), np.int64, N)
    lo = np.fromiter((len(m.orig) for m in muts), np.int64, N)
    lm = np.fromiter((len(m.mut) for m in muts), np.int64, N)
    # past-the-end starts are no-ops; orig spans past the end are clamped
    # to the in-sequence tail (Sequence.h:38-59)
    noop = starts >= S0
    lo = np.minimum(lo, np.maximum(S0 - starts, 0))
    lm_eff = np.where(noop, 0, lm)

    Mmax = max(int(lm.max()), 1) if N else 1
    mcodes = np.zeros((N, Mmax), dtype=np.int64)
    for i, m in enumerate(muts):
        if m.mut:
            mcodes[i, : len(m.mut)] = seq_to_codes(m.mut)

    si = np.maximum(starts - 4, 0)
    pre = starts - si
    Lmax = K_all + 4
    j = np.arange(Lmax, dtype=np.int64)[None, :]
    in_pre = j < pre[:, None]
    in_mut = ~in_pre & (j < (pre + lm_eff)[:, None])
    suf_idx = starts[:, None] + lo[:, None] + j - (pre + lm_eff)[:, None]
    src_idx = np.where(in_pre, si[:, None] + j, suf_idx)
    ok = src_idx < S0
    w = codes[np.clip(src_idx, 0, S0 - 1)]
    midx = np.clip(j - pre[:, None], 0, Mmax - 1)
    w = np.where(in_mut, np.take_along_axis(mcodes, midx, axis=1), w)
    w = np.where(in_mut | ok, w, 0)

    st = (np.lib.stride_tricks.sliding_window_view(w, 5, axis=1)
          @ _POW4).astype(np.int32)
    nst_seq = S0 + lm_eff - lo - 4
    wl = lm + 6
    nw = np.clip(np.minimum(wl, nst_seq - si), 0, K_all)
    st = np.where(np.arange(K_all)[None, :] < nw[:, None], st[:, :K_all], -1)
    return st, np.maximum(nst_seq, 0)


def _build_groups(sequence, muts, K_all, P=P_SLOTS):
    """Start-grouped slot arrays for ONE region's mutations: mutations
    sharing a start share a group of up to P slots."""
    N = len(muts)
    starts = np.fromiter((m.start for m in muts), np.int64, N)
    order = np.argsort(starts, kind="stable")
    has_bad = (any(c not in "ACGT" for c in set(sequence))
               or any(c not in "ACGT" for m in muts for c in set(m.mut)))

    sorted_starts = starts[order]
    run_start = np.ones(N, dtype=bool)
    run_start[1:] = sorted_starts[1:] != sorted_starts[:-1]
    run_first = np.maximum.accumulate(
        np.where(run_start, np.arange(N), 0))
    rank = np.arange(N) - run_first
    t_idx = rank % P
    new_g = run_start | (t_idx == 0)
    g_idx = np.cumsum(new_g) - 1
    G = int(g_idx[-1]) + 1 if N else 0

    g_start = np.zeros(G, dtype=np.int32)
    g_startind = np.zeros(G, dtype=np.int32)
    s_mlen = np.zeros((G, P), dtype=np.int32)
    s_nst = np.zeros((G, P), dtype=np.int32)
    s_win = np.full((G, P, K_all), -1, dtype=np.int32)
    s_valid = np.zeros((G, P), dtype=bool)
    s_idx = np.full((G, P), -1, dtype=np.int64)
    if not N:
        return dict(g_start=g_start, g_startind=g_startind, s_mlen=s_mlen,
                    s_nst=s_nst, s_win=s_win, s_valid=s_valid, s_idx=s_idx)

    g_start[g_idx] = sorted_starts
    g_startind[:] = np.maximum(g_start - 4, 0)
    s_idx[g_idx, t_idx] = order
    s_mlen[g_idx, t_idx] = np.fromiter((len(m.mut) for m in muts),
                                       np.int64, N)[order]
    s_valid[g_idx, t_idx] = (sorted_starts <= len(sequence))

    if not has_bad:
        win_fast, nst_fast = _mut_windows_fast(sequence, muts, K_all)
        s_win[g_idx, t_idx] = win_fast[order]
        s_nst[g_idx, t_idx] = nst_fast[order]
    else:
        for n in range(N):
            mi = int(order[n])
            m = muts[mi]
            g, t = int(g_idx[n]), int(t_idx[n])
            mutseq = apply_mutation(sequence, m.start, m.orig, m.mut)
            s_nst[g, t] = max(len(mutseq) - 4, 0)
            si = int(g_startind[g])
            wl = len(m.mut) + 6
            w = seq_to_states(mutseq)[si : si + wl]
            s_win[g, t, : len(w)] = w

    return dict(g_start=g_start, g_startind=g_startind, s_mlen=s_mlen,
                s_nst=s_nst, s_win=s_win, s_valid=s_valid, s_idx=s_idx)


def _pad_groups(parts, g_S_parts, g_region_parts, P=P_SLOTS):
    """Concatenate per-region group arrays; pad the group axis to its
    bucket."""
    G = sum(p["g_start"].shape[0] for p in parts)
    G_pad = _g_bucket(max(G, 1))
    K_all = parts[0]["s_win"].shape[2] if parts else _k_bucket(7)

    out = dict(
        g_start=np.zeros(G_pad, dtype=np.int32),
        g_startind=np.zeros(G_pad, dtype=np.int32),
        g_S=np.zeros(G_pad, dtype=np.int32),
        g_region=np.full(G_pad, -1, dtype=np.int32),
        g_evoff=np.zeros(G_pad, dtype=np.int32),
        s_mlen=np.zeros((G_pad, P), dtype=np.int32),
        s_nst=np.zeros((G_pad, P), dtype=np.int32),
        s_win=np.full((G_pad, P, K_all), -1, dtype=np.int32),
        s_valid=np.zeros((G_pad, P), dtype=bool),
        s_idx=np.full((G_pad, P), -1, dtype=np.int64),
        g_part=np.full(G_pad, -1, dtype=np.int32),
    )
    at = 0
    for part_i, (p, gS, greg) in enumerate(zip(parts, g_S_parts,
                                               g_region_parts)):
        n = p["g_start"].shape[0]
        for k in ("g_start", "g_startind", "s_mlen", "s_nst", "s_win",
                  "s_valid", "s_idx"):
            out[k][at : at + n] = p[k]
        out["g_S"][at : at + n] = gS
        out["g_region"][at : at + n] = greg
        out["g_part"][at : at + n] = part_i
        at += n
    out["G"] = G
    out["G_pad"] = G_pad
    return out


# ------------------------------------------------------------ device side

GROUP_FIELDS = ("g_start", "g_startind", "g_S", "g_region", "g_evoff",
                "s_mlen", "s_nst", "s_win", "s_valid")


def bisect_left(ri, q):
    """jnp.searchsorted(ri[e], q, side="left") for every row e of ri [E, T]
    and the finite queries q [Q]: [E, Q] int64, on any input.  It is JAX's
    own bisection (jax 0.9.0, lax_numpy.py ``_searchsorted_via_scan``):
    T.bit_length() = ceil(log2(T + 1)) fixed levels from (low, high) = (0,
    T), mid = (low + high) // 2 read at min(mid, T - 1), go left when q <=
    ri[mid] under lax's total order, where NaN sorts above +inf (for a finite
    q that is ``not ri[mid] < q``), and the answer is high.  On monotone rows
    any bisection gives this answer; on the rows geom_body can make it is the
    only one: a NaN flank (one anchored level) and the raw ral left by the
    reference's level-0 quirk are not sorted, and torch.searchsorted orders
    NaN otherwise.  csrc/geom.cu runs the same levels."""
    E, T = ri.shape
    low = torch.zeros((E, q.shape[0]), dtype=torch.long, device=ri.device)
    high = torch.full_like(low, T)
    for _ in range(T.bit_length()):
        mid = (low + high) // 2
        left = ~(torch.gather(ri, 1, mid.clamp(max=T - 1)) < q)
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


def geom_reference(ral, n0, S_e, width: int, C: int):
    """Plain twin of the geometry kernel: post-backtrace scoring-band
    geometry, update_refs (cpp/EventData.h:110-169) + band placement + DMAX
    rate limit, vectorized over events (mutscore._geom_body, equal to it on
    every input).  Matches the host limited_geometry(event_ref_indexes(...))
    up to f32 interpolation rounding at exact band-boundary crossings (one
    row); the f64 path uses the host geometry."""
    E, T = ral.shape
    dev, dt = ral.device, ral.dtype
    idx = torch.arange(T, device=dev)
    n0 = n0.long()
    validp = idx[None, :] < n0[:, None]
    anch = (ral > 0) & validp
    has = anch.any(dim=1)
    ar = torch.arange(E, device=dev)
    ra0 = torch.argmax(anch.to(torch.int32), dim=1)
    ra1 = T - 1 - torch.argmax(torch.flip(anch, [1]).to(torch.int32), dim=1)
    f0 = ral[ar, ra0]
    f1 = ral[ar, ra1]
    al_m = (f1 - f0) / (ra1 - ra0).to(dt)      # nan when ra1 == ra0
    al_b = f0 - al_m * ra0.to(dt)

    # interior interpolation between consecutive anchors; the reference's
    # `if (lastal > 0)` quirk keeps the raw value when the left anchor is at
    # level 0
    left = torch.cummax(torch.where(anch, idx, -1), dim=1).values
    right = torch.flip(torch.cummin(torch.flip(
        torch.where(anch, idx, T), [1]), dim=1).values, [1])
    lv = torch.gather(ral, 1, left.clamp(0, T - 1))
    rv = torch.gather(ral, 1, right.clamp(0, T - 1))
    m = (rv - lv) / (right - left).to(dt)
    interp = m * (idx[None] - left).to(dt) + lv
    flank = (idx[None, :] < ra0[:, None]) | (idx[None, :] > ra1[:, None])
    ri = torch.where(flank, al_m[:, None] * idx[None].to(dt) + al_b[:, None],
                     ral)
    ri = torch.where((~flank) & (~anch) & (left > 0), interp, ri)
    # levels past n0 (and inactive events) sort above every refind
    ri = torch.where(validp & has[:, None], ri, torch.inf)

    refinds = torch.arange(1, C + 1, dtype=dt, device=dev)
    imid = bisect_left(ri, refinds)
    imid = torch.minimum(imid.clamp(min=1), n0.clamp(min=1)[:, None])
    lo = (imid - width).clamp(min=1)
    hi = torch.minimum(imid + width, n0[:, None])

    # rate limit (starts advance <= DMAX/col): i0'[j] = min_k<=j i0[k]+(j-k)D
    j = torch.arange(1, C + 1, device=dev)[None, :]
    lo_lim = j * DMAX + torch.cummin(lo - j * DMAX, dim=1).values

    i0 = torch.cat([torch.zeros((E, 1), dtype=torch.long, device=dev),
                    lo_lim], dim=1)
    i1 = torch.cat([n0[:, None], hi], dim=1)
    i1 = torch.minimum(i1, i0 + 2 * width)
    cols = torch.arange(C + 1, device=dev)[None, :]
    S_e = S_e.long()
    anchor = torch.gather(i0, 1, S_e.clamp(max=C)[:, None])
    beyond = cols > S_e[:, None]
    i0 = torch.where(beyond, anchor, i0)
    i1 = torch.where(beyond, 0, i1)
    return i0.to(torch.int32), i1.to(torch.int32)


_GEOM_SIG = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
GEOM = Kernel("geom", "poreseq_tpu/engine/tpu/mutscore.py:171 _geom_body",
              {"psq_geom_f32": _GEOM_SIG, "psq_geom_f64": _GEOM_SIG})
# the longest row the kernel's first instance stages (then rewrites to ri)
# in shared memory; a longer one runs its second instance, which reads the
# row from device memory and writes ri to a scratch row
GEOM_MAX_LEVELS = {torch.float32: 57344, torch.float64: 28672}


def geom_cuda(ral, n0, S_e, width: int, C: int):
    """Launch csrc/geom.cu's geometry kernel: the twin's (i0, i1)."""
    E, T = ral.shape
    dev, dt = ral.device, ral.dtype
    check("ral", ral, dt, (E, T), dev)
    check("n0", n0, torch.int32, (E,), dev)
    check("S_e", S_e, torch.int32, (E,), dev)
    i0 = torch.empty((E, C + 1), dtype=torch.int32, device=dev)
    i1 = torch.empty((E, C + 1), dtype=torch.int32, device=dev)
    scratch = (torch.empty((E, T), dtype=dt, device=dev)
               if T > GEOM_MAX_LEVELS[dt] else None)
    GEOM.call(f"psq_geom_{dtype_suffix(dt)}", dev, ptr(ral), ptr(n0),
              ptr(S_e), ptr(i0), ptr(i1),
              None if scratch is None else ptr(scratch), E, T, C, width,
              stream(dev))
    return i0, i1


def geom_body(ral, n0, S_e, width: int, C: int):
    """Geometry wrapper: the twin for CPU tensors, the kernel for CUDA."""
    if route(ral, n0, S_e) == "cuda":
        return geom_cuda(ral, n0, S_e, width, C)
    return geom_reference(ral, n0, S_e, width, C)


def windows_reference(mean, stdv, lsr, i0r, Ws: int):
    """Plain twin of the windows kernel: scoring-band data windows
    [Q1, E, Ws] (dp.level_windows per column of the scoring geometry,
    column-major for the scorer)."""
    return tuple(w.transpose(0, 1).contiguous()
                 for w in level_windows(mean, stdv, lsr, i0r, Ws))


_WINDOWS_SIG = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
WINDOWS = Kernel("windows",
                 "poreseq_tpu/engine/tpu/mutscore.py:151 build_windows",
                 {"psq_windows_f32": _WINDOWS_SIG,
                  "psq_windows_f64": _WINDOWS_SIG}, src="geom")


def windows_cuda(mean, stdv, lsr, i0r, Ws: int):
    """Launch csrc/geom.cu's windows kernel: the twin's three windows."""
    E, T = mean.shape
    Q1 = i0r.shape[1]
    dev, dt = mean.device, mean.dtype
    for n, t in (("mean", mean), ("stdv", stdv), ("lsr", lsr)):
        check(n, t, dt, (E, T), dev)
    check("i0r", i0r, torch.int32, (E, Q1), dev)
    out = [torch.empty((Q1, E, Ws), dtype=dt, device=dev) for _ in range(3)]
    WINDOWS.call(f"psq_windows_{dtype_suffix(dt)}", dev, ptr(mean),
                 ptr(stdv), ptr(lsr), ptr(i0r), *map(ptr, out), E, T, Q1,
                 Ws, stream(dev))
    return tuple(out)


def build_windows(mean, stdv, lsr, i0r, Ws: int):
    """Windows wrapper: the twin for CPU tensors, the kernel for CUDA."""
    if route(mean, stdv, lsr, i0r) == "cuda":
        return windows_cuda(mean, stdv, lsr, i0r, Ws)
    return windows_reference(mean, stdv, lsr, i0r, Ws)


def _band_mask(anchor, n0, width: int):
    """valid absolute-row mask [..., width] for columns at `anchor`."""
    i = anchor[..., None] + torch.arange(width, device=anchor.device)
    return (i >= 1) & (i <= n0[..., None])


def _join_lag0(FM, FS, fbest, BM, BS, bbest, okF):
    """columnMax of two columns sharing an anchor (lag 0)."""
    cross = torch.maximum(FM + BM, FS + BS)
    sm = torch.where(okF, cross, 0.0).amax(dim=-1).clamp(min=0.0)
    return torch.maximum(torch.maximum(sm, fbest), bbest)


def _join_shift(FM, FS, fa, fbest, BM, BS, ba, bbest, n0, smin, smax):
    """columnMax of fwd column (anchor fa) vs back column (anchor ba) with lag
    s = fa - ba within [smin, smax] (else the cross term degrades to
    single-sided maxima).  F is zero-padded up to B's width."""
    W = BM.shape[-1]
    if FM.shape[-1] < W:
        padn = W - FM.shape[-1]
        FM = torch.nn.functional.pad(FM, (0, padn))
        FS = torch.nn.functional.pad(FS, (0, padn))
    s = fa - ba
    inr = ((s >= smin) & (s <= smax))[..., None]
    okF = _band_mask(fa, n0, W)
    okB = _band_mask(ba, n0, W)
    BMs = torch.where(inr, window(BM, s, W), 0.0)
    BSs = torch.where(inr, window(BS, s, W), 0.0)
    crossA = torch.maximum(FM + BMs, FS + BSs)
    sA = torch.where(okF, torch.maximum(crossA, torch.maximum(FM, FS)),
                     0.0).amax(dim=-1)
    sB = torch.where(okB, torch.maximum(BM, BS), 0.0).amax(dim=-1)
    sm = torch.maximum(sA, sB).clamp(min=0.0)
    return torch.maximum(torch.maximum(sm, fbest), bbest)


def _spans(W, RS, DM):
    span = DMAX * DM + 64      # + slack for differing rate-limit lags/clamps
    return dict(JMIN=-span, JMAX=RS + span,    # refill-vs-back join lags
                CMIN=-span, CMAX=span,         # copied-col-vs-back lags
                FSMIN=-64, FSMAX=RS + 64 + DMAX)   # wide-copy seam offsets


def group_deltas_reference(batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win,
                           bpf, bpb, ev_region, gp, lik_offset, W, Ws, RS,
                           K, P, DM, E_g):
    """Plain twin of the group scorer (mutscore._group_kernel_body):
    deltas [G, P, E_g], one per (group, slot, row of the group's region
    slice), 0 where the slot is invalid or the row is another region's or
    inactive.  Rows start at the group's g_evoff, clamped to E - E_g as
    jax.lax.dynamic_slice_in_dim clamps."""
    C1, E, _ = Mf.shape
    Q1 = win[0].shape[0]
    dev, dt = Mf.device, Mf.dtype
    nb = neg_big(dt)
    sp = _spans(W, RS, DM)
    rows = torch.arange(Ws, device=dev)
    g_start, g_startind, g_S, g_region, g_evoff = (
        gp[k].long() for k in GROUP_FIELDS[:5])
    mlen, nst, s_win = (gp[k].long() for k in ("s_mlen", "s_nst", "s_win"))
    s_valid = gp["s_valid"].bool()
    G = g_start.shape[0]

    ev = (g_evoff.clamp(0, E - E_g)[:, None]
          + torch.arange(E_g, device=dev)[None, :])                # [G, Eg]
    st0 = g_startind.clamp(0, C1 - 1)
    n0 = batch.n0.long()[ev]
    lik_sk, lik_st, lik_ex, lik_in = (
        getattr(batch, n)[ev][:, None, :, None] for n in
        ("lik_skip", "lik_stay", "lik_extend", "lik_insert"))
    Mw = Mf[st0[:, None], ev]                                       # [G,Eg,W]
    Sw = Sf[st0[:, None], ev]
    wi0 = i0f[ev, st0[:, None]].long()                              # [G, Eg]
    wi1 = i1f[ev, st0[:, None]].long()
    wbest = bpf[st0[:, None], ev]

    si = g_startind[:, None]
    nfill = (torch.minimum(si + mlen + 6, nst) - si).clamp(0, K)    # [G, P]
    Lf = si + nfill
    refind_used = torch.minimum(g_start[:, None] + mlen + 1,
                                torch.maximum(Lf, si))
    k_star = refind_used - si - 1        # -1 -> join the copied column
    stc = s_win.clamp(0, 1023)                                      # [G,P,K]
    mv = [getattr(batch, f)[ev[:, None, None, :], stc[..., None]]   # [G,P,K,Eg]
          for f in MODEL_FIELDS]

    shp = (G, P, E_g, Ws)
    Mc = torch.zeros(shp, dtype=dt, device=dev)
    selM = torch.zeros(shp, dtype=dt, device=dev)
    selS = torch.zeros(shp, dtype=dt, device=dev)
    ci0 = wi0 + RS
    sa = (wi0 + RS)[:, None].expand(G, P, E_g)
    sbest = wbest[:, None].expand(G, P, E_g)
    cbest = sbest
    cut = rows == 0
    for k in range(K):
        q = (st0 + 1 + k).clamp(0, C1 - 1)
        qw = (st0 + 1 + k).clamp(0, Q1 - 1)
        refind = g_startind + 1 + k
        i0c = i0r[ev, q[:, None]].long()                            # [G, Eg]
        i1c = i1r[ev, q[:, None]].long()
        mwv, swv, lwv = (w[qw[:, None], ev][:, None] for w in win)  # [G,1,Eg,Ws]
        i = (i0c[..., None] + rows)[:, None]                        # [G,1,Eg,Ws]
        in_band = i <= i1c[:, None, :, None]
        lm, ls, ll, smn, lam, llam = (m[:, :, k, :, None] for m in mv)
        e_obs = emission(mwv, swv, lwv, lm, ls, ll, smn, lam, llam,
                         lik_offset)
        live = in_band & (s_win[:, :, k] >= 0)[:, :, None, None]
        e_obs = torch.where(live, e_obs, 0.0)

        if k == 0:
            # wide copy of the forward column through the seam offset
            s = i0c - wi0 - 1
            inr = ((s >= sp["FSMIN"] - 1) & (s <= sp["FSMAX"]))[..., None]
            pm_im1 = torch.where(inr, window(Mw, s, Ws), 0.0)[:, None]
            pm_i = torch.where(inr, window(Mw, s + 1, Ws), 0.0)[:, None]
            p0, p1 = wi0, wi1
        else:
            # narrow carry of the previous refill column
            # (shifts d in [0, DMAX] and d-1 in [-1, DMAX-1]; else zeros)
            d = (i0c - ci0)[:, None].expand(G, P, E_g)
            okN = ((d >= 0) & (d <= DMAX))[..., None]
            pm_i = torch.where(okN, window(Mc, d, Ws), 0.0)
            pm_im1 = torch.where(okN, window(Mc, d - 1, Ws), 0.0)
            p0, p1 = ci0, ci0 + Ws - 1
        p0 = p0[:, None, :, None]
        p1 = p1[:, None, :, None]
        valid_i = (i >= p0) & (i <= p1)
        valid_ul = (i > p0) & (i <= p1)
        skip_c = torch.where(valid_i, pm_i, 0.0) + lik_sk
        match_c = torch.where(valid_ul, pm_im1, 0.0) + e_obs
        ignore_c = torch.where(valid_ul, pm_im1 + lik_in, 0.0)
        D = torch.maximum(torch.clamp(skip_c, min=0.0),
                          torch.maximum(match_c, ignore_c))
        a_stay = e_obs + lik_st
        a_ext = e_obs + lik_ex
        floor0 = torch.where(cut, nb, torch.zeros((), dtype=dt,
                                                  device=dev)).expand(shp)
        Mn, Sn = column_solve(D, a_stay, a_ext, lik_in, floor0,
                              cut.expand(shp), nb)
        Mn = torch.where(live, Mn, 0.0)
        Sn = torch.where(live, Sn, 0.0)
        cmax = torch.where(live, Mn, nb).amax(dim=-1)               # [G,P,Eg]
        bestn = torch.maximum(cmax, cbest)

        act = ((k < mlen + 6) & (refind[:, None] <= nst)
               & (k < nfill))                                       # [G, P]
        a3 = act[..., None]
        Mc = torch.where(a3[..., None], Mn, Mc)
        ci0 = torch.where(act.any(dim=1)[:, None], i0c, ci0)
        cbest = torch.where(a3, bestn, cbest)
        hit = act & (k_star == k)
        h3 = hit[..., None]
        selM = torch.where(h3[..., None], Mn, selM)
        selS = torch.where(h3[..., None], Sn, selS)
        sa = torch.where(h3, i0c[:, None], sa)
        sbest = torch.where(h3, bestn, sbest)

    # new score: selected refill column (or the copied column) vs the back
    # column at rab = nst - refind_used + 1
    sS = g_S[:, None]
    rab_new = torch.minimum((nst - refind_used + 1).clamp(min=0), sS)
    q_b = (sS - rab_new + 1).clamp(0, C1 - 1)                       # [G, P]
    evp = ev[:, None, :]
    BM = Mb[q_b[..., None], evp]                                    # [G,P,Eg,W]
    BS = Sb[q_b[..., None], evp]
    ba = i0f[evp, q_b[..., None]].long()                            # [G,P,Eg]
    bbest = bpb[q_b[..., None], evp]
    n0p = n0[:, None]
    new_n = _join_shift(selM, selS, sa, sbest, BM, BS, ba, bbest, n0p,
                        sp["JMIN"], sp["JMAX"])
    full = (G, P, E_g, W)
    new_w = _join_shift(Mw[:, None].expand(full), Sw[:, None].expand(full),
                        wi0[:, None].expand(G, P, E_g),
                        wbest[:, None].expand(G, P, E_g), BM, BS, ba, bbest,
                        n0p, sp["CMIN"], sp["CMAX"])
    new = torch.where((k_star >= 0)[..., None], new_n, new_w)

    # old score: fwd and back columns at the same column max(start-3, 1)
    q_old = torch.minimum(torch.clamp(g_start - 3, min=1), g_S)
    q_old = q_old.clamp(0, C1 - 1)[:, None]
    FMo, FSo, BMo, BSo = (x[q_old, ev] for x in (Mf, Sf, Mb, Sb))
    fao = i0f[ev, q_old].long()
    old = _join_lag0(FMo, FSo, bpf[q_old, ev], BMo, BSo, bpb[q_old, ev],
                     _band_mask(fao, n0, W))                        # [G, Eg]

    ok = (s_valid[..., None] & batch.active[ev][:, None, :]
          & (ev_region[ev] == g_region[:, None])[:, None, :])
    return torch.where(ok, new - old[:, None, :], 0.0)


def sum_rows_reference(deltas):
    """Fixed-order event-axis sum (row 0 first), as the kernel's reduce."""
    tot = torch.zeros(deltas.shape[:-1], dtype=deltas.dtype,
                      device=deltas.device)
    for el in range(deltas.shape[-1]):
        tot = tot + deltas[..., el]
    return tot


class _MutArgs(ctypes.Structure):
    """Mirror of csrc/mutscore.cu:MutArgs."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("Mf", "Sf", "Mb", "Sb", "i0f", "i1f", "i0r", "i1r")]
        + [("win", ctypes.c_void_p * 3)]
        + [(n, ctypes.c_void_p) for n in
           ("bpf", "bpb", "ev_region", "n0", "active")]
        + [("lik", ctypes.c_void_p * 4), ("model", ctypes.c_void_p * 6)]
        + [(n, ctypes.c_void_p) for n in GROUP_FIELDS]
        + [("deltas", ctypes.c_void_p), ("totals", ctypes.c_void_p)]
        + [(n, ctypes.c_int) for n in
           ("C1", "E", "W", "Ws", "Q1", "RS", "K", "P", "DM", "E_g", "G")]
        + [("lik_offset", ctypes.c_double), ("rpt", ctypes.c_int)])


_SIG = [ctypes.POINTER(_MutArgs), ctypes.c_void_p]
_SUM_SIG = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
MUTSCORE = Kernel(
    "mutscore", "poreseq_tpu/engine/tpu/pallas_mutscore.py:195 _kernel",
    {"psq_mutscore_f32": _SIG, "psq_mutscore_f64": _SIG,
     "psq_sum_rows_f32": _SUM_SIG, "psq_sum_rows_f64": _SUM_SIG})


def group_totals_cuda(batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf,
                      bpb, ev_region, gp, lik_offset, W, Ws, RS, K, P, DM,
                      E_g):
    """Launch csrc/mutscore.cu: (totals [G, P], deltas [G, P, E_g])."""
    return _launch_groups(True, batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r,
                          win, bpf, bpb, ev_region, gp, lik_offset, W, Ws,
                          RS, K, P, DM, E_g)


def group_deltas_cuda(*args):
    """Launch csrc/mutscore.cu's group kernel alone (group_totals_cuda's
    arguments): deltas [G, P, E_g], summed later by ``sum_rows``."""
    return _launch_groups(False, *args)[1]


def _launch_groups(with_totals, batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r,
                   win, bpf, bpb, ev_region, gp, lik_offset, W, Ws, RS, K, P,
                   DM, E_g):
    C1, E, _ = Mf.shape
    Q1 = win[0].shape[0]
    dev, dt = Mf.device, Mf.dtype
    G = gp["g_start"].shape[0]
    rpt = rows_per_thread(Ws, "group scorer")
    if not 1 <= E_g <= E:
        raise ValueError(f"group scorer: Ws={Ws}, E_g={E_g}, E={E}")
    for n, t in (("Mf", Mf), ("Sf", Sf), ("Mb", Mb), ("Sb", Sb)):
        check(n, t, dt, (C1, E, W), dev)
    for n, t in (("i0f", i0f), ("i1f", i1f), ("i0r", i0r), ("i1r", i1r)):
        check(n, t, torch.int32, (E, C1), dev)
    for n, t in zip(("win_m", "win_s", "win_l"), win):
        check(n, t, dt, (Q1, E, Ws), dev)
    for n, t in (("bpf", bpf), ("bpb", bpb)):
        check(n, t, dt, (C1, E), dev)
    check("ev_region", ev_region, torch.int32, (E,), dev)
    check("n0", batch.n0, torch.int32, (E,), dev)
    active = check("active", batch.active.to(torch.uint8), torch.uint8,
                   (E,), dev)
    lik = [check(n, getattr(batch, n), dt, (E,), dev) for n in
           ("lik_skip", "lik_stay", "lik_extend", "lik_insert")]
    model = [check(f, getattr(batch, f), dt, (E, 1024), dev)
             for f in MODEL_FIELDS]
    shapes = dict(g_start=(G,), g_startind=(G,), g_S=(G,), g_region=(G,),
                  g_evoff=(G,), s_mlen=(G, P), s_nst=(G, P),
                  s_win=(G, P, K), s_valid=(G, P))
    garr = {k: check(k, gp[k].to(torch.uint8) if k == "s_valid" else gp[k],
                     torch.uint8 if k == "s_valid" else torch.int32,
                     shapes[k], dev) for k in GROUP_FIELDS}
    deltas = torch.empty((G, P, E_g), dtype=dt, device=dev)
    totals = (torch.empty((G, P), dtype=dt, device=dev) if with_totals
              else None)
    args = _MutArgs(
        *[t.data_ptr() for t in (Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r)],
        (ctypes.c_void_p * 3)(*[t.data_ptr() for t in win]),
        *[t.data_ptr() for t in (bpf, bpb, ev_region, batch.n0, active)],
        (ctypes.c_void_p * 4)(*[t.data_ptr() for t in lik]),
        (ctypes.c_void_p * 6)(*[t.data_ptr() for t in model]),
        *[garr[k].data_ptr() for k in GROUP_FIELDS],
        deltas.data_ptr(), totals.data_ptr() if with_totals else None,
        C1, E, W, Ws, Q1, RS, K, P, DM, E_g, G, float(lik_offset), rpt)
    MUTSCORE.call(f"psq_mutscore_{dtype_suffix(dt)}", dev,
                  ctypes.byref(args), stream(dev))
    return totals, deltas


def sum_rows(deltas):
    """totals [G, P] = the fixed-order sum over the last axis of deltas
    [G, P, E_g]: the twin for a CPU tensor, csrc/mutscore.cu's
    sum_rows_kernel for a CUDA one."""
    if route(deltas) == "cpu":
        return sum_rows_reference(deltas)
    G, P, E_g = deltas.shape
    dev, dt = deltas.device, deltas.dtype
    check("deltas", deltas, dt, (G, P, E_g), dev)
    totals = torch.empty((G, P), dtype=dt, device=dev)
    MUTSCORE.call(f"psq_sum_rows_{dtype_suffix(dt)}", dev,
                  ptr(deltas), ptr(totals), G * P, E_g, stream(dev))
    return totals


def group_totals(batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb,
                 ev_region, gp, lik_offset, W, Ws, RS, K, P, DM, E_g):
    """Group scorer wrapper: totals [G, P] from the twin (CPU tensors) or
    the kernel (CUDA tensors)."""
    args = (batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb,
            ev_region, gp, lik_offset, W, Ws, RS, K, P, DM, E_g)
    if route(Mf, i0r, win[0], gp["g_start"]) == "cuda":
        return group_totals_cuda(*args)[0]
    return sum_rows_reference(group_deltas_reference(*args))


def group_deltas(batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb,
                 ev_region, gp, lik_offset, W, Ws, RS, K, P, DM, E_g):
    """Group scorer wrapper without the sum: deltas [G, P, E_g] from the
    twin (CPU tensors) or the group kernel (CUDA tensors)."""
    args = (batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb,
            ev_region, gp, lik_offset, W, Ws, RS, K, P, DM, E_g)
    if route(Mf, i0r, win[0], gp["g_start"]) == "cuda":
        return group_deltas_cuda(*args)
    return group_deltas_reference(*args)


def mesh_scoring_inputs(shards, bounds, i0r, i1r, ev_region, Ws: int):
    """Give every shard of ``align.both_dev_sharded`` its rows of the
    scoring geometry (host i0r/i1r [E, C+1]) and of the region ids
    (``ev_region`` [E]), and its scoring-band windows."""
    for (lo, hi), row in zip(bounds, shards):
        for dev, sh in row.items():
            sh["i0r"] = shard_rows(i0r, lo, hi, dev)
            sh["i1r"] = shard_rows(i1r, lo, hi, dev)
            sh["ev_region"] = shard_rows(ev_region, lo, hi, dev)
            b = sh["batch"]
            sh["win"] = build_windows(b.mean, b.stdv, b.lsr, sh["i0r"], Ws)


def group_totals_sharded(mesh, shards, bounds, gp, lik_offset, W, Ws, RS,
                         K, P, DM, E_g):
    """The group scorer on a mesh: totals [G, P] on the mesh's first device,
    equal bit for bit to ``group_totals`` on one device.

    The groups (host arrays ``gp`` of ``_pad_groups``) split into n_mut
    contiguous chunks.  Shard (i, j) runs the group kernel on 'ev' shard
    i's rows (``shards[i][device]``, as ``mesh_scoring_inputs`` left them)
    for chunk j: each group's row slice [s, s + E_g), s = g_evoff clamped
    to E - E_g as on one device, is cut to the shard's rows at width
    min(E_g, rows per shard).  No float is summed across shards: every
    (group, slot, row of the slice) delta is gathered to its place in a
    [G_j, P, E_g] buffer on chunk j's first device (each row lies in
    exactly one shard, whose cut slice covers it), and ``sum_rows`` adds
    the rows in order 0..E_g-1, as the single-device launch does."""
    n_ev, n_mut = mesh.n_ev, mesh.n_mut
    E = bounds[-1][1]
    E_loc = E // n_ev
    Eg_loc = min(E_g, E_loc)
    G = gp["g_start"].shape[0]
    fills = dict(g_region=-1, s_win=-1)
    g = {k: pad_axis(np.asarray(gp[k]), n_mut, fill=fills.get(k, 0))
         for k in GROUP_FIELDS}
    Gj = g["g_start"].shape[0] // n_mut
    start = np.clip(g["g_evoff"].astype(np.int64), 0, E - E_g)
    totals = []
    for j in range(n_mut):
        sel = slice(j * Gj, (j + 1) * Gj)
        rows = start[sel, None] + np.arange(E_g)              # [Gj, E_g]
        src = np.zeros((Gj, E_g), dtype=np.int64)
        home = mesh.devices[0][j]
        parts = []
        for i, (lo, hi) in enumerate(bounds):
            dev = mesh.devices[i][j]
            sh = shards[i][dev]
            off = np.clip(start[sel] - lo, 0, E_loc - Eg_loc)
            gp_d = {k: torch.as_tensor(
                off.astype(np.int32) if k == "g_evoff" else g[k][sel],
                device=dev) for k in GROUP_FIELDS}
            with mesh.on(i, [j]):
                parts.append(group_deltas(
                    sh["batch"], sh["Mf"], sh["Sf"], sh["Mb"], sh["Sb"],
                    sh["i0f"], sh["i1f"], sh["i0r"], sh["i1r"], sh["win"],
                    sh["bpf"], sh["bpb"], sh["ev_region"], gp_d, lik_offset,
                    W, Ws, RS, K, P, DM, Eg_loc).to(home))
            mine = (rows >= lo) & (rows < hi)
            src[mine] = (i * Eg_loc + rows - lo - off[:, None])[mine]
        idx = torch.as_tensor(src, device=home)[:, None, :]
        full = torch.gather(torch.cat(parts, dim=2), 2,
                            idx.expand(Gj, P, E_g)).contiguous()
        totals.append(sum_rows(full).to(mesh.first))
    return torch.cat(totals)[:G]


def group_launches(engine, datas, muts_list, participate,
                   host_geometry=None):
    """Realign the participating regions (forward + backward fills and the
    backtrace; events updated, ref_like deferred) and yield one
    (gp, idx_maps, args) per (K, D) class: the host group arrays, the map
    back to each region's mutation list, and the group scorer's arguments
    (``group_totals(*args)``, or ``group_totals_sharded(*args)`` on an
    engine with a mesh).

    host_geometry: take the post-backtrace scoring geometry from the host's
    ``limited_geometry`` (default: in f64, on a mesh and under
    PSQ_DEV_GEOM=0, as the JAX engine does) rather than from ``geom_body``
    on the device (f32 on one device)."""
    p = datas[0].params
    W = 2 * p.realign_width + 1
    Ws = 2 * min(p.scoring_width, p.realign_width) + 1
    RS = max(p.realign_width - p.scoring_width, 0)
    dt, dev, mesh = engine.dtype, engine.device, engine.mesh
    if host_geometry is None:
        host_geometry = (dt == torch.float64 or mesh is not None
                         or os.environ.get("PSQ_DEV_GEOM", "1") == "0")
    elif mesh is not None and not host_geometry:
        raise ValueError("group_launches: a mesh takes the host geometry")

    classes = _partition_classes(datas, muts_list, participate)
    ctx = engine._prepare_multi(datas, participate=participate)
    batch, arrays, n0 = ctx["batch"], ctx["arrays"], ctx["n0"]
    S_e, C, ev_region = ctx["S_e"], ctx["C"], ctx["ev_region"]

    fi = fill_geometry(arrays, ctx["ref_indexes"], S_e, C, p.realign_width)
    T = arrays["mean"].shape[1]
    if mesh is None:
        i0f = torch.as_tensor(fi["i0"], device=dev)
        i1f = torch.as_tensor(fi["i1"], device=dev)
        Mf, Sf, Mb, Sb, bpf, bpb, ral, rlk = both_dev(
            batch, torch.as_tensor(ctx["states2"], device=dev), i0f, i1f,
            torch.as_tensor(fi["is_pad"], device=dev), float(p.lik_offset),
            p.realign_width, T, int(C + 2 * T + 8))
    else:
        shards, ral, rlk = both_dev_sharded(
            mesh, batch, ctx["states2"], fi["i0"], fi["i1"], fi["is_pad"],
            float(p.lik_offset), p.realign_width, T, int(C + 2 * T + 8))

    # realigned events (ref_like read at the next sync point)
    ral_h = ral.to(torch.float64).cpu().numpy()
    at = 0
    for r, data in enumerate(datas):
        for ev in data.events:
            if participate[r] and arrays["active"][at]:
                ev.ref_align = place_full(ev, ral_h[at])
                engine._defer_rlk(ev, rlk, at)
            at += 1

    # post-backtrace scoring-band geometry (Alignment.cpp:131-132): on
    # device (f32 on one device) or host limited_geometry
    if not host_geometry:
        i0r, i1r = geom_body(ral, batch.n0,
                             torch.as_tensor(S_e.astype(np.int32),
                                             device=dev),
                             p.scoring_width, int(C))
    else:
        post_ris = [np.zeros(0)] * len(n0)
        at = 0
        for r, data in enumerate(datas):
            for ev in data.events:
                if participate[r]:
                    post_ris[at] = event_ref_indexes(ev)
                at += 1
        i0h, i1h = limited_geometry(post_ris, n0, S_e, C, p.scoring_width)
        i1h = np.minimum(i1h, i0h + (Ws - 1))
        if mesh is not None:
            mesh_scoring_inputs(shards, batch.bounds, i0h, i1h, ev_region,
                                Ws)
        else:
            i0r = torch.as_tensor(i0h, device=dev)
            i1r = torch.as_tensor(i1h, device=dev)
    if mesh is None:
        i1r = torch.minimum(i1r, i0r + (Ws - 1)).contiguous()
        win = build_windows(batch.mean, batch.stdv, batch.lsr, i0r, Ws)
        ev_region_d = torch.as_tensor(ev_region, device=dev)

    # each group's event rows: its region's contiguous rows
    ev_counts = np.bincount(ev_region[ev_region >= 0], minlength=len(datas))
    ev_offs = np.concatenate([[0], np.cumsum(ev_counts)[:-1]]).astype(
        np.int32)
    E_g = max([1] + [int(ev_counts[r]) for r in range(len(datas))
                     if participate[r]])

    for (K_c, D_c) in sorted(classes):
        parts, g_S_parts, g_region_parts, g_evoff_parts, idx_maps = \
            [], [], [], [], []
        for r, (muts_c, idx_c) in enumerate(classes[(K_c, D_c)]):
            if not muts_c:
                continue
            part = _build_groups(datas[r].sequence, muts_c, K_c)
            Gr = part["g_start"].shape[0]
            parts.append(part)
            g_S_parts.append(np.full(Gr, ctx["S_list"][r], np.int32))
            g_region_parts.append(np.full(Gr, r, np.int32))
            g_evoff_parts.append(np.full(Gr, ev_offs[r], np.int32))
            idx_maps.append(np.asarray(idx_c, dtype=np.int64))
        gp = _pad_groups(parts, g_S_parts, g_region_parts)
        gp["g_evoff"][: gp["G"]] = np.concatenate(g_evoff_parts)
        if mesh is not None:
            yield gp, idx_maps, (mesh, shards, batch.bounds, gp,
                                 float(p.lik_offset), W, Ws, RS, K_c,
                                 P_SLOTS, D_c, E_g)
            continue
        gp_d = {k: torch.as_tensor(gp[k], device=dev) for k in GROUP_FIELDS}
        args = (batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb,
                ev_region_d, gp_d, float(p.lik_offset), W, Ws, RS, K_c,
                P_SLOTS, D_c, E_g)
        yield gp, idx_maps, args


def score_mutations_multi(engine, datas, muts_list):
    """ScoreMutations for R regions: one forward + backward fill pair and
    one group-scorer launch per (K, D) class; groups carry their region id
    and only their region's event rows contribute.  Regions with no
    mutations (or no events) are skipped, their events untouched."""
    mutscores_list = [make_mutscores(muts) for muts in muts_list]
    participate = [bool(m) and bool(d.events)
                   for d, m in zip(datas, muts_list)]
    if not any(participate):
        return mutscores_list
    totals_of = group_totals if engine.mesh is None else group_totals_sharded
    for gp, idx_maps, args in group_launches(engine, datas, muts_list,
                                             participate):
        totals_h = totals_of(*args).to(torch.float64).cpu().numpy()
        for g in range(gp["G"]):
            r = int(gp["g_region"][g])
            im = idx_maps[int(gp["g_part"][g])]
            for t in range(P_SLOTS):
                mi = gp["s_idx"][g, t]
                if mi >= 0:
                    mutscores_list[r][int(im[mi])].score += totals_h[g, t]
    return mutscores_list
