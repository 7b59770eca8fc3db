"""Banded pair-HMM dynamic programming: types, emission and the plain fill.

Torch counterpart of ``poreseq_tpu/engine/tpu/dp.py`` (reference recurrence
poreseq cpp/Alignment.cpp:111-444).  ``fill_reference`` is the
plain twin of ``dp.make_fill``: a Python loop over band columns, vectorized
over events and band rows.  It is what ``engine.fill.get_fill`` runs on CPU
tensors; on CUDA tensors the same columns come from the hand kernel in
``csrc/fill.cu``, which evaluates the same expression tree.

Per column the in-column (M, S) chain is the max-plus linear recurrence

    v[r] = A[r] (x) v[r-1]  (+)  u[r],     v = (M, S)
    A[r] = [[max(lik_insert, e+lik_stay), e+lik_extend],
            [e+lik_stay,                  e+lik_extend]]
    u[r] = (D[r], floor[r])

solved with the combine tree of jax.lax.associative_scan (the kernel uses
the same tree, so kernel, twin and the JAX fill round alike).  The backward fill runs in forward event
coordinates (i = n0+1-i_b): it reads the previous (q+1) column at i and
i+1 and chains from high rows down.

Data windows are indexed directly: row r of column q reads level
i0[q]+r-1 of mean/stdv and of the reversed log-stdv (forward, the
Alignment.cpp:171-172 quirk) or the plain log-stdv (backward), with pad
values 0/1/0 outside the event.  Under the band invariants of
``pack.limited_geometry`` (starts advance by 0..DMAX per column, suffix-only
frozen padding columns) these are exactly the values the JAX package's
sliding windows (``dp.device_window_inputs``) carry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LOG2PI = float(np.log(2.0 * np.pi))

# move codes (Alignment.cpp:19-28)
SKIP, MATCH, INSERT, IGNORE, STAY, EXTEND, IMPLICIT = 0, 1, 2, 3, 4, 5, 255

# maximum band-start advance per column enforced by the host geometry
DMAX = 8


def neg_big(dtype: torch.dtype) -> float:
    """Finite -inf sentinel: -1e300 in f64 (the reference's, AlignUtil.h:20),
    -1e30 in f32, so sums of sentinels stay finite."""
    return -1e300 if dtype == torch.float64 else -1e30


class EventBatch(NamedTuple):
    """Padded per-event data, levels along axis 1 (length T)."""

    mean: torch.Tensor        # [E, T]
    stdv: torch.Tensor        # [E, T]
    lsd: torch.Tensor         # [E, T]  log(stdv)                (backward)
    lsr: torch.Tensor         # [E, T]  log_stdv[n0-1-t] reversed (forward)
    n0: torch.Tensor          # [E] int32 level counts
    active: torch.Tensor      # [E] bool: has a seed alignment
    lev_mean: torch.Tensor    # [E, 1024]
    lev_stdv: torch.Tensor
    log_lev: torch.Tensor
    sd_mean: torch.Tensor
    sd_lambda: torch.Tensor
    log_lambda: torch.Tensor
    lik_skip: torch.Tensor    # [E]
    lik_stay: torch.Tensor
    lik_extend: torch.Tensor
    lik_insert: torch.Tensor


MODEL_FIELDS = ("lev_mean", "lev_stdv", "log_lev", "sd_mean", "sd_lambda",
                "log_lambda")


class FillResult(NamedTuple):
    M: torch.Tensor        # [C, E, W] main lattice (stacked by column q-1)
    S: torch.Tensor        # [C, E, W] stay lattice
    steps_m: torch.Tensor  # [C, E, W] uint8 ([C, E, 0] without steps)
    steps_s: torch.Tensor  # [C, E, W] uint8
    i0: torch.Tensor       # [E, C+1] int32 band starts (col 0 = blank)
    i1: torch.Tensor       # [E, C+1]
    best: torch.Tensor     # [E] running max score
    best_i: torch.Tensor   # [E] int32
    best_j: torch.Tensor   # [E] int32
    best_pfx: torch.Tensor  # [C, E] per-column prefix max (suffix max for
    #                         the backward fill)


def emission(mean_v, stdv_v, logx_v, lm, ls, ll, sm, lam, llam, lik_offset):
    """e = lognormpdf(mean; level) + logigpdf(stdv; sd) + lik_offset
    (Alignment.cpp:167-174 / AlignUtil.h:34-53)."""
    d1 = (mean_v - lm) / ls
    ln = -0.5 * (d1 * d1 + LOG2PI) - ll
    d2 = (stdv_v - sm) / sm
    lig = 0.5 * (llam - 3.0 * logx_v - LOG2PI - d2 * d2 * lam / stdv_v)
    return ln + lig + lik_offset


def _mp_combine(lhs, rhs):
    """Max-plus combine of stacked elements [6, ..., n], rows (a11, a12,
    a21, a22, u1, u2): rhs after lhs, a = r (x) l, u = max(r (x) lu, ru).
    Every entry is a max over the same sums as the element-wise form
    (r11 + l11, r12 + l21, ...), and max is exact, so the order of the
    maxima does not change a bit."""
    sh = lhs.shape[1:]
    lA = lhs[:4].reshape(2, 2, *sh)                    # [k, j]
    rA = rhs[:4].reshape(2, 2, *sh)                    # [i, k]
    A = (rA[:, :, None] + lA[None]).amax(dim=1)        # [i, j]
    u = torch.maximum((rA + lhs[4:][None]).amax(dim=1), rhs[4:])
    return torch.cat([A.reshape(4, *sh), u])


def _assoc_scan(elems):
    """Inclusive max-plus scan over the last axis of stacked elements
    [6, ..., n] with the combine tree of jax.lax.associative_scan: combine
    adjacent pairs, scan the pairs recursively, then fill in the even
    elements.  Using JAX's tree keeps the rounding, and so the backpointer
    tie-breaks, identical to the JAX package's fill in f64."""
    n = elems.shape[-1]
    if n < 2:
        return elems
    odd = _assoc_scan(_mp_combine(elems[..., 0:n - 1:2], elems[..., 1::2]))
    lhs = odd[..., :-1] if n % 2 == 0 else odd
    even = torch.cat([elems[..., :1],
                      _mp_combine(lhs, elems[..., 2::2])], dim=-1)
    out = torch.empty_like(elems)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def column_solve(D, a_stay, a_ext, lik_insert, floor0, cut, nb: float,
                 reverse: bool = False):
    """Solve one band column's (M, S): the max-plus linear scan over the
    band axis (last).  ``cut`` is True where a row has NO within-column
    predecessor; floor0 is the stay-lattice floor.  reverse=True chains from
    the high rows downward (backward fill)."""
    a11 = torch.where(cut, nb, torch.maximum(lik_insert, a_stay))
    a12 = torch.where(cut, nb, a_ext)
    a21 = torch.where(cut, nb, a_stay)
    a22 = torch.where(cut, nb, a_ext)
    elems = torch.stack(torch.broadcast_tensors(a11, a12, a21, a22, D,
                                                floor0))
    if reverse:
        elems = torch.flip(elems, [-1])
    res = _assoc_scan(elems)
    M, S = res[4], res[5]
    if reverse:
        M, S = torch.flip(M, [-1]), torch.flip(S, [-1])
    return M, S


def window(x, s, out_w: int):
    """out[..., r] = x[..., r + s] for r < out_w, 0 outside x's rows; s is
    an integer tensor of x's leading shape (a per-row band shift)."""
    W = x.shape[-1]
    idx = s[..., None] + torch.arange(out_w, device=x.device)
    ok = (idx >= 0) & (idx < W)
    v = torch.gather(x, -1, idx.clamp(0, W - 1))
    return torch.where(ok, v, 0.0)


def level_windows(mean, stdv, lsx, i0, width: int):
    """Data windows [E, Q, width] for band columns starting at i0 [E, Q]:
    row r reads level i0+r-1 of mean / stdv / lsx (the log-stdv the fill
    direction uses), with pad values 0 / 1 / 0 outside the event."""
    E, T = mean.shape
    idx = i0[:, :, None].long() - 1 + torch.arange(width, device=i0.device)
    ok = (idx >= 0) & (idx < T)
    idc = idx.clamp(0, T - 1).reshape(E, -1)
    return tuple(torch.where(ok, torch.gather(src, 1, idc).reshape(idx.shape),
                             pv)
                 for src, pv in ((mean, 0.0), (stdv, 1.0), (lsx, 0.0)))


def fill_reference(batch: EventBatch, states, i0, i1, is_pad, lik_offset,
                   backward: bool, W: int, need_steps: bool = True):
    """Plain twin of the fill kernel: per-column raw outputs
    (M, S, steps_m, steps_s [C, E, W], cmax [C, E], carg [C, E] int32).

    states [C, E] int32 (-1 past each event's sequence), i0/i1 [E, C+1]
    int32 rate-limited geometry (col 0 = blank), is_pad [C, E] bool
    (suffix-only per event; the carry passes through padding columns)."""
    dtype = batch.mean.dtype
    dev = batch.mean.device
    C, E = states.shape
    nb = neg_big(dtype)
    rows = torch.arange(W, device=dev)
    stc = states.long().clamp(0, 1023)
    model = [torch.gather(getattr(batch, f), 1, stc.T).T          # [C, E]
             for f in MODEL_FIELDS]
    lik_skip, lik_stay, lik_extend, lik_insert = (
        x[:, None] for x in (batch.lik_skip, batch.lik_stay,
                             batch.lik_extend, batch.lik_insert))
    active = batch.active[:, None]

    M_out = torch.zeros((C, E, W), dtype=dtype, device=dev)
    S_out = torch.zeros((C, E, W), dtype=dtype, device=dev)
    sw = W if need_steps else 0
    sm_out = torch.zeros((C, E, sw), dtype=torch.uint8, device=dev)
    ss_out = torch.zeros((C, E, sw), dtype=torch.uint8, device=dev)
    cmax_out = torch.full((C, E), nb, dtype=dtype, device=dev)
    carg_out = torch.zeros((C, E), dtype=torch.int32, device=dev)

    prevM = torch.zeros((E, W), dtype=dtype, device=dev)
    prevO = torch.zeros((E, W), dtype=dtype, device=dev)
    p0 = torch.zeros(E, dtype=torch.long, device=dev)
    p1 = batch.n0.long().clone()
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    for c in (range(C - 1, -1, -1) if backward else range(C)):
        pad = is_pad[c][:, None]
        i0c = i0[:, c + 1].long()
        i1c = i1[:, c + 1].long()
        i = i0c[:, None] + rows
        in_band = i <= i1c[:, None]
        mean_v, stdv_v, lsx_v = (w[:, 0] for w in level_windows(
            batch.mean, batch.stdv, batch.lsd if backward else batch.lsr,
            i0c[:, None], W))
        lm, ls, ll, sm, lam, llam = (m[c][:, None] for m in model)
        e = emission(mean_v, stdv_v, lsx_v, lm, ls, ll, sm, lam, llam,
                     lik_offset).to(dtype)
        e = torch.where(in_band, e, 0.0)
        live = in_band & (states[c] >= 0)[:, None] & active

        dv = i0c - p0
        valid_i = (i >= p0[:, None]) & (i <= p1[:, None])
        if backward:
            pm_i = window(prevM, dv.clamp(-DMAX, 0), W)
            pm_d = window(prevM, (dv + 1).clamp(-DMAX + 1, 1), W)
            pobs_d = window(prevO, (dv + 1).clamp(-DMAX + 1, 1), W)
            valid_ul = (i >= p0[:, None]) & (i < p1[:, None])
            match_c = torch.where(valid_ul, pm_d + pobs_d, 0.0)
        else:
            pm_i = window(prevM, dv.clamp(0, DMAX), W)
            pm_d = window(prevM, (dv - 1).clamp(-1, DMAX - 1), W)
            valid_ul = (i > p0[:, None]) & (i <= p1[:, None])
            match_c = torch.where(valid_ul, pm_d, 0.0) + e
        skip_c = torch.where(valid_i, pm_i, 0.0) + lik_skip
        ignore_c = torch.where(valid_ul, pm_d + lik_insert, 0.0)
        D = torch.maximum(torch.clamp(skip_c, min=0.0),
                          torch.maximum(match_c, ignore_c))

        if backward:
            e_src = window(e, torch.ones_like(i0c), W)
            cut = i >= i1c[:, None]
            floor0 = torch.where(i == i1c[:, None], nb, zero)
        else:
            e_src = e
            cut = (rows == 0).expand(E, W)
            floor0 = torch.where(cut, nb, zero)
        a_stay = e_src + lik_stay
        a_ext = e_src + lik_extend
        M, S = column_solve(D, a_stay, a_ext, lik_insert, floor0, cut, nb,
                            reverse=backward)
        M = torch.where(live, M, 0.0)
        S = torch.where(live, S, 0.0)
        e_out = torch.where(live, e, 0.0)

        if need_steps:
            # candidate walk, strict >, order 0..3, then the stay override
            Mm1 = window(M, -torch.ones_like(i0c), W)
            Sm1 = window(S, -torch.ones_like(i0c), W)
            nfirst = rows > 0
            ins_c = torch.where(nfirst, Mm1 + lik_insert, 0.0)
            s4 = torch.where(nfirst, Mm1 + e_src + lik_stay, nb)
            s5 = torch.where(nfirst, Sm1 + e_src + lik_extend, nb)
            val = torch.zeros_like(M)
            stp = torch.zeros(M.shape, dtype=torch.uint8, device=dev)
            for cand, code in (
                    (skip_c, torch.where(valid_i, u8(SKIP), u8(IMPLICIT))),
                    (match_c, torch.where(valid_ul, u8(MATCH), u8(IMPLICIT))),
                    (ins_c, u8(INSERT)), (ignore_c, u8(IGNORE))):
                upd = cand > val
                val = torch.where(upd, cand, val)
                stp = torch.where(upd, code, stp)
            stp = torch.where(S > val, u8(STAY), stp)
            sval = torch.where(rows == 0, nb, zero).expand(E, W)
            upd = s4 > sval
            sval = torch.where(upd, s4, sval)
            sstp = torch.where(upd, u8(STAY), u8(0))
            sstp = torch.where(s5 > sval, u8(EXTEND), sstp)
            keep = live & ~pad
            sm_out[c] = torch.where(keep, stp, u8(0))
            ss_out[c] = torch.where(keep, sstp, u8(0))

        Mmask = torch.where(live & ~pad, M, nb)
        cmax_out[c] = Mmask.max(dim=1).values
        carg_out[c] = Mmask.argmax(dim=1).to(torch.int32)
        M_out[c] = torch.where(pad, 0.0, M)
        S_out[c] = torch.where(pad, 0.0, S)

        prevM = torch.where(pad, prevM, M)
        prevO = torch.where(pad, prevO, e_out)
        p0 = torch.where(pad[:, 0], p0, i0c)
        p1 = torch.where(pad[:, 0], p1, i1c)
    return M_out, S_out, sm_out, ss_out, cmax_out, carg_out


def finish_fill(M, S, steps_m, steps_s, cmax, carg, i0, i1,
                backward: bool) -> FillResult:
    """Running-best bookkeeping from per-column (cmax, first argmax): the
    strict-> running update of the reference (Alignment.cpp:270) in
    processing order, as pallas_fill.py:494-511 derives it."""
    C, E = cmax.shape
    if backward:
        pfx = torch.flip(torch.cummax(torch.flip(cmax, [0]), 0).values, [0])
    else:
        pfx = torch.cummax(cmax, 0).values
    best_pfx = torch.clamp(pfx, min=0.0)
    best = best_pfx[0] if backward else best_pfx[-1]
    hit = (cmax >= best[None, :]) & (best[None, :] > 0.0)
    hit_i = hit.to(torch.int8)
    if backward:
        c_star = (C - 1) - torch.argmax(torch.flip(hit_i, [0]), dim=0)
    else:
        c_star = torch.argmax(hit_i, dim=0)
    any_hit = hit.any(dim=0)
    ev = torch.arange(E, device=cmax.device)
    carg_star = carg[c_star, ev].long()
    i0_star = i0[ev, c_star + 1].long()
    best_i = torch.where(any_hit, i0_star + carg_star, 0).to(torch.int32)
    best_j = torch.where(any_hit, c_star + 1, 0).to(torch.int32)
    return FillResult(M, S, steps_m, steps_s, i0, i1, best, best_i, best_j,
                      best_pfx)
