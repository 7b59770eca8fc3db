"""1024-state Viterbi candidate generator (ViterbiMutate) in torch ops.

Counterpart of ``poreseq_tpu/engine/tpu/viterbi.py`` (spec
poreseq cpp/Viterbi.cpp:239-426).  The per-position transition max
over 1/2/3-base steps decomposes into grouped maxes of the 1024-state
vector (the predecessors of s after j steps are {(s>>2j) + k<<(10-2j)}), so
a position costs O(1024) work.  The sweep (csrc/viterbi_sweep.cu, one block
per region) and the stochastic backtrace (csrc/viterbi_sample.cu, one block
per region and candidate, after csrc/viterbi_gumbel.cu's noise for the call)
are hand kernels; their plain twins are Python loops over positions, batched
over regions (and candidates).  Every sum
over the states, in the twins and the kernels, is taken on one halving
tree (``halving_levels``), so the kernels can equal the twins bit for bit.

Randomness: the JAX package's own draws.  Candidate k's row i takes the
Gumbel noise of ``jax.random.categorical`` under the key fold_in(split(
PRNGKey(seed), nkeep)[k], i) (poreseq_tpu/engine/tpu/viterbi.py:310-333),
computed with JAX's threefry2x32 (``engine/prng.py``) in int64 tensor ops
in the twin and in uint32 arithmetic in the Gumbel kernel, so the sampled
candidates are the JAX package's: in f64 the same strings as TpuEngine's
(the uniforms are JAX's bit for bit; the noise is within an ulp of
max(|g|, 1) of XLA's, whose log differs from torch's now and then), in f32
the same up to near-ties of a draw.  The key depends on the
candidate and the row only, so every region of a batch draws the same
noise and a region's candidates do not depend on its batch (its slot, the
batch bucket or the padded row count), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..obs import span
from .._build import Kernel, check, dtype_suffix, ptr, route, stream
from ..core.events import getrefstates, update_refs
from ..core.sequence import next_state, state_base

from . import prng
from .dp import emission

# ---------------------------------------------------------------- host side


def _position_stats(events):
    """Per-(reference position, event) observation statistics, behavior-equal
    to walking getrefstates per position (Viterbi.cpp:269-349).  Returns
    (lvl [R, E], sd [R, E], valid [R, E]) for the retained positions."""
    E = len(events)
    infos = [update_refs(ev.ref_align) for ev in events]
    rmin = min(i[1] for i in infos)

    # bound the position range by the largest integral ref_index any event
    # can hit (NaN ref_index values of single-anchor events never match)
    def _ri_max(ri, re):
        m = ri[np.isfinite(ri)]
        return int(np.floor(m.max())) if len(m) else re

    rmax = max(max(i[2], _ri_max(i[0], i[2])) for i in infos)
    n_r = rmax - rmin + 1

    lvl = np.zeros((n_r, E))
    sd = np.zeros((n_r, E))
    valid = np.zeros((n_r, E), dtype=bool)
    spans = np.zeros((n_r, E), dtype=bool)

    for e, ev in enumerate(events):
        ri, rs, re = infos[e]
        ra = ev.ref_align
        spans[rs - rmin : re - rmin + 1, e] = True

        pos = np.nonzero(ra > 0)[0]
        vals = ra[pos].astype(np.int64)
        if len(vals) and not np.all(np.diff(vals) >= 0):
            # non-monotone seed alignment: the literal walk
            for r in range(rmin, rmax + 1):
                inds = getrefstates(ri, ra, r)
                if len(inds):
                    valid[r - rmin, e] = True
                    lvl[r - rmin, e] = ev.mean[inds].mean()
                    sd[r - rmin, e] = ev.stdv[inds].mean()
            continue

        intmask = np.nonzero((ri == np.floor(ri)) & (ri >= rmin)
                             & (ri <= rmax))[0]
        iv = ri[intmask].astype(np.int64) - rmin
        first_hit = np.full(n_r, len(ra), dtype=np.int64)
        np.minimum.at(first_hit, iv, intmask)
        hit = first_hit < len(ra)
        hr = np.nonzero(hit)[0]
        if len(hr) == 0:
            continue
        i = first_hit[hr]
        a = np.searchsorted(pos, i, side="right")
        b = np.searchsorted(vals, hr + rmin, side="right")
        b = np.maximum(a, b)
        cm = np.concatenate([[0.0], np.cumsum(ev.mean[pos])])
        cs = np.concatenate([[0.0], np.cumsum(ev.stdv[pos])])
        cnt = 1 + (b - a)
        lvl[hr, e] = (ev.mean[i] + cm[b] - cm[a]) / cnt
        sd[hr, e] = (ev.stdv[i] + cs[b] - cs[a]) / cnt
        valid[hr, e] = True

    nalhere = spans.sum(axis=1)
    nlik = valid.sum(axis=1)
    gap = np.nonzero((nalhere == 0) & (nlik == 0))[0]
    stop = int(gap[0]) if len(gap) else n_r
    keep = np.nonzero(nlik[:stop] > 0.2 * nalhere[:stop])[0]
    return lvl[keep], sd[keep], valid[keep]


def _build_T(skip_prob, stay_prob):
    """Dense transition matrix (Viterbi.cpp:134-169, nskip=4)."""
    T = np.zeros((1024, 1024))
    for curst in range(1024):
        sp = 0.25
        for j in range(1, 5):
            n = 1 << (2 * j)
            prev = (curst >> (2 * j)) + (np.arange(n) << (10 - 2 * j))
            np.add.at(T[curst], prev, sp)
            sp = sp * 0.25 * skip_prob
    T[np.arange(1024), np.arange(1024)] = stay_prob
    return T


def _states_to_seq(states: np.ndarray) -> str:
    """State path -> base string (Viterbi.cpp:171-237)."""
    seq = [state_base(int(states[0]), 0)]
    cur = int(states[0])
    for s in states[1:]:
        s = int(s)
        if s == cur:
            continue
        found = False
        for nskips in range(1, 5):
            shifted = (cur << (2 * nskips)) & 1023
            ind = s - shifted
            if (0 <= ind < (1 << (2 * nskips))
                    and next_state(cur, ind, nskips) == s):
                for j in range(1, nskips + 1):
                    seq.append(state_base(cur, j))
                cur = s
                found = True
                break
        if not found:
            cur = s
            seq.append(state_base(cur, 0))
    for j in range(1, 5):
        seq.append(state_base(cur, j))
    return "".join(seq)


def _b_bucket(b: int) -> int:
    for p in (1, 2, 4, 8, 16):
        if b <= p:
            return p
    return ((b + 15) // 16) * 16


# ------------------------------------------------------------ device side


def trim_counts(valid):
    """(nlik, nskip) [B, R] int64: the valid events of each row and how many
    of the worst the trim drops, floor(nlik / 4), none when that leaves
    fewer than 2 or nlik <= 1 (Viterbi.cpp:300-349)."""
    nlik = valid.sum(dim=2)
    nskip = torch.floor(nlik * 0.25).long()
    return nlik, torch.where((nskip > nlik - 2) | (nlik <= 1), 0, nskip)


def trimmed_mean(per, valid):
    """The trimmed mean over events of per [B, R, E, 1024] at the valid
    events valid [B, R, E]: the nskip smallest (value, event index) pairs
    dropped (of equal values the lower event index goes first), the rest
    summed in event index order and divided by max(nlik - nskip, 1).  The
    JAX package sorts and sums in XLA's order; this order is the one
    csrc/viterbi_obs.cu can follow, and it equals the JAX one in f64 within
    rounding.  The drop set comes from a stable sort over events with the
    invalid ones at +inf: each (region, row, state)'s first nskip sorted
    entries are its nskip smallest pairs (the emissions are finite)."""
    B, R, E, S = per.shape
    nlik, nskip = trim_counts(valid)
    key = torch.where(valid[..., None], per, torch.inf)
    order = torch.sort(key, dim=2, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        2, order, torch.arange(E, device=per.device).view(1, 1, E, 1)
        .expand(B, R, E, S))
    keep = valid[..., None] & (rank >= nskip[:, :, None, None])
    tot = torch.zeros((B, R, S), dtype=per.dtype, device=per.device)
    for e in range(E):
        tot = tot + torch.where(keep[:, :, e], per[:, :, e], 0.0)
    return tot / torch.clamp(nlik - nskip, min=1)[..., None]


def obs_emissions(lvl, sd, tabs):
    """Every (region, row, event, state) emission [B, R, E, 1024] of the
    observations: dp.emission with the stdv clamped to 1e-30, no offset.
    lvl/sd [B, R, E]; tabs [B, 6, E, 1024] model tables."""
    lm, ls, ll, sm, lam, llam = (tabs[:, t][:, None] for t in range(6))
    sdc = torch.clamp(sd[..., None], min=1e-30)
    return emission(lvl[..., None], sdc, torch.log(sdc), lm, ls, ll, sm,
                    lam, llam, 0.0)


def obs_multi_reference(lvl, sd, valid, tabs):
    """Plain twin of the observation kernel: per-state trimmed-mean
    observation log-likelihoods [B, R, 1024] (the emission + worst-25 %
    trim of Viterbi.cpp:300-349).  lvl/sd/valid [B, R, E]; tabs
    [B, 6, E, 1024] model tables."""
    return trimmed_mean(obs_emissions(lvl, sd, tabs), valid)


_OBS_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
VITERBI_OBS = Kernel(
    "viterbi_obs",
    "poreseq_tpu/engine/tpu/viterbi.py:109 _obs_device / :442 _obs_multi_fn",
    {"psq_viterbi_obs_f32": _OBS_SIG, "psq_viterbi_obs_f64": _OBS_SIG})
#: the observation kernel's instances (its C entry's path index) and the
#: events a region each takes at most (csrc/viterbi_obs.cu CAP and
#: CAP_WIDE): the tiled instance's register list of 32, the tiled64
#: instance's of 64, then the chunked instance, any count
OBS_PATHS = ((32, "tiled"), (64, "tiled64"), (None, "chunked"))


def obs_path(E: int) -> tuple[int, str]:
    """(index, name) of the observation kernel's instance for E_pad events:
    the first whose cap holds them."""
    return next((i, name) for i, (cap, name) in enumerate(OBS_PATHS)
                if cap is None or E <= cap)


def obs_multi_cuda(lvl, sd, valid, tabs, instance: str | None = None):
    """Launch csrc/viterbi_obs.cu: the twin's [B, R, 1024].  ``instance``
    names one of OBS_PATHS in place of obs_path's choice (one whose cap
    holds E)."""
    B, R, E = lvl.shape
    dev, dt = lvl.device, lvl.dtype
    check("lvl", lvl, dt, (B, R, E), dev)
    check("sd", sd, dt, (B, R, E), dev)
    check("valid", valid, torch.bool, (B, R, E), dev)
    check("tabs", tabs, dt, (B, 6, E, 1024), dev)
    if tabs.data_ptr() % 16:
        raise ValueError("tabs: must start on a 16-byte boundary (the "
                         "kernel stages it 16 bytes a copy)")
    if instance is None:
        path, name = obs_path(E)
    else:
        names = [n for _, n in OBS_PATHS]
        if instance not in names:
            raise ValueError(f"instance {instance!r} is none of {names}")
        path, name = names.index(instance), instance
        if OBS_PATHS[path][0] is not None and E > OBS_PATHS[path][0]:
            raise ValueError(f"instance {instance!r} takes at most "
                             f"{OBS_PATHS[path][0]} events, not {E}")
    obs = torch.empty((B, R, 1024), dtype=dt, device=dev)
    VITERBI_OBS.call(f"psq_viterbi_obs_{dtype_suffix(dt)}", dev, ptr(lvl),
                     ptr(sd), ptr(valid), ptr(tabs), ptr(obs), B, R, E, path,
                     stream(dev), instance=name)
    return obs


def obs_multi(lvl, sd, valid, tabs):
    """Observation wrapper: the twin for CPU tensors, the kernel for
    CUDA."""
    if route(lvl, sd, valid, tabs) == "cuda":
        return obs_multi_cuda(lvl, sd, valid, tabs)
    return obs_multi_reference(lvl, sd, valid, tabs)


def halving_levels(x, levels: int, op):
    """The halving tree over the last axis: level L maps x[..., :n] to
    op(x[..., :n/2], x[..., n/2:]).  Returns the results of levels
    1..levels.  Over the 1024 states, level 2j holds at c the reduction of
    the j-step predecessor group {c + k * (1024 >> 2j)} and level 10 the
    total: every sum of the sweep and the sampler is taken on this one tree,
    which the kernels evaluate in the same order."""
    out = []
    for _ in range(levels):
        h = x.shape[-1] // 2
        x = op(x[..., :h], x[..., h:])
        out.append(x)
    return out


def tree_total(x):
    """Sum over the last (1024-state) axis on the halving tree, kept as a
    trailing axis of 1."""
    return halving_levels(x, 10, torch.add)[-1]


def _spread(g, j: int):
    """A level-2j tree result back on the 1024 states: out[s] = g[s >> 2j]."""
    return torch.repeat_interleave(g, 1 << (2 * j), dim=-1)


def _group_argmax(V, j):
    """Predecessor state (first max) within each state's j-step group."""
    n = 1 << (2 * j)
    karg = torch.argmax(V.reshape(V.shape[0], n, 1024 >> (2 * j)), dim=1)
    base = torch.arange(1024, device=V.device) >> (2 * j)
    return base + (karg[:, base] << (10 - 2 * j))


def sweep_constants(skip_prob, stay_prob):
    """(lsp1, lsp2, lsp3, stay_lik, sp1, sp2, sp3, stay_prob): the sweep's
    Python-float constants, cast to the working type where they meet a
    tensor (Viterbi.cpp's j-step log and linear transition weights)."""
    skip_lik = float(np.log(skip_prob))
    l25 = float(np.log(0.25))
    sp2 = 0.25 * 0.25 * skip_prob
    return (l25, l25 + l25 + skip_lik, l25 + l25 + skip_lik + l25 + skip_lik,
            float(np.log(stay_prob)), 0.25, sp2, sp2 * 0.25 * skip_prob,
            float(stay_prob))


def viterbi_sweep_reference(obs, n_real, skip_prob, stay_prob,
                            need_bp=False):
    """Plain twin of the sweep kernel: the 1024-state recursion over
    positions, batched over regions: obs [B, R, 1024], n_real [B] (rows
    past a region's end pass the carry).  Returns (liks [B, 1024] at each
    region's last real row, fwds [B, R, 1024] normalized forward
    probabilities, bps [B, R, 1024] or None) — backpointers with the
    reference's priority j=1 < 2 < 3 < stay, computed on every row (a
    padded row's from the carried liks)."""
    B, R, _ = obs.shape
    dev, dt = obs.device, obs.dtype
    lsp1, lsp2, lsp3, stay_lik, sp1, sp2, sp3, stay_p = sweep_constants(
        skip_prob, stay_prob)
    liks = torch.zeros((B, 1024), dtype=dt, device=dev)
    fwd = torch.full((B, 1024), 1.0 / 1024.0, dtype=dt, device=dev)
    fwds = torch.empty((B, R, 1024), dtype=dt, device=dev)
    bps = (torch.empty((B, R, 1024), dtype=torch.long, device=dev)
           if need_bp else None)
    states = torch.arange(1024, device=dev)
    valid = torch.arange(R, device=dev)[None, :] < n_real[:, None]
    for t in range(R):
        ob = obs[:, t]
        gmax = halving_levels(liks, 6, torch.maximum)
        m = [_spread(gmax[2 * j - 1], j) + c
             for j, c in ((1, lsp1), (2, lsp2), (3, lsp3))]
        mstay = liks + stay_lik
        best = torch.maximum(torch.maximum(m[0], m[1]),
                             torch.maximum(m[2], mstay))
        newlik = ob + best
        if need_bp:
            bp = _group_argmax(liks, 1)
            cur = m[0]
            for j in (2, 3):
                upd = m[j - 1] > cur
                bp = torch.where(upd, _group_argmax(liks, j), bp)
                cur = torch.where(upd, m[j - 1], cur)
            bps[:, t] = torch.where(mstay > cur, states, bp)
        gsum = halving_levels(fwd, 6, torch.add)
        f = (_spread(sp1 * gsum[1], 1) + _spread(sp2 * gsum[3], 2)
             + _spread(sp3 * gsum[5], 3) + stay_p * fwd)
        f = f * torch.exp(ob)
        f = f / tree_total(f)
        v = valid[:, t][:, None]
        liks = torch.where(v, newlik, liks)
        fwd = torch.where(v, f, fwd)
        fwds[:, t] = fwd
    return liks, fwds, bps


_SWEEP_SIG = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
              + [ctypes.c_double] * 8 + [ctypes.c_void_p])
VITERBI_SWEEP = Kernel(
    "viterbi_sweep",
    "poreseq_tpu/engine/tpu/viterbi.py:471 _viterbi_sweep_multi",
    {"psq_viterbi_sweep_f32": _SWEEP_SIG, "psq_viterbi_sweep_f64": _SWEEP_SIG})


def viterbi_sweep_cuda(obs, n_real, skip_prob, stay_prob, need_bp=False):
    """Launch csrc/viterbi_sweep.cu: same outputs as the twin."""
    B, R, S = obs.shape
    dev, dt = obs.device, obs.dtype
    check("obs", obs, dt, (B, R, 1024), dev)
    check("n_real", n_real, torch.int64, (B,), dev)
    liks = torch.empty((B, 1024), dtype=dt, device=dev)
    fwds = torch.empty((B, R, 1024), dtype=dt, device=dev)
    bps = (torch.empty((B, R, 1024), dtype=torch.long, device=dev)
           if need_bp else None)
    VITERBI_SWEEP.call(f"psq_viterbi_sweep_{dtype_suffix(dt)}", dev,
                       ptr(obs), ptr(n_real), ptr(liks), ptr(fwds),
                       ptr(bps) if need_bp else None, B, R,
                       *sweep_constants(skip_prob, stay_prob), stream(dev))
    return liks, fwds, bps


def viterbi_sweep(obs, n_real, skip_prob, stay_prob, need_bp=False):
    """Sweep wrapper: the twin for CPU tensors, the kernel for CUDA."""
    if route(obs, n_real) == "cuda":
        return viterbi_sweep_cuda(obs, n_real, skip_prob, stay_prob, need_bp)
    return viterbi_sweep_reference(obs, n_real, skip_prob, stay_prob,
                                   need_bp)


# sample_paths_reference makes the noise this many rows at a time
_DRAW_ROWS = 64


def gumbel_reference(seed: int, nkeep: int, rows, dtype):
    """The sampler's Gumbel noise [nkeep, n_rows, 1024] (plain twin of
    csrc/viterbi_gumbel.cu): g[k, r, s] is state s of
    ``jax.random.gumbel(fold_in(split(PRNGKey(seed), nkeep)[k], i),
    (1024,), dtype)`` for the row index i = rows[r] (rows int64)."""
    k0, k1 = prng.split(prng.prng_key(seed), nkeep, rows.device)
    a, b = prng.fold_in((k0[:, None], k1[:, None]), rows[None, :])
    return prng.gumbel((a[..., None], b[..., None]), 1024, dtype)


def transition_index(cur, p):
    """Where T[cur, p] (``_build_T``) sits in the sampler's 17-value table:
    16 on the diagonal, else the mask of the steps j = 1..4 whose
    predecessor set of cur holds p, bit j - 1 set when
    (p & (4^(5-j) - 1)) == cur >> 2j (T sums the j-step weights in j
    order over the set bits).  NumPy integer arrays, broadcast."""
    cur, p = np.asarray(cur), np.asarray(p)
    m = np.zeros(np.broadcast(cur, p).shape, dtype=np.int64)
    for j in range(1, 5):
        m |= ((p & ((1 << (10 - 2 * j)) - 1)) == (cur >> (2 * j))) << (j - 1)
    return np.where(p == cur, 16, m)


@functools.lru_cache(maxsize=64)
def transition_table(skip_prob: float, stay_prob: float):
    """The sampler kernel's 17 values of ``_build_T(skip_prob, stay_prob)``
    in f64, made as it makes them: entry m < 16 sums the j-step weights
    0.25 (0.25 skip_prob)^(j-1) of the set bits j - 1 of m in j order,
    entry 16 is stay_prob; T[cur, p] == table[transition_index(cur, p)]."""
    sp, tab = [], []
    w = 0.25
    for _ in range(4):
        sp.append(w)
        w = w * 0.25 * skip_prob
    for m in range(16):
        t = 0.0
        for j in range(4):
            if m >> j & 1:
                t += sp[j]
        tab.append(t)
    return tuple(tab) + (float(stay_prob),)


def transition_matrix(skip_prob, stay_prob, dtype, device):
    """T [1024, 1024] (``_build_T``) of ``dtype`` on ``device``: the
    twin's operand."""
    return torch.as_tensor(_build_T(skip_prob, stay_prob), dtype=dtype,
                           device=device)


def sample_paths_reference(T, fwds, valid_rows, startst, attens, seed: int):
    """Plain twin of the sampler kernel, the stochastic backtraces
    (Viterbi.cpp:403-423): for every region b and candidate k, path[R-1] =
    startst[b] and path[i-1] is drawn with probability proportional to
    T[path[i]] * fwds[b, i]^atten[k], normalized by its tree total
    (Gumbel-max over log-probabilities, the form jax.random.categorical
    takes, with the noise of candidate k's row key that every region
    shares, ``gumbel_reference``; the first index wins a tie).  Rows past a
    region's end keep the start state.  Returns [B, nkeep, R]."""
    B, R, _ = fwds.shape
    nk = attens.shape[0]
    dev, dt = fwds.device, fwds.dtype
    cur = startst[:, None].expand(B, nk).clone()
    paths = torch.empty((B, nk, R), dtype=torch.long, device=dev)
    gumbel = lo = None
    for i in range(R - 1, -1, -1):
        if gumbel is None or i < lo:
            lo = max(i + 1 - _DRAW_ROWS, 0)
            gumbel = gumbel_reference(seed, nk, torch.arange(
                lo, i + 1, dtype=torch.int64, device=dev), dt)
        paths[:, :, i] = cur
        nxt = torch.argmax(draw_scores(T, fwds[:, i], cur, attens,
                                       gumbel[:, i - lo]), dim=2)
        cur = torch.where(valid_rows[:, i][:, None], nxt, cur)
    return paths


def draw_scores(T, fwd_row, cur, attens, gumbel_row):
    """One sampler row's scores [B, nk, 1024], whose first argmax is the
    draw: log(probs + 1e-300) + gumbel with probs = T[cur] * fwd_row^atten
    over its tree total (in f32 the constant casts to 0, as the kernel's
    does).  fwd_row [B, 1024], cur [B, nk], gumbel_row [nk, 1024]."""
    probs = T[cur] * fwd_row[:, None, :] ** attens[None, :, None]
    probs = probs / tree_total(probs)
    return torch.log(probs + 1e-300) + gumbel_row[None]


_SAMPLE_SIG = ([ctypes.POINTER(ctypes.c_double)] + [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
VITERBI_SAMPLE = Kernel(
    "viterbi_sample",
    "poreseq_tpu/engine/tpu/viterbi.py:320 _backtrace_one",
    {"psq_viterbi_sample_f32": _SAMPLE_SIG,
     "psq_viterbi_sample_f64": _SAMPLE_SIG})
_GUMBEL_SIG = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_uint64,
                                                        ctypes.c_void_p]
VITERBI_GUMBEL = Kernel(
    "viterbi_gumbel",
    "poreseq_tpu/engine/tpu/viterbi.py:333 _backtrace_one "
    "(jax.random.categorical's Gumbel noise)",
    {"psq_viterbi_gumbel_f32": _GUMBEL_SIG,
     "psq_viterbi_gumbel_f64": _GUMBEL_SIG})


def gumbel_cuda(seed: int, nkeep: int, R: int, dtype, device):
    """Launch csrc/viterbi_gumbel.cu: ``gumbel_reference`` over rows
    0..R-1, [nkeep, R, 1024]."""
    gum = torch.empty((nkeep, R, 1024), dtype=dtype, device=device)
    VITERBI_GUMBEL.call(f"psq_viterbi_gumbel_{dtype_suffix(dtype)}",
                        gum.device, ptr(gum), nkeep, R,
                        seed & 0xFFFFFFFFFFFFFFFF,
                        stream(gum.device))
    return gum


def sample_paths_cuda(fwds, valid_rows, startst, attens, skip_prob,
                      stay_prob, seed: int):
    """Launch csrc/viterbi_gumbel.cu for every candidate and row, then
    csrc/viterbi_sample.cu: the twin's paths for T = _build_T(skip_prob,
    stay_prob).  The chains read T's 17 distinct values
    (``transition_table``), passed by value."""
    B, R, _ = fwds.shape
    nk = attens.shape[0]
    dev, dt = fwds.device, fwds.dtype
    check("fwds", fwds, dt, (B, R, 1024), dev)
    check("valid_rows", valid_rows, torch.bool, (B, R), dev)
    check("startst", startst, torch.int64, (B,), dev)
    check("attens", attens, dt, (nk,), dev)
    paths = torch.empty((B, nk, R), dtype=torch.long, device=dev)
    gum = gumbel_cuda(seed, nk, R, dt, dev)
    tab = (ctypes.c_double * 17)(*transition_table(float(skip_prob),
                                                   float(stay_prob)))
    VITERBI_SAMPLE.call(f"psq_viterbi_sample_{dtype_suffix(dt)}", dev,
                        tab, ptr(fwds), ptr(gum), ptr(valid_rows),
                        ptr(startst), ptr(attens), ptr(paths), B, nk, R,
                        stream(dev))
    return paths


def sample_paths(fwds, valid_rows, startst, attens, skip_prob, stay_prob,
                 seed: int):
    """Sampler wrapper: the twin (on ``transition_matrix``) for CPU
    tensors, the kernels for CUDA."""
    if route(fwds, valid_rows, startst, attens) == "cuda":
        return sample_paths_cuda(fwds, valid_rows, startst, attens,
                                 skip_prob, stay_prob, seed)
    T = transition_matrix(skip_prob, stay_prob, fwds.dtype, fwds.device)
    return sample_paths_reference(T, fwds, valid_rows, startst, attens, seed)


def _model_tabs(evs, E_pad):
    """[6, E_pad, 1024] model tables; padded events keep finite emissions."""
    tabs = np.zeros((6, E_pad, 1024))
    tabs[1] = tabs[3] = tabs[4] = 1.0
    for e, ev in enumerate(evs):
        m, d = ev.model, ev.model.derived()
        tabs[:, e] = (m.level_mean, m.level_stdv, d["log_lev"], m.sd_mean,
                      d["sd_lambda"], d["log_lambda"])
    return tabs


def viterbi_mutate_multi(events_lists, nkeep, skip_prob, stay_prob, mut_min,
                         mut_max, device, dtype, seed: int = 0):
    """ViterbiMutate for R regions in one batched sweep: per region, nkeep
    candidate strings (nkeep=0: the one deterministic Viterbi path).
    Regions with no events get []; nkeep=0 runs each region on its own, as
    the JAX package does, so padding never enters its observations."""
    B = len(events_lists)
    if nkeep == 0 and B > 1:
        return [viterbi_mutate_multi([evs], 0, skip_prob, stay_prob, mut_min,
                                     mut_max, device, dtype, seed)[0]
                for evs in events_lists]
    out = [[] for _ in range(B)]
    act, obs, n_real_d = sweep_inputs(events_lists, device, dtype)
    if not act:
        return out
    liks, fwds, bps = viterbi_sweep(obs, n_real_d, skip_prob, stay_prob,
                                    need_bp=nkeep == 0)

    if nkeep == 0:
        with span("psq.viterbi.wait"):
            bps_h = bps.cpu().numpy()
            start_h = torch.argmax(liks, dim=1).cpu().numpy()
            n_real = n_real_d.cpu().numpy()
        for bp, b in enumerate(act):
            n = int(n_real[bp])
            states = np.zeros(n, dtype=np.int64)
            cur = int(start_h[bp])
            for i in range(n - 1, -1, -1):
                states[i] = cur
                cur = int(bps_h[bp, i, cur])
            out[b] = [_states_to_seq(states)]
        return out

    paths = sample_paths(*sample_inputs(liks, fwds, n_real_d, nkeep, mut_min,
                                        mut_max), skip_prob, stay_prob, seed)
    with span("psq.viterbi.wait"):
        paths = paths.cpu().numpy()
        n_real = n_real_d.cpu().numpy()
    for bp, b in enumerate(act):
        R_b = int(n_real[bp])
        out[b] = [_states_to_seq(paths[bp, k, :R_b]) for k in range(nkeep)]
    return out


def sweep_inputs(events_lists, device, dtype):
    """The sweep's operands for a batch of regions: (act, obs [Bp, R_pad,
    1024], n_real [Bp] int64), act the indexes of the regions with retained
    positions, in slot order ([] and None, None when none has any); rows
    are padded to a multiple of 64 and regions to a bucket."""
    act, ops, n_real = obs_inputs(events_lists, device, dtype)
    return act, (obs_multi(*ops) if act else None), n_real


def obs_inputs(events_lists, device, dtype):
    """The observation kernel's operands for a batch of regions: (act,
    (lvl, sd, valid [Bp, R_pad, E_pad], tabs [Bp, 6, E_pad, 1024]), n_real
    [Bp] int64), as sweep_inputs describes them (None, None when no region
    has a retained position); E_pad is the batch's largest event count."""
    stats = []
    for evs in events_lists:
        st = _position_stats(evs) if evs else None
        stats.append((*st, evs) if st is not None and len(st[0]) else None)
    act = [b for b in range(len(events_lists)) if stats[b] is not None]
    if not act:
        return act, None, None

    R_pad = max(((len(stats[b][0]) + 63) // 64) * 64 for b in act)
    E_pad = max(len(stats[b][3]) for b in act)
    Bp = _b_bucket(len(act))
    lvl_a = np.zeros((Bp, R_pad, E_pad))
    sd_a = np.zeros((Bp, R_pad, E_pad))
    valid_a = np.zeros((Bp, R_pad, E_pad), dtype=bool)
    tabs_a = np.stack([_model_tabs([], E_pad)] * Bp)
    n_real = np.zeros(Bp, dtype=np.int64)
    for bp, b in enumerate(act):
        lvl, sd, valid, evs = stats[b]
        R_b, E_b = lvl.shape
        lvl_a[bp, :R_b, :E_b] = lvl
        sd_a[bp, :R_b, :E_b] = sd
        valid_a[bp, :R_b, :E_b] = valid
        n_real[bp] = R_b
        tabs_a[bp] = _model_tabs(evs, E_pad)

    t = lambda x, d=dtype: torch.as_tensor(x, dtype=d, device=device)
    return (act, (t(lvl_a), t(sd_a), t(valid_a, torch.bool), t(tabs_a)),
            t(n_real, torch.long))


def sample_inputs(liks, fwds, n_real, nkeep, mut_min, mut_max):
    """The sampler's operands after a sweep: (fwds with 1/1024 on the rows
    past each region's end, valid_rows [B, R], startst [B] (each region's
    best final state), attens [nkeep])."""
    dev, dt = fwds.device, fwds.dtype
    attens = torch.tensor([mut_min + (mut_max - mut_min) * k / float(nkeep)
                           for k in range(nkeep)], dtype=dt, device=dev)
    valid_rows = (torch.arange(fwds.shape[1], device=dev)[None, :]
                  < n_real[:, None])
    fwds = torch.where(valid_rows[..., None], fwds, 1.0 / 1024.0)
    return fwds, valid_rows, torch.argmax(liks, dim=1), attens
