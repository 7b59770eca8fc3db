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
plain twins ``geom_reference`` and ``windows_reference``.  The host side
reads each call's mutations once into columns (``_mut_columns``) and builds
the classes, groups, windows and the score write-back from them with NumPy;
``_partition_classes``, ``_mut_windows_fast``, ``_build_groups`` and
``_pad_groups`` give what the JAX module's host helpers of those names give.
"""

from __future__ import annotations

import ctypes
import os
from types import SimpleNamespace

import numpy as np
import torch

from .. import obs
from .._build import Kernel, check, dtype_suffix, ptr, route, stream
from ..parallel.mesh import pad_axis, shard_rows
from ..core.regions import MutationScore
from ..core.sequence import _CODE_LUT, apply_mutation, seq_to_states
from .align import both_dev, both_dev_sharded
from .dp import (DMAX, MODEL_FIELDS, column_solve, emission,
                 level_windows, neg_big, window)
from .fill import (CLUSTER_MAX, INSTANCE_RPT, instance_name, measured_at,
                   rows_per_thread, wide_scratch)
from .pack import (event_ref_indexes, fill_geometry, limited_geometry,
                   place_full, round_up)
from .types import make_mutscores

P_SLOTS = 9
_K_EDGES = np.array((7, 16, 46, 160), dtype=np.int64)
_NOT_ACGT = np.ones(256, dtype=bool)
_NOT_ACGT[list(b"ACGT")] = False

# ---------------------------------------------------------------- host side


def _k_bucket(k: int) -> int:
    for b in _K_EDGES.tolist():
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


def _k_buckets(k):
    """``_k_bucket`` of every entry of the int64 array k."""
    small = _K_EDGES[np.minimum(np.searchsorted(_K_EDGES, k), 3)]
    return np.where(k <= _K_EDGES[-1], small, (k + 127) // 128 * 128)


def _mut_columns(seqs, muts_lists):
    """Every region's mutations read once into columns (the one pass over
    the objects): ``start``, ``lo`` and ``lm`` (the lengths of orig and
    mut), ``region``, ``idx`` (the index in its region's list), ``moff``
    (where its mut starts in ``codes``) and ``bad`` (its mut holds a byte
    other than ACGT); per region ``slen``, ``soff`` (where its sequence
    starts in ``codes``) and ``sbad``.  ``codes`` holds the base codes of
    every sequence, then of every mut, then one spare 0; ``seqs`` and
    ``muts`` keep the inputs."""
    R = len(muts_lists)
    counts = np.fromiter(map(len, muts_lists), np.int64, R)
    flat = [m for muts in muts_lists for m in muts]
    N = len(flat)
    start = np.array([m.start for m in flat], dtype=np.int64)
    lo = np.fromiter(map(len, [m.orig for m in flat]), np.int64, N)
    mut_s = [m.mut for m in flat]
    lm = np.fromiter(map(len, mut_s), np.int64, N)
    slen = np.fromiter(map(len, seqs), np.int64, R)
    soff = np.cumsum(slen) - slen
    moff = np.cumsum(lm) - lm + slen.sum()
    raw = np.frombuffer(("".join(seqs) + "".join(mut_s)).encode("latin-1"),
                        np.uint8)
    nbad = np.concatenate(([0], np.cumsum(_NOT_ACGT[raw])))
    region = np.repeat(np.arange(R), counts)
    return SimpleNamespace(
        start=start, lo=lo, lm=lm, region=region,
        idx=np.arange(N) - np.repeat(np.cumsum(counts) - counts, counts),
        moff=moff, bad=nbad[moff + lm] > nbad[moff], slen=slen, soff=soff,
        sbad=nbad[soff + slen] > nbad[soff],
        codes=np.append(_CODE_LUT[raw], 0).astype(np.int32), seqs=seqs,
        muts=muts_lists)


def _classes(c):
    """The (K, D) class of every mutation of the columns c: (the sorted
    (K, D) pairs, each one's members as indexes into c in region and list
    order, and a mask of the mutations whose windows come from their
    objects: those of a (class, region) subset that holds a non-ACGT base,
    in its sequence or in one of its muts, as ``_build_groups`` decides)."""
    kb = _k_buckets(c.lm + 6)
    db = np.where(np.abs(c.lm - c.lo) <= 4, 4, 32)
    # D is 4 or 32, under 64: the keys sort as the (K, D) pairs do
    keys, cls = np.unique(kb * 64 + db, return_inverse=True)
    cls = cls.reshape(-1)
    members = np.split(np.argsort(cls, kind="stable"),
                       np.cumsum(np.bincount(cls))[:-1])
    R = len(c.slen)
    subset = cls * R + c.region
    subset_bad = np.bincount(subset, weights=c.bad,
                             minlength=len(keys) * R) > 0
    per_object = c.sbad[c.region] | subset_bad[subset]
    kd = [(int(k) // 64, int(k) % 64) for k in keys]
    return kd, members, per_object


def _empty_groups(G_pad, K_all, P=P_SLOTS):
    """``_pad_groups``' arrays for G_pad groups, every slot empty."""
    return dict(
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


def _windows(c, f, K_all):
    """Per-mutation state windows of the mutations f (indexes into the
    columns c, pure-ACGT sequence and muts): (states [N, K_all] int32 with
    -1 padding, nst [N])."""
    reg = c.region[f]
    S0 = c.slen[reg]
    starts, lm = c.start[f], c.lm[f]
    # past-the-end starts are no-ops; orig spans past the end are clamped
    # to the in-sequence tail (Sequence.h:38-59)
    lo = np.minimum(c.lo[f], np.maximum(S0 - starts, 0))
    lm_eff = np.where(starts >= S0, 0, lm)

    # the mutated sequence from si on, one row a position j (long rows for
    # NumPy): the sequence before the mutation, its mut, the sequence after
    # its orig; 0 past the sequence's end
    si = np.maximum(starts - 4, 0)
    pre = starts - si
    j = np.arange(K_all + 4, dtype=np.int64)[:, None]
    in_pre = j < pre
    in_mut = ~in_pre & (j < pre + lm_eff)
    src = np.where(in_pre, si + j, starts + lo - pre - lm_eff + j)
    at = np.where(in_mut, c.moff[f] - pre + j,
                  c.soff[reg] + np.minimum(np.maximum(src, 0), S0 - 1))
    w = c.codes[np.where(in_mut | (src < S0), at, -1)]

    st = w[:-4] * 256 + w[1:-3] * 64 + w[2:-2] * 16 + w[3:-1] * 4 + w[4:]
    nst_seq = S0 + lm_eff - lo - 4
    nw = np.clip(np.minimum(lm + 6, nst_seq - si), 0, K_all)
    st = np.where(np.arange(K_all)[:, None] < nw, st, -1)
    return st.T, np.maximum(nst_seq, 0)


def _groups(c, sel, per_object, K_all, S_r, evoff_r, P=P_SLOTS):
    """Start-grouped slot arrays for the mutations sel (indexes into the
    columns c, in region and list order): mutations of a region sharing a
    start share a group of up to P slots, each region's groups after the
    previous region's.  Returns ``_pad_groups``' dict, g_S and g_evoff
    taken from each group's region (``S_r``, ``evoff_r``), and the index
    maps: per region present, its members' indexes in its list.  The
    windows of the mutations marked in per_object come from their objects
    (``seq_to_states``' non-ACGT quirks)."""
    N = len(sel)
    reg = c.region[sel]
    order = np.lexsort((c.start[sel], reg))
    f = sel[order]
    ss, rr = c.start[f], reg[order]
    run_start = np.ones(N, dtype=bool)
    run_start[1:] = (ss[1:] != ss[:-1]) | (rr[1:] != rr[:-1])
    run_first = np.maximum.accumulate(np.where(run_start, np.arange(N), 0))
    t_idx = (np.arange(N) - run_first) % P
    g_idx = np.cumsum(run_start | (t_idx == 0)) - 1
    G = int(g_idx[-1]) + 1 if N else 0

    gp = _empty_groups(_g_bucket(max(G, 1)), K_all, P)
    gp["G"], gp["G_pad"] = G, gp["g_start"].shape[0]
    present, first = np.unique(reg, return_index=True)
    idx_maps = np.split(c.idx[sel], first[1:])
    if not N:
        return gp, idx_maps
    slot = (g_idx, t_idx)
    gp["g_start"][g_idx] = ss
    gp["g_startind"][:G] = np.maximum(gp["g_start"][:G] - 4, 0)
    gp["g_region"][g_idx] = rr
    gp["g_S"][g_idx] = S_r[rr]
    gp["g_evoff"][g_idx] = evoff_r[rr]
    gp["g_part"][g_idx] = np.searchsorted(present, rr)
    gp["s_idx"][slot] = order - first[gp["g_part"][g_idx]]
    gp["s_mlen"][slot] = c.lm[f]
    gp["s_valid"][slot] = ss <= c.slen[rr]

    fast = ~per_object[f]
    st, nst = _windows(c, f[fast], K_all)
    gp["s_win"][g_idx[fast], t_idx[fast]] = st
    gp["s_nst"][g_idx[fast], t_idx[fast]] = nst
    for n in np.flatnonzero(~fast):
        r, g, t = int(rr[n]), int(g_idx[n]), int(t_idx[n])
        m = c.muts[r][int(c.idx[f[n]])]
        mutseq = apply_mutation(c.seqs[r], m.start, m.orig, m.mut)
        gp["s_nst"][g, t] = max(len(mutseq) - 4, 0)
        si = int(gp["g_startind"][g])
        w = seq_to_states(mutseq)[si : si + len(m.mut) + 6]
        gp["s_win"][g, t, : len(w)] = w
    return gp, idx_maps


# the JAX package's helpers by name, over the columns


def _partition_classes(datas, muts_list, participate):
    """Each region's mutations split into (K, D) classes, one scorer launch
    each: {(K, D): [(muts_subset, original_indexes), ...] per region}."""
    c = _mut_columns(*_participants(datas, muts_list, participate))
    kd, members, _ = _classes(c)
    classes: dict = {}
    for key, sel in zip(kd, members):
        cls = classes[key] = [([], []) for _ in range(len(datas))]
        for r, i in zip(c.region[sel].tolist(), c.idx[sel].tolist()):
            cls[r][0].append(muts_list[r][i])
            cls[r][1].append(i)
    return classes


def _mut_windows_fast(sequence, muts, K_all):
    """Vectorized per-mutation state windows for pure-ACGT sequence+muts.
    Returns (states [N, K_all] int32 with -1 padding, nst [N])."""
    return _windows(_mut_columns([sequence], [muts]), np.arange(len(muts)),
                    K_all)


def _build_groups(sequence, muts, K_all, P=P_SLOTS):
    """Start-grouped slot arrays for ONE region's mutations: mutations
    sharing a start share a group of up to P slots."""
    c = _mut_columns([sequence], [muts])
    per_object = np.full(len(muts), c.sbad[0] or c.bad.any())
    gp, _ = _groups(c, np.arange(len(muts)), per_object, K_all,
                    np.zeros(1, np.int64), np.zeros(1, np.int64), P)
    return {k: gp[k][: gp["G"]] for k in ("g_start", "g_startind", "s_mlen",
                                          "s_nst", "s_win", "s_valid",
                                          "s_idx")}


def _pad_groups(parts, g_S_parts, g_region_parts, P=P_SLOTS):
    """Concatenate per-region group arrays; pad the group axis to its
    bucket."""
    G = sum(p["g_start"].shape[0] for p in parts)
    G_pad = _g_bucket(max(G, 1))
    K_all = parts[0]["s_win"].shape[2] if parts else _k_bucket(7)
    out = _empty_groups(G_pad, K_all, P)
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


def _participants(datas, muts_list, participate):
    """The sequences and mutation lists of the participating regions, the
    others' empty."""
    return ([d.sequence if p else "" for d, p in zip(datas, participate)],
            [m if p else [] for m, p in zip(muts_list, participate)])


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


_GEOM_SIG = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
GEOM = Kernel("geom", "poreseq_tpu/engine/tpu/mutscore.py:171 _geom_body",
              {"psq_geom_f32": _GEOM_SIG, "psq_geom_f64": _GEOM_SIG})
# the longest row the kernel's first instance stages (then rewrites to ri)
# in one block's shared memory (csrc/geom.cu ROW_BYTES); a longer one runs
# the cluster instance, a slice of at most that many levels in each of up
# to GEOM_CLUSTER_MAX CTAs (csrc/geom.cu GEOM_CL_MAX), and past that the
# instance that reads the row from device memory and writes ri to a scratch
# row
GEOM_MAX_LEVELS = {torch.float32: 57344, torch.float64: 28672}
GEOM_CLUSTER_MAX = 16
#: the cluster instance's CTAs an event where fewer would hold the row: the
#: size that measured fastest at tools/sweep_constants.py geom_cluster's
#: row lengths and event counts (PERF.md §6)
GEOM_CLUSTER_CTAS = {torch.float32: 16, torch.float64: 16}
#: the most events a launch of the cluster instance takes, by dtype and by
#: the fewest CTAs that hold the row: the largest of the sweep's event
#: counts (8, 32, 64, 128) up to which it measured faster than the memory
#: instance at every count (PERF.md §6: NVIDIA H100 80GB HBM3, 700.00 W);
#: past it the memory instance runs
GEOM_CLUSTER_ROWS = {torch.float32: {2: 128, 4: 128, 8: 64, 16: 32},
                     torch.float64: {2: 128, 4: 128, 8: 64, 16: 32}}


def geom_instance(T: int, E: int, dtype) -> tuple[str, int]:
    """The geometry instance csrc/geom.cu runs for E rows of T levels of
    dtype, and its cluster's CTAs: "staged" (one block an event, the row in
    its shared memory) up to GEOM_MAX_LEVELS; "cluster" up to
    GEOM_CLUSTER_MAX slices of that many levels and GEOM_CLUSTER_ROWS
    events, where it measured faster, on max(the CTAs that hold the row,
    GEOM_CLUSTER_CTAS) CTAs; else "memory" (the row read from device
    memory, ri in a scratch row)."""
    cap = GEOM_MAX_LEVELS[dtype]
    if T <= cap:
        return "staged", 0
    need = -(-T // cap)
    if need > GEOM_CLUSTER_MAX or E > measured_at(GEOM_CLUSTER_ROWS[dtype],
                                                  need):
        return "memory", 0
    return "cluster", max(need, min(GEOM_CLUSTER_CTAS[dtype],
                                    GEOM_CLUSTER_MAX))


def geom_cuda(ral, n0, S_e, width: int, C: int, instance=None):
    """Launch csrc/geom.cu's geometry kernel: the twin's (i0, i1).
    instance: geom_instance's choice for the rows with levels (n0 > 0), or
    one named as (name, CTAs) (the cluster instance at any CTAs that hold
    the row, or "memory" at any T; to hold and time them at one shape);
    counted by name."""
    E, T = ral.shape
    dev, dt = ral.device, ral.dtype
    check("ral", ral, dt, (E, T), dev)
    check("n0", n0, torch.int32, (E,), dev)
    check("S_e", S_e, torch.int32, (E,), dev)
    if instance is None:
        # past the staged cap the route counts the rows with levels (a
        # batch pads its event rows to a bucket): one read-back
        work = (E if T <= GEOM_MAX_LEVELS[dt]
                else int((n0 > 0).sum().item()))
        instance = geom_instance(T, work, dt)
    name, ctas = instance
    i0 = torch.empty((E, C + 1), dtype=torch.int32, device=dev)
    i1 = torch.empty((E, C + 1), dtype=torch.int32, device=dev)
    scratch = (torch.empty((E, T), dtype=dt, device=dev)
               if name == "memory" else None)
    GEOM.call(f"psq_geom_{dtype_suffix(dt)}", dev, ptr(ral), ptr(n0),
              ptr(S_e), ptr(i0), ptr(i1),
              None if scratch is None else ptr(scratch), E, T, C, width,
              ctas, stream(dev), instance=name)
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
        + [("lik_offset", ctypes.c_double), ("rpt", ctypes.c_int),
           ("scratch", ctypes.c_void_p), ("scratch_blocks", ctypes.c_int)])


#: the wide group scorer's grid when its arrays are in device memory: one
#: block for each of the H100's 132 SMs (a 1024-thread block takes an SM's
#: registers), striding over the (group, event row) pairs; any count is
#: correct
SCRATCH_BLOCKS = 132
#: the group scorer's cluster instance (csrc/mutscore.cu GCL_THREADS x
#: GCL_RPT): the window rows a CTA holds in registers; at most CLUSTER_MAX
#: CTAs a cluster (csrc/mutscore.cu GCL_MAX)
GROUP_CLUSTER_SPAN = 2048
#: the most (group, event row) pairs a launch of the cluster instance
#: takes, by dtype and by its CTAs: the largest of tools/sweep_constants.py
#: mutscore's pair counts (100-6,400, at Ws = 4097, 6001, 8193 and 16,385:
#: 2, 3, 4 and 8 CTAs) up to which it measured faster than the wide
#: instance at every count (PERF.md §6: NVIDIA H100 80GB HBM3, 700.00 W;
#: it measured faster at all of them); past it the wide instance runs
GROUP_CLUSTER_PAIRS = {torch.float32: {2: 6400, 3: 6400, 4: 6400, 8: 6400},
                       torch.float64: {2: 6400, 3: 6400, 4: 6400, 8: 6400}}


def group_cluster_ctas(Ws: int) -> int:
    """The CTAs of the group scorer's cluster instance at window width Ws
    (csrc/mutscore.cu group_ctas): ceil((Ws - 1) / GROUP_CLUSTER_SPAN),
    where Ws = n GROUP_CLUSTER_SPAN + 1 leaves its last row to the last
    CTA's last thread."""
    return max(1, -(-(Ws - 1) // GROUP_CLUSTER_SPAN))


def group_instance(Ws: int, pairs: int, dtype) -> str:
    """The group-scorer instance csrc/mutscore.cu runs at window width Ws
    for ``pairs`` (group, event row) pairs of dtype: up to RPT_ROWS the one
    block of rows_per_thread(Ws) rows a thread; past it the cluster
    instance ("cluster": group_cluster_ctas(Ws) CTAs a pair, the window in
    their registers, the scan's top levels, the carried column's seams and
    the joins' maxima in distributed shared memory) up to CLUSTER_MAX CTAs
    (Ws up to CLUSTER_MAX GROUP_CLUSTER_SPAN + 1) and GROUP_CLUSTER_PAIRS
    pairs, where it measured faster, else the wide instance ("wide").
    Below 1 row, ValueError."""
    rpt = rows_per_thread(Ws, "group scorer")
    if rpt:
        return instance_name(rpt)
    n = group_cluster_ctas(Ws)
    return ("cluster" if n <= CLUSTER_MAX
            and pairs <= measured_at(GROUP_CLUSTER_PAIRS[dtype], n)
            else "wide")


_SIG = [ctypes.POINTER(_MutArgs), ctypes.c_void_p]
_SUM_SIG = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
MUTSCORE = Kernel(
    "mutscore", "poreseq_tpu/engine/tpu/pallas_mutscore.py:195 _kernel",
    {"psq_mutscore_f32": _SIG, "psq_mutscore_f64": _SIG,
     "psq_sum_rows_f32": _SUM_SIG, "psq_sum_rows_f64": _SUM_SIG})


def group_totals_cuda(batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf,
                      bpb, ev_region, gp, lik_offset, W, Ws, RS, K, P, DM,
                      E_g, instance: str | None = None):
    """Launch csrc/mutscore.cu: (totals [G, P], deltas [G, P, E_g]).
    instance: group_instance's choice, or one named (past RPT_ROWS
    "cluster" or "wide", to hold and time both at one shape); the C entry
    refuses one that does not take Ws."""
    return _launch_groups(True, batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r,
                          win, bpf, bpb, ev_region, gp, lik_offset, W, Ws,
                          RS, K, P, DM, E_g, instance)


def group_deltas_cuda(*args, instance: str | None = None):
    """Launch csrc/mutscore.cu's group kernel alone (group_totals_cuda's
    arguments): deltas [G, P, E_g], summed later by ``sum_rows``."""
    return _launch_groups(False, *args, instance)[1]


def _launch_groups(with_totals, batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r,
                   win, bpf, bpb, ev_region, gp, lik_offset, W, Ws, RS, K, P,
                   DM, E_g, instance=None):
    C1, E, _ = Mf.shape
    Q1 = win[0].shape[0]
    dev, dt = Mf.device, Mf.dtype
    G = gp["g_start"].shape[0]
    rows_per_thread(Ws, "group scorer")     # below 1 row: ValueError
    name = instance or group_instance(Ws, G * E_g, dt)
    rpt = INSTANCE_RPT[name]
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
    # the wide instance's shared memory beside its arrays: 64 partial
    # maxima and the K anchors
    scratch = (wide_scratch(min(G * E_g, SCRATCH_BLOCKS), Ws, dt,
                            64 * deltas.element_size() + 4 * K, dev)
               if name == "wide" else None)
    args = _MutArgs(
        *[t.data_ptr() for t in (Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r)],
        (ctypes.c_void_p * 3)(*[t.data_ptr() for t in win]),
        *[t.data_ptr() for t in (bpf, bpb, ev_region, batch.n0, active)],
        (ctypes.c_void_p * 4)(*[t.data_ptr() for t in lik]),
        (ctypes.c_void_p * 6)(*[t.data_ptr() for t in model]),
        *[garr[k].data_ptr() for k in GROUP_FIELDS],
        deltas.data_ptr(), totals.data_ptr() if with_totals else None,
        C1, E, W, Ws, Q1, RS, K, P, DM, E_g, G, float(lik_offset), rpt,
        None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.shape[0])
    MUTSCORE.call(f"psq_mutscore_{dtype_suffix(dt)}", dev,
                  ctypes.byref(args), stream(dev), instance=name)
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

    cols = _mut_columns(*_participants(datas, muts_list, participate))
    kd, members, per_object = _classes(cols)
    obs.count("psq.mutations_columnar", int((~per_object).sum()))
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
    with obs.span("psq.mutscore.wait"):
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

    S_r = np.asarray(ctx["S_list"], dtype=np.int64)
    for (K_c, D_c), sel in zip(kd, members):
        with obs.span("psq.mutscore.groups"):
            gp, idx_maps = _groups(cols, sel, per_object, K_c, S_r, ev_offs)
            if mesh is None:
                gp_d = {k: torch.as_tensor(gp[k], device=dev)
                        for k in GROUP_FIELDS}
        if mesh is not None:
            yield gp, idx_maps, (mesh, shards, batch.bounds, gp,
                                 float(p.lik_offset), W, Ws, RS, K_c,
                                 P_SLOTS, D_c, E_g)
            continue
        args = (batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb,
                ev_region_d, gp_d, float(p.lik_offset), W, Ws, RS, K_c,
                P_SLOTS, D_c, E_g)
        yield gp, idx_maps, args


def score_mutations_multi(engine, datas, muts_list):
    """ScoreMutations for R regions: one forward + backward fill pair and
    one group-scorer launch per (K, D) class; groups carry their region id
    and only their region's event rows contribute.  Regions with no
    mutations (or no events) are skipped, their events untouched.  Each
    mutation sits in exactly one (class, group, slot), so its score is the
    reference's -1e-6 plus that slot's total, scattered back by array."""
    participate = [bool(m) and bool(d.events)
                   for d, m in zip(datas, muts_list)]
    if not any(participate):
        return [make_mutscores(muts) for muts in muts_list]
    base = np.cumsum([0] + [len(m) for m in muts_list])
    scores = np.full(int(base[-1]), -1e-6)
    totals_of = group_totals if engine.mesh is None else group_totals_sharded
    for gp, idx_maps, args in group_launches(engine, datas, muts_list,
                                             participate):
        totals = totals_of(*args)
        with obs.span("psq.mutscore.wait"):
            totals_h = totals.to(torch.float64).cpu().numpy()
        with obs.span("psq.mutscore.assign"):
            s_idx = gp["s_idx"][: gp["G"]]
            g, t = np.nonzero(s_idx >= 0)
            maps = np.concatenate(idx_maps)
            at = np.cumsum([0] + [len(im) for im in idx_maps[:-1]])
            i = maps[at[gp["g_part"][g]] + s_idx[g, t]]
            scores[base[gp["g_region"][g]] + i] = -1e-6 + totals_h[g, t]
    with obs.span("psq.mutscore.assign"):
        vals = scores.tolist()
        return [[MutationScore(m.start, m.orig, m.mut, s)
                 for m, s in zip(muts, vals[base[r] : base[r + 1]])]
                for r, muts in enumerate(muts_list)]
