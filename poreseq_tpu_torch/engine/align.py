"""Alignment scoring on device: fill + backtrace + per-base likes.

Counterpart of ``poreseq_tpu/engine/tpu/align.py``.  The backtrace
(Alignment.cpp:516-624) is kernel 3 of the port (csrc/backtrace.cu) with
the plain twin ``backtrace_reference``; ``device_likes`` and the fused
programs ``fwd_dev`` / ``fwd_likes`` / ``both_dev`` are plain functions of
torch ops around the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, check, dtype_suffix, ptr, route, stream
from ..parallel.mesh import gather, shard_rows
from .dp import EXTEND, IGNORE, INSERT, MATCH, SKIP, STAY
from .fill import get_fill

_SIG = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
BACKTRACE = Kernel("backtrace",
                   "poreseq_tpu/engine/tpu/align.py:56 backtrace_core",
                   {"psq_backtrace_f32": _SIG, "psq_backtrace_f64": _SIG})


def backtrace_reference(M, S, steps_m, steps_s, i0, i1, best_i, best_j,
                        t_pad: int, max_steps: int):
    """Plain twin of the backtrace: the best-path walk of every event
    (align.backtrace_core's body), vectorized over events.  Returns
    ref_align [E, T] (0 unaligned, -1 insert, else the 1-based reference
    index) and ref_like [E, T], 0 wherever nothing was emitted."""
    C, E, W = M.shape
    dev, dt = M.device, M.dtype
    ev = torch.arange(E, device=dev)
    i = best_i.long().clone()
    j = best_j.long().clone()
    arr = torch.zeros(E, dtype=torch.long, device=dev)
    act = best_i > 0
    ral = torch.zeros((E, t_pad), dtype=dt, device=dev)
    rlk = torch.zeros((E, t_pad), dtype=dt, device=dev)
    for step in range(max_steps):
        # a lane that stopped never changes again: end when all have
        if step % 64 == 0 and not bool(act.any()):
            break
        jok = (j >= 1) & (j <= C)
        jc = j.clamp(1, C)
        i0j = i0[ev, jc].long()
        i1j = i1[ev, jc].long()
        row = i - i0j
        inb = (row >= 0) & (row < W) & (i <= i1j) & (i >= i0j)
        rowc = row.clamp(0, W - 1)
        on_m = arr == 0
        sc = torch.where(on_m, M[jc - 1, ev, rowc], S[jc - 1, ev, rowc])
        stp = torch.where(on_m, steps_m[jc - 1, ev, rowc],
                          steps_s[jc - 1, ev, rowc])
        ok = act & (i > 0) & jok & inb & (sc > 0.0)
        is_match, is_ignore = stp == MATCH, stp == IGNORE
        is_insert, is_stay = stp == INSERT, stp == STAY
        is_extend, is_skip = stp == EXTEND, stp == SKIP
        emit_ref = is_match | is_extend | (is_stay & (arr == 1))
        emit = ok & (emit_ref | is_ignore | is_insert)
        val = torch.where(emit_ref, j.to(dt), -1.0)
        if bool(emit.any()):
            ral[ev[emit], i[emit] - 1] = val[emit]
            rlk[ev[emit], i[emit] - 1] = sc[emit]
        known = (is_match | is_ignore | is_insert | is_stay | is_extend
                 | is_skip)
        i = torch.where(ok & emit, i - 1, i)
        j = torch.where(ok & (is_skip | is_match | is_ignore), j - 1, j)
        arr = torch.where(ok & is_stay, 1 - arr, arr)
        act = ok & known & (i > 0)
    return ral, rlk


def backtrace_cuda(M, S, steps_m, steps_s, i0, i1, best_i, best_j,
                   t_pad: int, max_steps: int):
    """Launch csrc/backtrace.cu: same outputs as backtrace_reference."""
    C, E, W = M.shape
    dev, dt = M.device, M.dtype
    for n, t in (("M", M), ("S", S)):
        check(n, t, dt, (C, E, W), dev)
    for n, t in (("steps_m", steps_m), ("steps_s", steps_s)):
        check(n, t, torch.uint8, (C, E, W), dev)
    for n, t in (("i0", i0), ("i1", i1)):
        check(n, t, torch.int32, (E, C + 1), dev)
    for n, t in (("best_i", best_i), ("best_j", best_j)):
        check(n, t, torch.int32, (E,), dev)
    ral = torch.empty((E, t_pad), dtype=dt, device=dev)
    rlk = torch.empty((E, t_pad), dtype=dt, device=dev)
    BACKTRACE.call(f"psq_backtrace_{dtype_suffix(dt)}", dev,
                   ptr(M), ptr(S), ptr(steps_m), ptr(steps_s), ptr(i0),
                   ptr(i1), ptr(best_i), ptr(best_j), ptr(ral), ptr(rlk),
                   C, E, W, t_pad, max_steps, stream(dev))
    return ral, rlk


def backtrace(M, S, steps_m, steps_s, i0, i1, best_i, best_j, t_pad: int,
              max_steps: int):
    """Backtrace wrapper: the twin for CPU tensors, the kernel for CUDA."""
    args = (M, S, steps_m, steps_s, i0, i1, best_i, best_j, t_pad,
            max_steps)
    if route(M, steps_m, i0, best_i) == "cuda":
        return backtrace_cuda(*args)
    return backtrace_reference(*args)


def device_likes(ral, rlk, n_like: int):
    """Per-event per-reference-base likelihood values (the selection core of
    likes_contribution, cpp/MakeMutations.cpp:168-189): vals[e, k] is the DP
    score of the last aligned level at or before reference index k+1 (0
    where none).  ral is monotone where > 0, as the backtrace emits."""
    E, T = ral.shape
    iota = torch.arange(T, device=ral.device)
    anchor = ral > 0
    idxf = torch.cummax(torch.where(anchor, iota, -1), dim=1).values
    A = torch.cummax(torch.where(anchor, ral, 0.0), dim=1).values
    V = torch.gather(rlk, 1, idxf.clamp(min=0))
    ks = torch.arange(1, n_like + 1, dtype=A.dtype, device=A.device)
    j = torch.searchsorted(A.contiguous(), ks.expand(E, n_like).contiguous(),
                           right=True) - 1
    jc = j.clamp(min=0)
    ok = (j >= 0) & (torch.gather(A, 1, jc) > 0)
    return torch.where(ok, torch.gather(V, 1, jc), 0.0)


def fwd_dev(batch, states, i0, i1, is_pad, lik_offset, width: int,
            t_pad: int, max_steps: int, n_like: int):
    """Forward fill + backtrace + device likes: (best, ral, rlk, likes)."""
    r = get_fill(width, need_steps=True)(batch, states, i0, i1, is_pad,
                                         lik_offset, False)
    ral, rlk = backtrace(r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1,
                         r.best_i, r.best_j, t_pad, max_steps)
    return r.best, ral, rlk, device_likes(ral, rlk, n_like)


def fwd_likes(batch, states, i0, i1, is_pad, lik_offset, width: int,
              t_pad: int, max_steps: int, n_like: int):
    """Candidate-scoring program: only (best, likes) leave it."""
    best, _, _, likes = fwd_dev(batch, states, i0, i1, is_pad, lik_offset,
                                width, t_pad, max_steps, n_like)
    return best, likes


def both_dev(batch, states, i0, i1, is_pad, lik_offset, width: int,
             t_pad: int, max_steps: int):
    """Forward + backward fills + backtrace.  Returns the blank-extended
    lattice stacks the mutation scorer reads — (Mf, Sf, Mb, Sb [C+1, E, W],
    bpf, bpb [C+1, E], ral, rlk)."""
    rf = get_fill(width, need_steps=True)(batch, states, i0, i1, is_pad,
                                          lik_offset, False)
    rb = get_fill(width, need_steps=False)(batch, states, i0, i1, is_pad,
                                           lik_offset, True)
    ral, rlk = backtrace(rf.M, rf.S, rf.steps_m, rf.steps_s, rf.i0, rf.i1,
                         rf.best_i, rf.best_j, t_pad, max_steps)
    blank = lambda x: torch.cat([torch.zeros_like(x[:1]), x])
    return (blank(rf.M), blank(rf.S), blank(rb.M), blank(rb.S),
            blank(rf.best_pfx), blank(rb.best_pfx), ral, rlk)


def fwd_dev_sharded(mesh, batch, states, i0, i1, is_pad, lik_offset,
                    width: int, t_pad: int, max_steps: int, n_like: int,
                    likes_only: bool = False):
    """fwd_dev on a mesh (``parallel/mesh.py``): 'ev' shard i's rows run
    the unchanged fill and backtrace on the first device of mesh row i;
    (best, ral, rlk, likes) come back in global row order on the mesh's
    first device, (best, likes) when ``likes_only`` (fwd_likes).  ``batch``
    is a ShardedBatch; states [C, E], i0/i1 [E, C+1] and is_pad [C, E] are
    global (numpy or torch)."""
    outs = []
    for i, (lo, hi) in enumerate(batch.bounds):
        dev = mesh.devices[i][0]
        with mesh.on(i, mesh.serves(i, dev)):
            outs.append(fwd_dev(
                batch.parts[i][dev], shard_rows(states, lo, hi, dev, 1),
                shard_rows(i0, lo, hi, dev), shard_rows(i1, lo, hi, dev),
                shard_rows(is_pad, lo, hi, dev, 1), lik_offset, width,
                t_pad, max_steps, n_like))
    best, ral, rlk, likes = ([o[k] for o in outs] for k in range(4))
    if likes_only:
        return gather(best, mesh.first), gather(likes, mesh.first)
    return tuple(gather(x, mesh.first) for x in (best, ral, rlk, likes))


def both_dev_sharded(mesh, batch, states, i0, i1, is_pad, lik_offset,
                     width: int, t_pad: int, max_steps: int):
    """both_dev on a mesh: 'ev' shard i's rows run both fills and the
    backtrace once on each distinct device of mesh row i, where that
    device's group-scorer shards read the lattices.  Returns (shards, ral,
    rlk): shards[i][device] = dict(batch, i0f, i1f, Mf, Sf, Mb, Sb, bpf,
    bpb) for the shard's rows, and ral/rlk [E, T] in global row order on
    the mesh's first device.  Arguments as in fwd_dev_sharded."""
    shards, rals, rlks = [], [], []
    for i, (lo, hi) in enumerate(batch.bounds):
        row = {}
        for dev in mesh.row_devices(i):
            b = batch.parts[i][dev]
            i0f = shard_rows(i0, lo, hi, dev)
            i1f = shard_rows(i1, lo, hi, dev)
            with mesh.on(i, mesh.serves(i, dev)):
                Mf, Sf, Mb, Sb, bpf, bpb, ral, rlk = both_dev(
                    b, shard_rows(states, lo, hi, dev, 1), i0f, i1f,
                    shard_rows(is_pad, lo, hi, dev, 1), lik_offset, width,
                    t_pad, max_steps)
            row[dev] = dict(batch=b, i0f=i0f, i1f=i1f, Mf=Mf, Sf=Sf, Mb=Mb,
                            Sb=Sb, bpf=bpf, bpb=bpb)
            if dev == mesh.devices[i][0]:
                rals.append(ral)
                rlks.append(rlk)
        shards.append(row)
    return shards, gather(rals, mesh.first), gather(rlks, mesh.first)
