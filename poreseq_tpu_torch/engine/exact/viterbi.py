"""Exact-engine wrapper for the native 1024-state Viterbi candidate generator
(spec: PoreSeq's cpp/Viterbi.cpp:239-426).  A copy of the JAX package's
``engine/exact/viterbi.py``.  The draws come from libc rand(), which
nothing here seeds (the reference's behaviour): ``_native.srand`` makes a
call repeatable."""

from __future__ import annotations

import ctypes as ct

import numpy as np

from ...core.events import Event, update_refs
from .._native import lib


def viterbi_mutate(
    events: list[Event],
    nkeep: int,
    skip_prob: float,
    stay_prob: float,
    mut_min: float,
    mut_max: float,
    verbose: bool = False,
) -> list[str]:
    n_ev = len(events)
    n_levels = np.array([len(ev.mean) for ev in events], dtype=np.int32)
    lev_off = np.zeros(n_ev, dtype=np.int64)
    if n_ev:
        lev_off[1:] = np.cumsum(n_levels[:-1])
    total = int(n_levels.sum())

    mean = np.zeros(total)
    stdv = np.zeros(total)
    ref_align = np.zeros(total)
    ref_index = np.zeros(total)
    ri_len = np.zeros(n_ev, dtype=np.int32)
    refstart = np.zeros(n_ev, dtype=np.int32)
    refend = np.zeros(n_ev, dtype=np.int32)
    lev_mean = np.zeros((n_ev, 1024))
    lev_stdv = np.zeros((n_ev, 1024))
    sd_mean = np.zeros((n_ev, 1024))
    sd_stdv = np.zeros((n_ev, 1024))

    for e, ev in enumerate(events):
        o = lev_off[e]
        n = n_levels[e]
        mean[o : o + n] = ev.mean
        stdv[o : o + n] = ev.stdv
        ref_align[o : o + n] = ev.ref_align
        ri, rs, re = update_refs(ev.ref_align)
        ri_len[e] = len(ri)
        ref_index[o : o + len(ri)] = ri
        refstart[e] = rs
        refend[e] = re
        lev_mean[e] = ev.model.level_mean
        lev_stdv[e] = ev.model.level_stdv
        sd_mean[e] = ev.model.sd_mean
        sd_stdv[e] = ev.model.sd_stdv

    span = int(refend.max() - refstart.min() + 2) if n_ev else 1
    nseq = max(nkeep, 1)
    cap = nseq * (4 * max(span, 16) + 32)
    buf = np.zeros(cap, dtype=np.uint8)
    seq_lens = np.zeros(nseq, dtype=np.int32)

    n = lib().psq_viterbi_mutate(
        n_ev, n_levels, lev_off,
        mean, stdv, ref_align, ref_index,
        ri_len, refstart, refend,
        np.ascontiguousarray(lev_mean), np.ascontiguousarray(lev_stdv),
        np.ascontiguousarray(sd_mean), np.ascontiguousarray(sd_stdv),
        int(nkeep), float(skip_prob), float(stay_prob), float(mut_min), float(mut_max),
        buf.ctypes.data_as(ct.c_char_p), cap, seq_lens,
    )
    if n < 0:
        raise RuntimeError("viterbi sequence buffer overflow")
    out = []
    off = 0
    for k in range(n):
        out.append(bytes(buf[off : off + seq_lens[k]]).decode("latin-1"))
        off += seq_lens[k]
    return out
