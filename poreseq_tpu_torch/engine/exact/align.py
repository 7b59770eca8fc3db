"""Exact (CPU, f64 bit-faithful) alignment scoring over the native core.

Implements the behavior of ScoreAlignments / ScoreMutations' DP plumbing
(PoreSeq's cpp/MakeMutations.cpp:23-69,148-195) on top of the
psq_exact shared library.  A copy of the JAX package's
``engine/exact/align.py`` over the port's own core, types and library.
"""

from __future__ import annotations

import numpy as np

from ...core.events import Event
from ...core.sequence import apply_mutation, seq_to_states
from ..types import AlignData, AlignParams
from .._native import lib


class NativeAligner:
    """Owns one native aligner handle for one event (the analog of one
    reference Alignment object, cpp/Alignment.cpp:38-60)."""

    def __init__(self, ev: Event, params: AlignParams):
        m = ev.model
        self._n = len(ev.mean)
        self._lib = lib()
        self._h = self._lib.psq_new(
            self._n,
            np.ascontiguousarray(ev.mean),
            np.ascontiguousarray(ev.stdv),
            np.ascontiguousarray(m.level_mean, dtype=np.float64),
            np.ascontiguousarray(m.level_stdv, dtype=np.float64),
            np.ascontiguousarray(m.sd_mean, dtype=np.float64),
            np.ascontiguousarray(m.sd_stdv, dtype=np.float64),
            float(m.prob_skip),
            float(m.prob_stay),
            float(m.prob_extend),
            float(m.prob_insert),
            float(params.lik_offset),
            int(params.realign_width),
            int(params.scoring_width),
            np.ascontiguousarray(ev.ref_align),
        )

    def reset(self, states: np.ndarray) -> int:
        return self._lib.psq_reset(self._h, np.ascontiguousarray(states, dtype=np.int32), len(states))

    def fill_forward(self):
        self._lib.psq_fill_forward(self._h)

    def fill_backward(self):
        self._lib.psq_fill_backward(self._h)

    def backtrace(self):
        self._lib.psq_backtrace(self._h)

    def get_max(self) -> float:
        return self._lib.psq_get_max(self._h)

    def pull_into(self, ev: Event):
        self._lib.psq_get_refdata(self._h, ev.ref_align, ev.ref_like)

    def score_mutations(self, pack, seq_len: int, out: np.ndarray):
        self._lib.psq_score_mutations(
            self._h, pack["n"], pack["starts"], pack["mutlens"], pack["wino"],
            pack["winlens"], pack["win"], pack["nstates"], seq_len, out,
        )

    def __del__(self):
        try:
            self._lib.psq_free(self._h)
        except Exception:
            pass


def likes_contribution(ref_align: np.ndarray, ref_like: np.ndarray, n_states: int,
                       n_bases: int) -> np.ndarray:
    """Per-reference-base cumulative likelihood of one event
    (cpp/MakeMutations.cpp:168-189): each base position carries the DP score
    of the last aligned level at or before it."""
    out = np.zeros(n_bases, dtype=np.float64)
    mask = ref_align > 0
    rs = ref_align[mask].astype(np.int64)
    ls = ref_like[mask]
    if len(rs) == 0:
        return out
    if np.all(np.diff(rs) >= 0):
        # monotone (always true right after a backtrace): piecewise-constant
        keep = np.r_[rs[1:] != rs[:-1], True]  # last anchor at each ref pos
        R, L = rs[keep], ls[keep]
        ks = np.arange(1, n_states + 3)
        pos = np.searchsorted(R, ks, side="right") - 1
        vals = np.where(pos >= 0, L[np.maximum(pos, 0)], 0.0)
        lim = min(n_states + 3, n_bases - 1)
        out[2 : lim + 1] = vals[: lim - 1]
        return out
    # general (possibly non-monotone) fallback, mirrors the C++ loop verbatim
    lastlik = 0.0
    refind = 1
    for j in range(len(ref_align)):
        if ref_align[j] > 0:
            for k in range(refind, int(ref_align[j])):
                if k + 1 < n_bases:
                    out[k + 1] += lastlik
            lastlik = ref_like[j]
            refind = int(ref_align[j])
    for k in range(refind, n_states + 3):
        if k + 1 < n_bases:
            out[k + 1] += lastlik
    return out


def score_alignments(data: AlignData, likes: np.ndarray | None = None) -> list[float]:
    """Realign every event to data.sequence and return per-event scores;
    optionally accumulate per-base likes (ScoreAlignments,
    cpp/MakeMutations.cpp:148-195).  Updates data.events in place."""
    states = seq_to_states(data.sequence)
    n_states = len(states)
    n_bases = len(data.sequence)
    scores = []
    for ev in data.events:
        al = NativeAligner(ev, data.params)
        al.reset(states)
        al.fill_forward()
        al.backtrace()
        al.pull_into(ev)
        scores.append(al.get_max())
        if likes is not None:
            likes += likes_contribution(ev.ref_align, ev.ref_like, n_states, n_bases)
        del al
    return scores


def pack_mutations(sequence: str, muts) -> dict:
    """Precompute the per-mutation state windows shared across events.

    For each mutation the refilled columns read the *mutated* sequence's
    states at indices [startind, startind + len(mut)+6) with
    startind = max(start-4, 0) (cpp/Alignment.cpp:476-480)."""
    n = len(muts)
    starts = np.zeros(n, dtype=np.int32)
    mutlens = np.zeros(n, dtype=np.int32)
    wino = np.zeros(n, dtype=np.int64)
    winlens = np.zeros(n, dtype=np.int32)
    nstates = np.zeros(n, dtype=np.int32)
    wins = []
    off = 0
    has_bad = any(c not in "ACGT" for c in set(sequence))
    for i, m in enumerate(muts):
        starts[i] = m.start
        mutlens[i] = len(m.mut)
        mutseq = apply_mutation(sequence, m.start, m.orig, m.mut)
        S = max(len(mutseq) - 4, 0)
        nstates[i] = S
        startind = max(m.start - 4, 0)
        wl = len(m.mut) + 6
        if has_bad or any(c not in "ACGT" for c in m.mut):
            st_full = seq_to_states(mutseq)
            w = st_full[startind : startind + wl]
        else:
            sub = mutseq[startind : startind + wl + 4]
            w = seq_to_states(sub)
        wins.append(np.ascontiguousarray(w, dtype=np.int32))
        wino[i] = off
        winlens[i] = len(w)
        off += len(w)
    win = np.concatenate(wins) if wins else np.zeros(0, dtype=np.int32)
    return {
        "n": n,
        "starts": starts,
        "mutlens": mutlens,
        "wino": wino,
        "winlens": winlens,
        "win": np.ascontiguousarray(win, dtype=np.int32),
        "nstates": nstates,
    }
