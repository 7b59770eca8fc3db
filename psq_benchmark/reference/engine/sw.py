"""Smith-Waterman in NumPy with the port's semantics (+5 match, -4
mismatch, -8 gap; local alignment from the first global maximum, ties
taken diagonal first, then the gap along seq1, then along seq2; accuracy
in % of the aligned pairs that match).  Each column of seq2 is one
vectorised step: the gap along seq1 is a max-plus scan, done with a
running maximum."""

from __future__ import annotations

import numpy as np

MATCH, MISMATCH, GAP = 5, -4, -8


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def swfull(seq1: str, seq2: str):
    """(accuracy %, pairs [n, 2] of 1-based indices, 0 for a gap, max
    score)."""
    a, b = _codes(seq1), _codes(seq2)
    n1, n2 = len(a), len(b)
    steps = np.zeros((n2 + 1, n1 + 1), dtype=np.uint8)
    scores = np.zeros((n2 + 1, n1 + 1), dtype=np.int32)
    prv = np.zeros(n1 + 1, dtype=np.int64)
    ramp = GAP * np.arange(n1 + 1, dtype=np.int64)
    best, bi, bj = 0, 0, 0
    for j in range(1, n2 + 1):
        diag = prv[:-1] + np.where(a == b[j - 1], MATCH, MISMATCH)
        up = prv[1:] + GAP
        m1 = np.maximum(up, 0)
        # left[i] = cur[i-1] + GAP with cur[i] = max(m1, diag, left): a
        # max-plus scan of max(m1, diag) along i
        base = np.concatenate([[0], np.maximum(m1, diag)])
        cur = np.maximum.accumulate(base - ramp) + ramp
        cur[0] = 0
        left = cur[:-1] + GAP
        st = np.where(up > 0, 1, 0)
        st = np.where(left > m1, 2, st)
        st = np.where(diag >= np.maximum(m1, left), 3, st)
        steps[j, 1:] = st
        scores[j] = cur
        col = cur[1:]
        i = int(np.argmax(col))
        if col[i] > best:
            best, bi, bj = int(col[i]), i + 1, j
        prv = cur
    p1, p2, nmatch = [], [], 0
    i, j = bi, bj
    while i > 0 and j > 0 and scores[j, i] > 0:
        s = steps[j, i]
        if s == 1:
            p1.append(0), p2.append(j)
            j -= 1
        elif s == 2:
            p1.append(i), p2.append(0)
            i -= 1
        elif s == 3:
            p1.append(i), p2.append(j)
            nmatch += int(a[i - 1] == b[j - 1])
            i -= 1
            j -= 1
        else:
            break
    pairs = np.stack([np.array(p1[::-1], dtype=np.int64),
                      np.array(p2[::-1], dtype=np.int64)], axis=1) \
        if p1 else np.zeros((0, 2), dtype=np.int64)
    acc = 100.0 * nmatch / len(p1) if p1 else float("nan")
    return acc, pairs, best


def swalign(seq1: str, seq2: str):
    acc, pairs, _ = swfull(seq1, seq2)
    return acc, [tuple(p) for p in pairs]


def fillinds(pairs: np.ndarray) -> np.ndarray:
    """Forward-fill zero (gap) indices with the previous nonzero index; the
    carry starts at element 0."""
    out = pairs.copy()
    if len(out) == 0:
        return out
    for c in range(2):
        col = out[:, c]
        nz = np.where(col > 0, np.arange(len(col)), -1)
        np.maximum.accumulate(nz, out=nz)
        col[:] = np.where(nz >= 0, col[np.maximum(nz, 0)], col[0])
    return out


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    return np.argsort(-np.asarray(scores), kind="stable").astype(np.int32)


def map_alignments(data, newseq: str):
    """Remap every event's ref_align from data.sequence onto newseq through
    the filled pair map (the port's ``engine/sw.map_alignments``)."""
    acc, pairs, _ = swfull(data.sequence, newseq)
    pairs = fillinds(pairs)
    data.sequence = newseq
    inds1 = pairs[:, 0].astype(np.float64)
    inds2 = pairs[:, 1]
    front, back = inds1[0], inds1[-1]
    for ev in data.events:
        refal = ev.ref_align.astype(np.int64).astype(np.float64)
        oob = (refal < front) | (refal > back)
        idx = np.searchsorted(inds1, refal, side="left")
        valid = ~oob & (idx < len(inds2))
        newral = np.zeros_like(ev.ref_align)
        newral[valid] = inds2[idx[valid]]
        ev.ref_align = newral
    return acc, pairs
