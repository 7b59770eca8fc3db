"""Smith-Waterman wrappers over the port's host C++ core (csrc/host_sw.cpp,
built with g++ on first use by ``_build.build_host``).  A copy of the JAX
package's ``engine/exact/sw.py`` and the loader part of its ``_native.py``.

Semantics per PoreSeq's cpp/swlib.cpp: +5/-4/-8 scoring, `>=` tie-break
favoring the diagonal, local backtrace from the global max, accuracy in % of
matched pairs (NaN for empty alignments, which the callers rely on).
"""

from __future__ import annotations

import ctypes as ct
import threading

import numpy as np

_f8 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i4 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")

_LIB = None
_LOCK = threading.Lock()


def _lib() -> ct.CDLL:
    """csrc/host_sw.cpp, built (if missing or stale) and loaded once."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from .._build import build_host

            lib = ct.CDLL(str(build_host("host_sw")))
            lib.psq_swfull.restype = ct.c_int
            lib.psq_swfull.argtypes = [
                ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int,
                _i4, _i4, ct.c_int,
                ct.POINTER(ct.c_double), ct.POINTER(ct.c_int32),
            ]
            lib.psq_swfast.restype = ct.c_int
            lib.psq_swfast.argtypes = [
                ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int,
                ct.c_double, ct.c_double, ct.c_int,
                _i4, _i4, ct.c_int,
                ct.POINTER(ct.c_double), ct.POINTER(ct.c_int32),
            ]
            lib.psq_srand.argtypes = [ct.c_uint]
            lib.psq_argsort_desc.argtypes = [_f8, ct.c_int, _i4]
            _LIB = lib
    return _LIB


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    """Descending argsort with libstdc++ std::sort's tie permutation."""
    order = np.zeros(len(scores), dtype=np.int32)
    _lib().psq_argsort_desc(np.ascontiguousarray(scores, dtype=np.float64),
                            len(scores), order)
    return order


def swfull(seq1: str, seq2: str) -> tuple[float, np.ndarray, int]:
    """Full-matrix SW.  Returns (accuracy%, pairs[n,2] of 1-based indices with
    0 meaning a gap, max score)."""
    n1, n2 = len(seq1), len(seq2)
    cap = n1 + n2 + 2
    o1 = np.zeros(cap, dtype=np.int32)
    o2 = np.zeros(cap, dtype=np.int32)
    acc = ct.c_double()
    score = ct.c_int32()
    n = _lib().psq_swfull(
        seq1.encode(), n1, seq2.encode(), n2, o1, o2, cap, ct.byref(acc), ct.byref(score)
    )
    if n < 0:
        raise RuntimeError("swfull output overflow")
    return acc.value, np.stack([o1[:n], o2[:n]], axis=1), score.value


def swfast(seq1: str, seq2: str, al_m: float, al_b: float, width: int):
    """Banded SW along the line i = m*j + b (cpp/swlib.cpp:19-209)."""
    n1, n2 = len(seq1), len(seq2)
    cap = n1 + n2 + 2
    o1 = np.zeros(cap, dtype=np.int32)
    o2 = np.zeros(cap, dtype=np.int32)
    acc = ct.c_double()
    score = ct.c_int32()
    n = _lib().psq_swfast(
        seq1.encode(), n1, seq2.encode(), n2, float(al_m), float(al_b), int(width),
        o1, o2, cap, ct.byref(acc), ct.byref(score),
    )
    if n < 0:
        raise RuntimeError("swfast output overflow")
    return acc.value, np.stack([o1[:n], o2[:n]], axis=1), score.value


def swalign(seq1: str, seq2: str) -> tuple[float, list[tuple[int, int]]]:
    """Public swalign API (pyx:155-174): (accuracy, list of index pairs)."""
    acc, pairs, _ = swfull(seq1, seq2)
    return acc, [tuple(p) for p in pairs]


def fillinds(pairs: np.ndarray) -> np.ndarray:
    """Forward-fill zero (gap) indices with the previous nonzero index
    (cpp/swlib.cpp:342-365).  Note the reference initializes the carry with
    element 0 even if it is itself zero — preserved (positions before the
    first nonzero get col[0])."""
    out = pairs.copy()
    if len(out) == 0:
        return out
    for c in range(2):
        col = out[:, c]
        nz = np.where(col > 0, np.arange(len(col)), -1)
        np.maximum.accumulate(nz, out=nz)
        col[:] = np.where(nz >= 0, col[np.maximum(nz, 0)], col[0])
    return out


def map_alignments(data, newseq: str) -> tuple[float, np.ndarray]:
    """Remap all events' ref_align from data.sequence onto newseq
    (cpp/EventUtil.cpp:12-55): swfull + fillinds, then per-level lower_bound
    through the pair map, then updaterefs.  Mutates data in place; returns the
    (accuracy, pairs) of the *unfilled* alignment (the caller in FindMutations
    uses the filled one; we return the filled one like the C++ does).
    ref_index regeneration (event.updaterefs in the C++) happens lazily when
    the events are pushed into the native aligner or the Viterbi packer."""
    acc, pairs, _ = swfull(data.sequence, newseq)
    pairs = fillinds(pairs)
    data.sequence = newseq
    inds1 = pairs[:, 0].astype(np.float64)
    inds2 = pairs[:, 1]
    front, back = inds1[0], inds1[-1]
    for ev in data.events:
        # int truncation first, like the C++ `(int)event.ref_align[j]`
        refal = ev.ref_align.astype(np.int64).astype(np.float64)
        oob = (refal < front) | (refal > back)
        idx = np.searchsorted(inds1, refal, side="left")
        valid = ~oob & (idx < len(inds2))
        newral = np.zeros_like(ev.ref_align)
        newral[valid] = inds2[idx[valid]]
        ev.ref_align = newral
    return acc, pairs
