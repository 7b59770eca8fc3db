"""ctypes bindings of the port's exact core, ``csrc/psq_exact.cpp``.

The library is built with g++ on first use by ``_build.build_host`` (the
JAX package's flags: -O3, no fused multiply-adds, which would break f64
bit-parity with the reference) into ``poreseq_tpu_torch/_build/``, and
loaded once per process.  The signatures are those of the JAX package's
``engine/exact/_native.py``.  Every user of the core (the exact engine of
``engine/exact``, the host Smith-Waterman of ``engine/sw.py``, the greedy
accept's argsort) calls through ``lib()``.
"""

from __future__ import annotations

import ctypes as ct
import threading

import numpy as np

_f8 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i4 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i8 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")

_LIB = None
_LOCK = threading.Lock()


def _bind(lib: ct.CDLL) -> ct.CDLL:
    lib.psq_new.restype = ct.c_void_p
    lib.psq_new.argtypes = [
        ct.c_int, _f8, _f8,  # n_levels, mean, stdv
        _f8, _f8, _f8, _f8,  # lev_mean, lev_stdv, sd_mean, sd_stdv
        ct.c_double, ct.c_double, ct.c_double, ct.c_double,  # probs
        ct.c_double, ct.c_int, ct.c_int,  # lik_offset, realign_w, scoring_w
        _f8,  # ref_align_init
    ]
    lib.psq_free.argtypes = [ct.c_void_p]
    lib.psq_reset.restype = ct.c_int
    lib.psq_reset.argtypes = [ct.c_void_p, _i4, ct.c_int]
    lib.psq_fill_forward.argtypes = [ct.c_void_p]
    lib.psq_fill_backward.argtypes = [ct.c_void_p]
    lib.psq_backtrace.argtypes = [ct.c_void_p]
    lib.psq_get_max.restype = ct.c_double
    lib.psq_get_max.argtypes = [ct.c_void_p]
    lib.psq_get_refdata.argtypes = [ct.c_void_p, _f8, _f8]
    lib.psq_set_refalign.argtypes = [ct.c_void_p, _f8]
    lib.psq_get_refstart.restype = ct.c_int
    lib.psq_get_refstart.argtypes = [ct.c_void_p]
    lib.psq_get_refend.restype = ct.c_int
    lib.psq_get_refend.argtypes = [ct.c_void_p]
    lib.psq_score_mutations.argtypes = [
        ct.c_void_p, ct.c_int, _i4, _i4, _i8, _i4, _i4, _i4, ct.c_int, _f8,
    ]
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
    lib.psq_viterbi_mutate.restype = ct.c_int
    lib.psq_viterbi_mutate.argtypes = [
        ct.c_int, _i4, _i8,  # n_ev, n_levels, lev_off
        _f8, _f8, _f8, _f8,  # mean, stdv, ref_align, ref_index (flat)
        _i4, _i4, _i4,       # ri_len, refstart, refend
        _f8, _f8, _f8, _f8,  # model rows
        ct.c_int, ct.c_double, ct.c_double, ct.c_double, ct.c_double,
        ct.c_char_p, ct.c_int64, _i4,
    ]
    return lib


def lib() -> ct.CDLL:
    """csrc/psq_exact.cpp, built (if missing or stale) and loaded once."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from .._build import build_host

            _LIB = _bind(ct.CDLL(str(build_host("psq_exact"))))
    return _LIB


def srand(seed: int) -> None:
    """Seed libc's rand(), which the Viterbi candidate generator draws from.
    Every library in the process that calls rand() shares this state."""
    lib().psq_srand(seed)
