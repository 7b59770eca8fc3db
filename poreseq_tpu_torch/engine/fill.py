"""Fill wrapper: the banded pair-HMM fill with its running best on CPU
(plain twins ``dp.fill_reference`` + ``dp.finish_fill``) or CUDA (hand
kernel csrc/fill.cu, which computes both).

Counterpart of ``poreseq_tpu/engine/tpu/align.py:get_fill`` choosing
between ``pallas_fill.make_pallas_fill`` and ``dp.make_fill``: here the
operands' device decides.  CPU tensors go to ``dp.fill_reference``; CUDA
tensors launch the kernel (f32 or f64) or raise.  On either route the
result is a ``FillResult``.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, check, dtype_suffix, ptr, route, stream
from .dp import (MODEL_FIELDS, EventBatch, FillResult, fill_reference,
                 finish_fill)


class _FillArgs(ctypes.Structure):
    """Mirror of csrc/fill.cu:FillArgs."""

    _fields_ = [
        ("mean", ctypes.c_void_p), ("stdv", ctypes.c_void_p),
        ("lsx", ctypes.c_void_p), ("model", ctypes.c_void_p * 6),
        ("lik", ctypes.c_void_p * 4), ("n0", ctypes.c_void_p),
        ("active", ctypes.c_void_p), ("states", ctypes.c_void_p),
        ("is_pad", ctypes.c_void_p), ("i0", ctypes.c_void_p),
        ("i1", ctypes.c_void_p), ("M", ctypes.c_void_p),
        ("S", ctypes.c_void_p), ("steps_m", ctypes.c_void_p),
        ("steps_s", ctypes.c_void_p), ("cmax", ctypes.c_void_p),
        ("carg", ctypes.c_void_p), ("best_pfx", ctypes.c_void_p),
        ("best", ctypes.c_void_p), ("best_i", ctypes.c_void_p),
        ("best_j", ctypes.c_void_p),
        ("C", ctypes.c_int), ("E", ctypes.c_int), ("W", ctypes.c_int),
        ("Tlen", ctypes.c_int), ("backward", ctypes.c_int),
        ("need_steps", ctypes.c_int), ("lik_offset", ctypes.c_double),
        ("rpt", ctypes.c_int),
    ]


#: the widest band a kernel instance takes: realign_width 2047
MAX_W = 4095


def rows_per_thread(n: int, what: str = "fill") -> int:
    """Band rows a thread of csrc/fill.cu (and window rows of
    csrc/mutscore.cu's group kernel) holds at width n: the kernels' scan
    (common.cuh:mp_scan) covers 1024 rows a block at one row a thread, so
    1 for n <= 1024, 2 up to 2048, 4 up to MAX_W; past it, or below 1,
    ValueError."""
    if not 1 <= n <= MAX_W:
        raise ValueError(f"{what} kernel needs 1 <= width <= {MAX_W} band "
                         f"rows (realign/scoring width <= {MAX_W // 2}), "
                         f"got {n}")
    return 1 if n <= 1024 else 2 if n <= 2048 else 4


_SIG = [ctypes.POINTER(_FillArgs), ctypes.c_void_p]
FILL = Kernel("fill", "poreseq_tpu/engine/tpu/pallas_fill.py:142 _kernel",
              {"psq_fill_f32": _SIG, "psq_fill_f64": _SIG})


def fill_cuda(batch: EventBatch, states, i0, i1, is_pad, lik_offset,
              backward: bool, W: int, need_steps: bool = True):
    """Launch csrc/fill.cu: dp.fill_reference's raw outputs (M, S,
    steps_m, steps_s, cmax, carg), then the running best that
    dp.finish_fill derives from them (best_pfx [C, E], best [E], best_i,
    best_j [E] int32)."""
    dev, dt = batch.mean.device, batch.mean.dtype
    rpt = rows_per_thread(W)
    C, E = states.shape
    T = batch.mean.shape[1]
    f = lambda n, t, shape: check(n, t, dt, shape, dev)
    f("mean", batch.mean, (E, T))
    f("stdv", batch.stdv, (E, T))
    lsx = f("lsx", batch.lsd if backward else batch.lsr, (E, T))
    model = [f(m, getattr(batch, m), (E, 1024)) for m in MODEL_FIELDS]
    lik = [f(n, getattr(batch, n), (E,)) for n in
           ("lik_skip", "lik_stay", "lik_extend", "lik_insert")]
    check("n0", batch.n0, torch.int32, (E,), dev)
    active = check("active", batch.active.to(torch.uint8), torch.uint8,
                   (E,), dev)
    check("states", states, torch.int32, (C, E), dev)
    pad = check("is_pad", is_pad.to(torch.uint8), torch.uint8, (C, E), dev)
    check("i0", i0, torch.int32, (E, C + 1), dev)
    check("i1", i1, torch.int32, (E, C + 1), dev)

    M = torch.empty((C, E, W), dtype=dt, device=dev)
    S = torch.empty((C, E, W), dtype=dt, device=dev)
    sw = W if need_steps else 0
    sm = torch.empty((C, E, sw), dtype=torch.uint8, device=dev)
    ss = torch.empty((C, E, sw), dtype=torch.uint8, device=dev)
    cmax = torch.empty((C, E), dtype=dt, device=dev)
    carg = torch.empty((C, E), dtype=torch.int32, device=dev)
    best_pfx = torch.empty((C, E), dtype=dt, device=dev)
    best = torch.empty((E,), dtype=dt, device=dev)
    best_i = torch.empty((E,), dtype=torch.int32, device=dev)
    best_j = torch.empty((E,), dtype=torch.int32, device=dev)
    args = _FillArgs(
        ptr(batch.mean), ptr(batch.stdv), ptr(lsx),
        (ctypes.c_void_p * 6)(*[t.data_ptr() for t in model]),
        (ctypes.c_void_p * 4)(*[t.data_ptr() for t in lik]),
        ptr(batch.n0), ptr(active), ptr(states), ptr(pad), ptr(i0), ptr(i1),
        ptr(M), ptr(S), ptr(sm), ptr(ss), ptr(cmax), ptr(carg),
        ptr(best_pfx), ptr(best), ptr(best_i), ptr(best_j), C, E, W, T,
        int(backward), int(need_steps), float(lik_offset), rpt)
    FILL.call(f"psq_fill_{dtype_suffix(dt)}", dev, ctypes.byref(args),
              stream(dev))
    return M, S, sm, ss, cmax, carg, best_pfx, best, best_i, best_j


def get_fill(width: int, need_steps: bool = True):
    """fill(batch, states, i0, i1, is_pad, lik_offset, backward) ->
    FillResult at half-width ``width`` (W = 2*width+1)."""
    W = 2 * width + 1

    def fill(batch: EventBatch, states, i0, i1, is_pad, lik_offset,
             backward: bool):
        if route(batch.mean, states, i0, i1, is_pad) == "cuda":
            M, S, sm, ss, _, _, best_pfx, best, best_i, best_j = fill_cuda(
                batch, states, i0, i1, is_pad, lik_offset, backward, W,
                need_steps)
            return FillResult(M, S, sm, ss, i0, i1, best, best_i, best_j,
                              best_pfx)
        raw = fill_reference(batch, states, i0, i1, is_pad, lik_offset,
                             backward, W, need_steps)
        return finish_fill(*raw, i0, i1, backward)

    return fill

