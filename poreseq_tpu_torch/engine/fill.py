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
        ("rpt", ctypes.c_int), ("scratch", ctypes.c_void_p),
    ]


#: the register-held scan's widest band, 1024 threads of 4 rows (realign
#: width 2047; csrc/fill.cu and csrc/mutscore.cu RPT_ROWS)
RPT_ROWS = 4095
#: the wide instances' column arrays of n values (csrc WIDE_ARRAYS): the
#: fill's prevM, prevO and emissions, the group scorer's carried and
#: selected columns, and both kernels' six scan rows
WIDE_ARRAYS = 9
#: the dynamic shared memory a block may take on the H100 (227 KB)
SMEM_BYTES = 232_448
#: the fill's cluster instance (csrc/fill.cu CL_THREADS x CL_RPT): the band
#: positions a CTA holds in registers, and the most CTAs of a cluster (the
#: card's largest non-portable cluster size)
CLUSTER_SPAN = 1024
CLUSTER_MAX = 16
#: FillArgs.rpt of each fill instance (csrc/fill.cu RPT_CLUSTER: -1)
INSTANCE_RPT = {"1 row": 1, "2 rows": 2, "4 rows": 4, "wide": 0,
                "cluster": -1}
#: the most event rows a launch of the cluster instance takes, by dtype and
#: by its CTAs: the largest E of tools/fill_instances.py's grid (E = 8, 32,
#: 64, 96, 128, 256) up to which it measured faster than the wide instance
#: at every E, at W = 4097, 6450, 8193, 12289 and 16384 (5, 7, 9, 13 and 16
#: CTAs; PERF.md §6: NVIDIA H100 80GB HBM3, 700.00 W).  Past it the
#: card is full for either instance, and the wide one measured faster.
CLUSTER_ROWS = {torch.float32: {5: 64, 7: 256, 9: 96, 13: 256, 16: 256},
                torch.float64: {5: 256, 7: 128, 9: 256, 13: 128, 16: 256}}


def rows_per_thread(n: int, what: str = "fill") -> int:
    """Band rows a thread of csrc/fill.cu (and window rows of
    csrc/mutscore.cu's group kernel) holds in registers at width n in one
    block: the kernels' scan (common.cuh:mp_scan) covers 1024 rows a block
    at one row a thread, so 1 for n <= 1024, 2 up to 2048, 4 up to
    RPT_ROWS; past it 0: no one-block instance (the fill runs its cluster
    or its wide instance, fill_instance; the group scorer its wide one);
    below 1, ValueError."""
    if n < 1:
        raise ValueError(f"{what} kernel needs a width of at least 1 band "
                         f"row, got {n}")
    return (1 if n <= 1024 else 2 if n <= 2048 else 4 if n <= RPT_ROWS
            else 0)


def instance_name(rpt: int) -> str:
    """A group-scorer instance's name in ``Kernel.instances`` (and a fill's
    up to RPT_ROWS: fill_instance)."""
    return "wide" if rpt == 0 else f"{rpt} row{'s' if rpt > 1 else ''}"


def cluster_ctas(W: int) -> int:
    """The CTAs of the fill's cluster instance at band width W."""
    return -(-W // CLUSTER_SPAN)


def measured_at(table: dict, n: int) -> int:
    """A measured table's value at key n ({size: limit}): the size's, else
    the lower of the values of the measured sizes next to it."""
    below = max((k for k in table if k <= n), default=min(table))
    above = min((k for k in table if k >= n), default=max(table))
    return min(table[below], table[above])


def cluster_rows(ctas: int, dtype) -> int:
    """CLUSTER_ROWS at a cluster of ``ctas`` CTAs (measured_at)."""
    return measured_at(CLUSTER_ROWS[dtype], ctas)


def fill_instance(W: int, E: int, dtype) -> str:
    """The fill instance csrc/fill.cu runs at band width W for E event rows
    of dtype: up to RPT_ROWS the one block of rows_per_thread(W) rows a
    thread ("1 row", "2 rows", "4 rows"); past it the cluster instance
    ("cluster": cluster_ctas(W) CTAs of CLUSTER_SPAN rows an event, their
    scan's top levels and the band's seams in distributed shared memory)
    up to CLUSTER_MAX CTAs and cluster_rows event rows, where it measured
    faster, else the wide instance ("wide": one block an event, its column
    in shared or device memory, wide_scratch).  Below 1 row, ValueError."""
    rpt = rows_per_thread(W)
    if rpt:
        return instance_name(rpt)
    n = cluster_ctas(W)
    return ("cluster" if n <= CLUSTER_MAX and E <= cluster_rows(n, dtype)
            else "wide")


def wide_scratch(rows: int, n: int, dtype, extra: int, device):
    """The wide instances' column arrays (WIDE_ARRAYS x n values of dtype
    for each of ``rows`` blocks: the fill's "wide" instance, the group
    scorer's) in device memory, or None where a block's arrays and its
    ``extra`` bytes of shared memory fit SMEM_BYTES (the kernel then keeps
    them in shared memory)."""
    size = torch.empty((), dtype=dtype).element_size()
    if WIDE_ARRAYS * n * size + extra <= SMEM_BYTES:
        return None
    return torch.empty((max(rows, 1), WIDE_ARRAYS, n), dtype=dtype,
                       device=device)


_SIG = [ctypes.POINTER(_FillArgs), ctypes.c_void_p]
FILL = Kernel("fill", "poreseq_tpu/engine/tpu/pallas_fill.py:142 _kernel",
              {"psq_fill_f32": _SIG, "psq_fill_f64": _SIG})


def fill_cuda(batch: EventBatch, states, i0, i1, is_pad, lik_offset,
              backward: bool, W: int, need_steps: bool = True,
              instance: str | None = None):
    """Launch csrc/fill.cu: dp.fill_reference's raw outputs (M, S,
    steps_m, steps_s, cmax, carg), then the running best that
    dp.finish_fill derives from them (best_pfx [C, E], best [E], best_i,
    best_j [E] int32).  instance: fill_instance's choice, or one named
    (past RPT_ROWS "cluster" or "wide", to hold and time both at one
    shape); the C entry refuses one that does not take W."""
    dev, dt = batch.mean.device, batch.mean.dtype
    C, E = states.shape
    rows_per_thread(W)          # below 1 row: ValueError
    name = instance or fill_instance(W, E, dt)
    rpt = INSTANCE_RPT[name]
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
    # the wide instance's shared memory beside its arrays: 32 partial
    # maxima and their rows
    scratch = (wide_scratch(E, W, dt, 32 * (M.element_size() + 4), dev)
               if name == "wide" else None)
    args = _FillArgs(
        ptr(batch.mean), ptr(batch.stdv), ptr(lsx),
        (ctypes.c_void_p * 6)(*[t.data_ptr() for t in model]),
        (ctypes.c_void_p * 4)(*[t.data_ptr() for t in lik]),
        ptr(batch.n0), ptr(active), ptr(states), ptr(pad), ptr(i0), ptr(i1),
        ptr(M), ptr(S), ptr(sm), ptr(ss), ptr(cmax), ptr(carg),
        ptr(best_pfx), ptr(best), ptr(best_i), ptr(best_j), C, E, W, T,
        int(backward), int(need_steps), float(lik_offset), rpt,
        None if scratch is None else scratch.data_ptr())
    FILL.call(f"psq_fill_{dtype_suffix(dt)}", dev, ctypes.byref(args),
              stream(dev), instance=name)
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

