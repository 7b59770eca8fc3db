"""Host-side packing: AlignData -> padded event arrays + band geometry.

NumPy copies of the jax-free helpers of ``poreseq_tpu/engine/tpu/pack.py``
(that module imports jax through ``dp.py``), plus the torch upload
``to_device_batch`` and ``from_jax_arrays``, which carries the JAX package's
packed state into the port so both compute on identical inputs.

Band placement follows Alignment.cpp:127-148: per column refind, the band is
centered on the event's interpolated alignment with half-width ``width``,
clamped to [1, n0]; starts advance by at most DMAX per column.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.events import Event, update_refs

from .dp import DMAX, EventBatch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def trim_range(ev: Event) -> tuple[int, int]:
    """The event's packed level range: its trim hint (Event.trim) or the full
    event."""
    t = getattr(ev, "trim", None)
    return (int(t[0]), int(t[1])) if t else (0, len(ev.mean))


def event_ref_indexes(ev: Event) -> np.ndarray:
    """Interpolated ref_index in PACKED (trimmed) level coordinates — the
    band geometry input."""
    lo, hi = trim_range(ev)
    return update_refs(ev.ref_align[lo:hi])[0]


def place_full(ev: Event, vals: np.ndarray) -> np.ndarray:
    """Expand a packed per-level row back to the event's full level axis;
    trimmed-away levels read 0 (= unaligned)."""
    lo, hi = trim_range(ev)
    if lo == 0 and hi == len(ev.mean):
        return np.asarray(vals[:hi], dtype=np.float64).copy()
    full = np.zeros(len(ev.mean), dtype=np.float64)
    full[lo:hi] = vals[: hi - lo]
    return full


def pack_events(events: list[Event], e_div: int = 1):
    """Padded per-event arrays (numpy, float64) and per-event ref_indexes.

    The event axis is padded to the JAX package's buckets (32-granular up to
    128 rows, at least 64; then 128-granular), then up to a multiple of
    ``e_div`` (a mesh's 'ev' axis: each shard gets as many rows), and the
    level axis to a multiple of 256, so both packages see identical shapes;
    padding rows are inactive."""
    E_real = len(events)
    E = (max(round_up(E_real, 32), 64) if E_real <= 128
         else round_up(E_real, 128))
    E = round_up(E, max(e_div, 1))
    trims = [trim_range(ev) for ev in events]
    n0 = np.ones(E, dtype=np.int32)
    for e, (lo, hi) in enumerate(trims):
        n0[e] = hi - lo
    T = round_up(int(n0.max()), 256)

    mean = np.zeros((E, T))
    stdv = np.ones((E, T))
    lsd = np.zeros((E, T))
    lsr = np.zeros((E, T))
    active = np.zeros(E, dtype=bool)
    lev_mean = np.zeros((E, 1024))
    lev_stdv = np.ones((E, 1024))
    log_lev = np.zeros((E, 1024))
    sd_mean = np.ones((E, 1024))
    sd_lambda = np.ones((E, 1024))
    log_lambda = np.zeros((E, 1024))
    lik4 = np.zeros((E, 4))

    ref_indexes = [np.zeros(0, dtype=np.float64)] * E
    for e, ev in enumerate(events):
        n = n0[e]
        lo, hi = trims[e]
        mean[e, :n] = ev.mean[lo:hi]
        stdv[e, :n] = ev.stdv[lo:hi]
        lsd[e, :n] = np.log(ev.stdv[lo:hi])
        # forward inverse-Gaussian quirk input: the reference indexes
        # log_stdv[n0 - i] with the FULL event's n0 (Alignment.cpp:171-172)
        lsr[e, :n] = np.log(ev.stdv)[::-1][lo:hi]
        ri = event_ref_indexes(ev)
        ref_indexes[e] = ri
        active[e] = len(ri) > 0
        m = ev.model
        d = m.derived()
        lev_mean[e] = m.level_mean
        lev_stdv[e] = m.level_stdv
        log_lev[e] = d["log_lev"]
        sd_mean[e] = m.sd_mean
        sd_lambda[e] = d["sd_lambda"]
        log_lambda[e] = d["log_lambda"]
        lik4[e] = [d["lik_skip"], d["lik_stay"], d["lik_extend"],
                   d["lik_insert"]]

    arrays = dict(
        mean=mean, stdv=stdv, lsd=lsd, lsr=lsr,
        n0=n0, active=active,
        lev_mean=lev_mean, lev_stdv=lev_stdv, log_lev=log_lev,
        sd_mean=sd_mean, sd_lambda=sd_lambda, log_lambda=log_lambda,
        lik_skip=lik4[:, 0], lik_stay=lik4[:, 1],
        lik_extend=lik4[:, 2], lik_insert=lik4[:, 3],
    )
    return arrays, ref_indexes


def to_device_batch(arrays: dict, dtype: torch.dtype,
                    device: torch.device | str) -> EventBatch:
    """Upload packed arrays as a torch EventBatch on ``device``: float fields
    in ``dtype``, n0 int32, active bool."""
    def f(name):
        return torch.as_tensor(np.asarray(arrays[name]), dtype=dtype,
                               device=device).contiguous()

    fields = {k: f(k) for k in EventBatch._fields
              if k not in ("n0", "active")}
    fields["n0"] = torch.as_tensor(np.asarray(arrays["n0"], dtype=np.int32),
                                   device=device)
    fields["active"] = torch.as_tensor(
        np.asarray(arrays["active"], dtype=bool), device=device)
    return EventBatch(**fields)


def from_jax_arrays(packed, dtype: torch.dtype,
                    device: torch.device | str) -> EventBatch:
    """The JAX package's packed state — its numpy ``arrays`` dict, or its
    EventBatch (any NamedTuple of array-likes) — as a port EventBatch.
    Reads the values through numpy, so this module never imports jax."""
    if hasattr(packed, "_asdict"):
        packed = packed._asdict()
    return to_device_batch({k: np.array(v) for k, v in packed.items()},
                           dtype, device)


def fill_geometry(arrays: dict, ref_indexes, S, S_pad: int, width: int):
    """Band geometry (i0/i1 [E, S_pad+1] int32, is_pad) for one fill."""
    n0 = arrays["n0"]
    i0p, i1p = limited_geometry(ref_indexes, n0, S, S_pad, width)
    if np.isscalar(S):
        is_pad = np.zeros(S_pad, dtype=bool)
        is_pad[S:] = True
    else:
        is_pad = (np.arange(S_pad, dtype=np.int64)[:, None]
                  >= np.asarray(S, dtype=np.int64)[None, :])
    return dict(i0=i0p, i1=i1p, is_pad=is_pad)


def limited_geometry(ref_indexes, n0: np.ndarray, S, S_pad: int,
                     width: int):
    """Rate-limited band geometry padded to S_pad (+1 cols incl. blank):
    starts advance by at most DMAX per column, tops re-clipped to the
    rectangle, padding columns frozen at the col-S anchor with empty bands.
    S may be an int or an [E] array of per-event sequence lengths."""
    E = len(n0)
    W = 2 * width + 1
    S_e = (np.full(E, S, dtype=np.int64) if np.isscalar(S)
           else np.asarray(S, dtype=np.int64))
    S_max = int(S_e.max()) if E else 0
    i0, i1 = band_geometry(ref_indexes, n0, S_max, width, backward=False)
    # rate limit from the SECOND column on: column 1 anchors wherever its
    # band belongs
    for j in range(2, S_max + 1):
        np.minimum(i0[:, j], i0[:, j - 1] + DMAX, out=i0[:, j])
    i1 = np.minimum(i1, i0 + (W - 1))

    i0p = np.zeros((E, S_pad + 1), dtype=np.int32)
    i1p = np.zeros((E, S_pad + 1), dtype=np.int32)
    i0p[:, : S_max + 1] = i0
    i1p[:, : S_max + 1] = i1
    i0p[:, S_max + 1 :] = i0[:, S_max][:, None]
    i1p[:, S_max + 1 :] = 0
    if not np.isscalar(S):
        cols = np.arange(S_pad + 1, dtype=np.int64)[None, :]
        beyond = cols > S_e[:, None]
        anchor = i0p[np.arange(E), np.minimum(S_e, S_pad)]
        i0p = np.where(beyond, anchor[:, None], i0p).astype(np.int32)
        i1p = np.where(beyond, 0, i1p).astype(np.int32)
    return i0p, i1p


def band_geometry(ref_indexes, n0: np.ndarray, S: int, width: int,
                  backward: bool):
    """i0/i1 [E, S+1] per column (col 0 = blank: i0=0, i1=n0).
    Mirrors Alignment.cpp:127-148 / :296-321."""
    E = len(ref_indexes)
    i0 = np.zeros((E, S + 1), dtype=np.int32)
    i1 = np.zeros((E, S + 1), dtype=np.int32)
    i1[:, 0] = n0
    refinds = np.arange(1, S + 1)
    if backward:
        refinds = S - refinds + 1
    for e, ri in enumerate(ref_indexes):
        ne = int(n0[e])
        if len(ri) > 0:
            imid = np.searchsorted(ri, refinds, side="left").astype(np.int64)
            if backward:
                imid = ne - imid + 1
        else:
            imid = np.ones(S, dtype=np.int64)
        curwid = np.full(S, width, dtype=np.int64)
        shrink = (curwid < ne) & ((imid < -10) | (imid > ne + 10))
        curwid[shrink] = 5
        imid = np.clip(imid, 1, max(ne, 1))
        lo = np.maximum(imid - curwid, 1)
        hi = np.minimum(imid + curwid, ne)
        i0[e, 1:] = lo
        i1[e, 1:] = hi
    return i0, i1
