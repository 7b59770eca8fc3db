"""The least time each hand kernel could take on one H100 SXM: the bytes a
launch must move and the operations it must do, counted from its operands,
over the card's peak rates.

Bytes count every input byte the launch needs read once and every output
byte written once, whatever the kernel reads again; operations count the
arithmetic the function needs on this launch's data (solved columns,
refill steps that run, path cells), not the most the shapes allow.  Both
count only the real work: the padding a launch carries (event rows and
columns padded to a bucket, which the kernels fill with zeros) is left
out.  The bound is the larger of bytes / 3.35e12 B/s and operations / the
f32 or f64 rate of the CUDA cores (67e12 and 34e12 per second; none of
these kernels can use the tensor cores), both NVIDIA's data-sheet peaks at
700 W.  32-bit integer operations (the Gumbel noise's threefry2x32) go
over the CUDA cores' INT32 peak, 33.5e12 per second (NVIDIA's H100
white paper: 132 SMs x 64 INT32 lanes x 1.98 GHz, a multiply-add counted
as two operations, as the f32 peak counts a fused multiply-add); they run
beside the float operations, so the operations' time is the larger of the
two.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
INT32_OPS_PER_S = 33.5e12

# operations per band cell, read off the twin's expressions (engine/dp.py)
EMISSION_OPS = 18         # dp.emission
CANDIDATE_OPS = 6         # skip, match, ignore and their max D
ELEMENT_OPS = 3           # the cell's scan element (a_stay, a_ext, max)
COMBINE_OPS = 20          # dp._mp_combine: 12 adds, 8 maxima
STEP_OPS = 12             # the backpointer walk (forward fill with steps)
MAX_OPS = 1               # the column max
JOIN_OPS = 8              # a scorer join cell: 2 adds, 4 maxima, 2 tests
WALK_OPS = 10             # a backtrace step's tests and updates
# per (row, state) of the Viterbi sweep (engine/viterbi.py): the group-max
# and group-sum trees and the total (1 each), m1-m3 and the stay move (4
# adds), best (3 maxima), newlik (1), f (3 adds, 2 products), exp, the
# product by it and the divide (3)
SWEEP_OPS = 18
SWEEP_BP_OPS = 8          # the argmax tree and the priority tests/selects
# per (chain, row, state) of the sampler: pow, product, tree sum, divide,
# log (+ eps), the noise's add, the argmax
SAMPLE_OPS = 8
# per (candidate, row, state) of the Gumbel noise, which every region of a
# call shares: the uniform's subtract, multiply, add and max, two logs and
# two negations (float), and integer operations: threefry2x32 (20 rounds of
# an add, a rotate and an xor; 12 key adds) and the fraction bits set into
# 1.m (f32: an xor, a shift, an or; f64: two shifts, two ors); per row, its
# key: two threefry2x32 and the candidate's and row's split of the index
GUMBEL_OPS = 8
THREEFRY_OPS = 72
BITS_OPS = {torch.float32: 3, torch.float64: 4}
ROW_KEY_OPS = 2 * THREEFRY_OPS + 2
# per (row, valid event, state) of the Viterbi observations: the emission
# and its add to the kept sum or its compare against the drop threshold
OBS_OPS = EMISSION_OPS + 1
LIKES_OPS = 4             # a level's anchor test, two prefix maxima, a test
INTERP_OPS = 8            # a level's interpolation (or flank line) and tests
BAND_OPS = 8              # a column's clamps, band ends and rate-limit step


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype,
             int_ops: float = 0):
    """(least time in ms, "bytes" or "operations": whichever bounds it);
    ops are float operations of dtype, int_ops 32-bit integer ones."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_OPS_PER_S[dtype],
                int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_combines(n: int) -> int:
    """Combines of jax.lax.associative_scan's tree over n elements."""
    nl = [n]
    while nl[-1] >= 2:
        nl.append(nl[-1] >> 1)
    up = sum(nl[1:])
    down = sum((m - 1) // 2 for m in nl[:-1])
    return up + down


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def fill_work(batch, states, is_pad, W: int, need_steps: bool):
    """(bytes, operations) of one fill launch (engine/fill.py fill_cuda's
    operands).  Work is the (column, event) pairs the fill solves: columns
    that are not padding, of events with a seed alignment.  The zeros the
    launch writes for padded columns and inactive events (the event axis is
    padded to a bucket) are not counted."""
    b = _size(batch.mean.dtype)
    active = batch.active.bool()
    solved = int((~is_pad.bool() & active[None, :]).sum())
    n_active = int(active.sum())
    levels = int(batch.n0.long()[active].sum())
    st = states.long()
    used = (st >= 0) & active[None, :]
    ev = torch.arange(st.shape[1], device=st.device).expand_as(st)
    n_model = int(torch.unique((ev * 1024 + st)[used]).numel())
    nbytes = (3 * levels * b              # mean, stdv, log-stdv
              + 6 * n_model * b           # model values at visited states
              + n_active * (4 * b + 5)    # transitions, n0, active
              + solved * (5 + 8)          # state, is_pad, band start, end
              + solved * 2 * W * b        # M, S
              + (solved * 2 * W if need_steps else 0)
              + solved * (b + 4))         # column max and argmax
    per_cell = (EMISSION_OPS + CANDIDATE_OPS + ELEMENT_OPS + MAX_OPS
                + (STEP_OPS if need_steps else 0))
    ops = solved * (W * per_cell + COMBINE_OPS * scan_combines(W))
    # the running best: best_pfx a solved column, best, best_i, best_j an
    # event, and a compare a column
    return nbytes + solved * b + n_active * (b + 8), ops + solved


def group_work(batch, Mf, Sf, Mb, Sb, i0f, i1f, i0r, i1r, win, bpf, bpb,
               ev_region, gp, lik_offset, W, Ws, RS, K, P, DM, E_g):
    """(bytes, operations) of one group-scorer launch (engine/mutscore.py
    group_totals_cuda's operands): the lattice columns and window columns
    its groups' event rows touch, and the refill steps its valid slots
    run."""
    C1, E, _ = Mf.shape
    Q1 = win[0].shape[0]
    b = _size(Mf.dtype)
    dev = Mf.device
    G = gp["g_start"].shape[0]
    start, startind, S = (gp[k].long() for k in ("g_start", "g_startind",
                                                 "g_S"))
    e_idx = (gp["g_evoff"].long().clamp(0, E - E_g)[:, None]
             + torch.arange(E_g, device=dev))                    # [G, E_g]
    rows = (batch.active.bool()[e_idx]
            & (ev_region.long()[e_idx] == gp["g_region"].long()[:, None]))
    st0 = startind.clamp(0, C1 - 1)
    q_old = torch.clamp(start - 3, min=1).clamp(max=S).clamp(0, C1 - 1)
    mlen, nst = gp["s_mlen"].long(), gp["s_nst"].long()
    valid = gp["s_valid"].bool()
    nfill = (torch.minimum(startind[:, None] + mlen + 6, nst)
             - startind[:, None]).clamp(0, K)
    refind = torch.minimum(start[:, None] + mlen + 1,
                           torch.maximum(startind[:, None] + nfill,
                                         startind[:, None]))
    rab = (nst - refind + 1).clamp(min=0)
    rab = torch.minimum(rab, S[:, None])
    q_b = (S[:, None] - rab + 1).clamp(0, C1 - 1)                # [G, P]
    steps = torch.minimum(torch.minimum(mlen + 6, nst - startind[:, None]),
                          nfill).clamp(0, K) * valid

    def columns(q, e, keep):
        return int(torch.unique((q * E + e)[keep]).numel())

    fwd = columns(torch.stack([st0, q_old], 1)[:, :, None].expand(G, 2, E_g),
                  e_idx[:, None, :].expand(G, 2, E_g),
                  rows[:, None, :].expand(G, 2, E_g))
    qb = torch.cat([q_old[:, None], q_b], 1)                     # [G, 1+P]
    keep_b = torch.cat([torch.ones_like(valid[:, :1]), valid], 1)
    bwd = columns(qb[:, :, None].expand(G, P + 1, E_g),
                  e_idx[:, None, :].expand(G, P + 1, E_g),
                  keep_b[:, :, None] & rows[:, None, :])
    kmax = steps.max(dim=1).values                               # [G]
    ks = torch.arange(max(K, 1), device=dev)
    qw = (st0[:, None, None] + 1 + ks[None, :, None]).clamp(0, Q1 - 1)
    n_win = columns(qw.expand(G, len(ks), E_g),
                    e_idx[:, None, :].expand(G, len(ks), E_g),
                    (ks[None, :, None] < kmax[:, None, None])
                    & rows[:, None, :])
    n_rows = rows.sum(dim=1)                                     # [G]
    nbytes = ((2 * fwd + 2 * bwd) * W * b       # M and S lattice columns
              + (fwd + bwd) * (b + 8)           # best prefix, band rows
              + 3 * n_win * Ws * b              # data windows
              + G * (5 * 4 + P * (9 + 4 * K))   # groups and slots
              + (int(n_rows.sum()) + G) * P * b)  # the rows' deltas, totals
    step_ops = (Ws * (EMISSION_OPS + CANDIDATE_OPS + ELEMENT_OPS + MAX_OPS)
                + COMBINE_OPS * scan_combines(Ws))
    slot_ops = steps * step_ops + valid * W * JOIN_OPS           # [G, P]
    ops = int((n_rows * (slot_ops.sum(dim=1) + W * JOIN_OPS // 2)).sum())
    return nbytes, ops


def backtrace_work(ral, best_i, n0, dtype: torch.dtype):
    """(bytes, operations) of one backtrace launch from its output ref_align
    [E, T], best_i and the events' level counts n0: the outputs of the
    events it walks (best_i > 0) over their levels, and one path cell (a
    lattice value, a step byte and its column's band) per emitted level; the
    zeros written for padding and the walk's non-emitting steps are not
    counted, so this bounds it from below."""
    b = _size(dtype)
    walked = best_i > 0
    levels = int(n0.long()[walked].sum())
    cells = int((ral != 0).sum())
    return (2 * levels * b + cells * (b + 9) + 8 * int(walked.sum()),
            cells * WALK_OPS)


def viterbi_sweep_work(obs, n_real, need_bp: bool):
    """(bytes, operations) of one sweep launch (engine/viterbi.py
    viterbi_sweep_cuda's operands) over the real rows of the real regions:
    obs read and fwds written once per real row, liks once per region, the
    backpointers when asked for; padded rows and regions (n_real = 0) pass
    a carry and are not counted."""
    b = _size(obs.dtype)
    n = n_real.long()
    rows, regions = int(n.sum()), int((n > 0).sum())
    nbytes = (rows * 1024 * (2 * b + (8 if need_bp else 0))
              + regions * (1024 * b + 8))
    ops = rows * 1024 * (SWEEP_OPS + (SWEEP_BP_OPS if need_bp else 0))
    return nbytes, ops


def _noise_ops(nk: int, rows: int, dtype: torch.dtype):
    """(float, integer) operations of the Gumbel noise for nk candidates
    over rows rows."""
    return (nk * rows * 1024 * GUMBEL_OPS,
            nk * rows * (1024 * (THREEFRY_OPS + BITS_OPS[dtype])
                         + ROW_KEY_OPS))


def viterbi_sample_work(fwds, valid_rows, attens):
    """(bytes, operations) of one sampler call (engine/viterbi.py
    sample_paths_cuda's operands, its Gumbel launch included): the real
    rows of fwds and T's 17 values read once, every chain's path over real
    rows written, per chain, real row with a draw (rows 1..n-1) and state
    the arithmetic of SAMPLE_OPS, and the noise once for the call over the
    rows with a draw in any region; padded rows and regions are not
    counted: (bytes, float operations, integer operations)."""
    b = _size(fwds.dtype)
    nk = attens.shape[0]
    n = valid_rows.long().sum(dim=1)
    rows, regions = int(n.sum()), int((n > 0).sum())
    draws = int((n - 1).clamp(min=0).sum()) * nk
    drawn_rows = max(int(n.max()) - 1, 0) if len(n) else 0
    nbytes = (rows * (1024 * b + 1) + 17 * b + nk * b + regions * 8
              + rows * nk * 8)
    noise, noise_int = _noise_ops(nk, drawn_rows, fwds.dtype)
    return nbytes, draws * 1024 * SAMPLE_OPS + noise, noise_int


def viterbi_gumbel_work(valid_rows, nk: int, dtype: torch.dtype):
    """(bytes, operations) of the Gumbel launch of a sampler call on
    valid_rows [B, R] with nk candidates: the noise of the rows with a draw
    in any region (rows 1..n-1 of the longest) written once, and its
    arithmetic; the padded rows it also fills are not counted: (bytes,
    float operations, integer operations)."""
    n = valid_rows.long().sum(dim=1)
    rows = max(int(n.max()) - 1, 0) if len(n) else 0
    return (nk * rows * 1024 * _size(dtype), *_noise_ops(nk, rows, dtype))


def viterbi_obs_work(lvl, valid, tabs):
    """(bytes, operations) of one observation launch (engine/viterbi.py
    obs_multi_cuda's operands): the level data of the valid (row, event)
    pairs and the model tables of the events valid in any row read once,
    the rows with a valid event written once, and per valid (row, event,
    state) the emission and its add or compare (OBS_OPS), per trimmed row's
    valid (event, state) one compare more (the drop threshold), per row
    and state the divide; rows without a valid event (padding) are not
    counted."""
    from .viterbi import trim_counts

    b = _size(lvl.dtype)
    nlik, nskip = trim_counts(valid)                             # [B, R]
    n_valid, rows = int(nlik.sum()), int((nlik > 0).sum())
    tables = int(valid.any(dim=1).sum())                 # (region, event)
    nbytes = n_valid * (2 * b + 1) + tables * 6 * 1024 * b + rows * 1024 * b
    ops = 1024 * (n_valid * OBS_OPS + int(nlik[nskip > 0].sum()) + rows)
    return nbytes, ops + n_valid                         # the stdv logs


def likes_work(ral, n_like: int):
    """(bytes, operations) of one per-base likes launch (engine/align.py
    likes_cuda's operands): for the events with an anchor, ral read once up
    to the last anchor, rlk at the anchors, and their n_like values written
    once; rows with no anchor (padding, inactive events) and the levels
    past the last anchor are not counted."""
    b = _size(ral.dtype)
    anchor = ral > 0
    T = ral.shape[1]
    last = torch.where(anchor, torch.arange(T, device=ral.device),
                       -1).amax(dim=1)                         # [E]
    levels = int((last + 1).sum())
    walked = int((last >= 0).sum())
    return (levels * b + int(anchor.sum()) * b + walked * n_like * b,
            levels * LIKES_OPS)


def geom_work(ral, n0, C: int):
    """(bytes, operations) of one geometry launch (engine/mutscore.py
    geom_cuda's operands): ral read once over the levels below n0 and i0,
    i1 written once, for the events with an anchor there; per level the
    interpolation, per column the bisection's levels and the band."""
    b = _size(ral.dtype)
    T = ral.shape[1]
    n0 = n0.long()
    has = ((ral > 0) & (torch.arange(T, device=ral.device)[None, :]
                        < n0[:, None])).any(dim=1)
    n_ev, levels = int(has.sum()), int(n0[has].sum())
    nbytes = levels * b + n_ev * (8 + 8 * (C + 1))
    search = sum(int(n).bit_length() for n in n0[has].tolist())
    return nbytes, levels * INTERP_OPS + C * (search + n_ev * BAND_OPS)


def windows_work(batch, i0r, Ws: int):
    """(bytes, operations) of one windows launch (engine/mutscore.py
    windows_cuda's operands): the active events' mean, stdv and log-stdv
    levels and band starts read once and their three [Q1, Ws] windows
    written once; a copy, no arithmetic.  Inactive rows are not counted."""
    b = _size(batch.mean.dtype)
    active = batch.active.bool()
    Q1 = i0r.shape[1]
    levels = int(batch.n0.long()[active].sum())
    n_act = int(active.sum())
    return 3 * levels * b + n_act * Q1 * (4 + 3 * Ws * b), 0
