"""The least time the card could take for the work that reaches an engine
call: the yardstick of the roofline shares.

A frozen copy of the port's ``engine/roofline.py`` constants and scan
count (bytes over 3.35e12 B/s, float operations over 67e12 / 34e12 per
second in f32 / f64: NVIDIA's data-sheet peaks of one H100 SXM at 700 W),
with the work counted from the problem an engine call is given (event
rows and their levels, sequence columns, band widths, mutations, dtype),
not from what a kernel launches.  So a later change that fuses, splits or
renames kernels is held to the same least time.

Every count is a floor: the operations of each band cell the recurrence
needs (the emission, the candidate moves, the scan element and its max,
and the scan's combines) over the columns each event row must solve, and
each level's data read once.  Padding, backpointers, read-backs and the
lattices a kernel writes are left out, so a share read against this can
only be too low, never above what the work allows.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
BYTES = {"float32": 4, "float64": 8}

EMISSION_OPS = 18
CANDIDATE_OPS = 6
ELEMENT_OPS = 3
COMBINE_OPS = 20
MAX_OPS = 1
JOIN_OPS = 8
CELL_OPS = EMISSION_OPS + CANDIDATE_OPS + ELEMENT_OPS + MAX_OPS


def scan_combines(n: int) -> int:
    """Combines of jax.lax.associative_scan's tree over n elements."""
    nl = [n]
    while nl[-1] >= 2:
        nl.append(nl[-1] >> 1)
    return sum(nl[1:]) + sum((m - 1) // 2 for m in nl[:-1])


def column_ops(width: int) -> int:
    """Operations of one band column of ``width`` rows."""
    return width * CELL_OPS + COMBINE_OPS * scan_combines(width)


def least_s(nbytes: float, ops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])


def realign_work(rows: list, realign_width: int, dtype: str) -> tuple:
    """(bytes, operations) of one forward fill over ``rows``: [(levels,
    columns)] of the event rows that have a seed alignment, each row
    solving every column of its region at band width 2 realign_width + 1
    and reading its levels' mean, stdv and log-stdv once."""
    W = 2 * realign_width + 1
    b = BYTES[dtype]
    levels = sum(n for n, _ in rows)
    cols = sum(c for _, c in rows)
    return 3 * levels * b, cols * column_ops(W)


def mutscore_work(regions: list, realign_width: int, scoring_width: int,
                  dtype: str) -> tuple:
    """(bytes, operations) of one ScoreMutations call: per region
    (rows [(levels, columns)], mutation lengths [(len orig, len mut,
    columns left after its start)]), a forward and a backward fill of its
    rows and, per (mutation, row), the refill of len(mut) + 6 columns (or
    the columns left) at scoring width and the join of a lattice column."""
    W = 2 * realign_width + 1
    Ws = 2 * min(scoring_width, realign_width) + 1
    nbytes = ops = 0
    for rows, muts in regions:
        fb, fo = realign_work(rows, realign_width, dtype)
        nbytes += 2 * fb
        ops += 2 * fo
        steps = sum(min(lm + 6, left) for _, lm, left in muts)
        ops += len(rows) * (steps * column_ops(Ws) + len(muts) * W * JOIN_OPS)
    return nbytes, ops
