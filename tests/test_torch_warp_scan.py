"""A model of the CUDA kernels' max-plus column scan (csrc/common.cuh
mp_scan) on the CPU: each warp runs up-sweep levels 0-4 on its chunk of 32
positions by shuffles, one warp runs every level >= 5 on the chunk tails,
and each warp runs down-sweep levels 4-0 with the previous chunk's final
tail as its one outside source; the down-sweep computes only the u part
(M, S) of its combines.  Replayed in f32 on seeded elements, it must give
the u part of the twin's scan (dp._assoc_scan, jax.lax.associative_scan's
tree) bit for bit, and make exactly the (source, destination) combines of
the tree's index formulas, level by level."""

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.engine.dp import _assoc_scan, _mp_combine
from poreseq_tpu_torch.engine.roofline import scan_combines

torch.set_num_threads(1)

LENGTHS = [1, 2, 31, 32, 33, 41, 63, 64, 65, 201, 511, 601, 1023, 1024]


def _up_dst(p, L, n):
    """common.cuh up_dst, vectorized over positions p."""
    return (p < n) & (((p + 1) & ((2 << L) - 1)) == 0)


def _down_dst(p, L, n):
    """common.cuh down_dst."""
    q = (p + 1) >> L
    return ((p < n) & (((p + 1) & ((1 << L) - 1)) == 0) & (q % 2 == 1)
            & (q >= 3))


def _shfl_up(x, pos, delta):
    """__shfl_up_sync over every warp at once: lane l reads lane l - delta
    of its own warp (lanes below delta keep their own value); returns the
    values and their source positions."""
    src = torch.where(pos % 32 >= delta, pos - delta, pos)
    return x[:, src], src


def warp_scan_model(elems, log=None):
    """mp_scan on stacked elements [6, n] (position t = thread t): returns
    the scan's u rows [2, n]; log, if given, collects (phase, level,
    source, destination) of every combine."""
    n = elems.shape[1]
    nthreads = 32 * max((n + 31) // 32, 1)
    x = torch.zeros((6, nthreads), dtype=elems.dtype)
    x[:, :n] = elems
    pos = torch.arange(nthreads)

    def step(x, s, src, dst, phase, L, pos_of):
        if log is not None:
            dsts = torch.nonzero(dst).flatten()
            log.extend((phase, L, int(pos_of[i]), int(pos_of[d]))
                       for i, d in zip(src[dsts].tolist(), dsts.tolist()))
        new = _mp_combine(s, x)
        if phase == "down":     # mp_combine_u: the u rows only
            new = torch.cat([x[:4], new[4:]])
        return torch.where(dst, new, x)

    ident = torch.arange(nthreads)
    for L in range(5):                          # levels 0-4 in each warp
        s, src = _shfl_up(x, pos, 1 << L)
        x = step(x, s, src, _up_dst(pos, L, n), "up", L, ident)
    nt = n // 32                                # warp 0: the chunk tails
    tail_pos = torch.arange(32) * 32 + 31
    y = torch.zeros((6, 32), dtype=elems.dtype)
    y[:, :nt] = x[:, 31::32][:, :nt]
    lanes = torch.arange(32)
    for L in range(5):
        s, src = _shfl_up(y, lanes, 1 << L)
        y = step(y, s, src, _up_dst(lanes, L, nt), "up", L + 5, tail_pos)
    for L in range(4, -1, -1):
        s, src = _shfl_up(y, lanes, 1 << L)
        y = step(y, s, src, _down_dst(lanes, L, nt), "down", L + 5, tail_pos)
    x[:, tail_pos[:nt]] = y[:, :nt]
    for L in range(4, -1, -1):                  # levels 4-0 in each warp
        s, src = _shfl_up(x, pos, 1 << L)
        # lane 2^L - 1 of warp w > 0 reads warp w-1's final tail instead
        outside = (pos % 32 == (1 << L) - 1) & (pos >= 32)
        src = torch.where(outside, pos - (1 << L), src)
        s = torch.where(outside, x[:, src], s)
        x = step(x, s, src, _down_dst(pos, L, n), "down", L, ident)
    return x[4:, :n]


def tree_combines(n):
    """The combines of the twin's tree as csrc's earlier block scan indexed
    them (nl[L] elements at level L)."""
    nl, out = [n], []
    while nl[-1] >= 2:
        nl.append(nl[-1] >> 1)
    levels = len(nl) - 1
    for L in range(levels):
        out += [("up", L, ((2 * k + 1) << L) - 1, ((k + 1) << (L + 1)) - 1)
                for k in range(nl[L + 1])]
    for L in range(levels - 1, -1, -1):
        m = 1
        while 2 * m < nl[L]:
            out.append(("down", L, ((2 * m) << L) - 1, ((2 * m + 1) << L) - 1))
            m += 1
    return out


def _elements(n, seed):
    """Seeded scan elements shaped like a column's: transition entries
    around -1..-3 (some cut to the -1e30 sentinel), candidates D >= 0."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3.0, -0.5, (4, n))
    a[:, rng.random(n) < 0.05] = -1e30
    D = rng.uniform(0.0, 40.0, n)
    floor = np.where(rng.random(n) < 0.05, -1e30, 0.0)
    return torch.tensor(np.vstack([a, D, floor]), dtype=torch.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_warp_scan_model_equals_twin_scan(n, reverse):
    elems = _elements(n, seed=n + 7 * reverse)
    if reverse:                 # the backward fill: row W-1-t at position t
        elems = torch.flip(elems, [1])
    log = []
    got = warp_scan_model(elems, log)
    assert torch.equal(got, _assoc_scan(elems)[4:])
    assert sorted(log) == sorted(tree_combines(n))
    assert len(log) == scan_combines(n)     # what the kernels' bounds count
