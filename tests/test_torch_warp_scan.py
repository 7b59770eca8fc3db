"""A model of the CUDA kernels' max-plus column scan (csrc/common.cuh
mp_scan) on the CPU.  Thread t holds the RPT adjacent positions t RPT + j
(RPT = 1 up to 1024 rows, 2 up to 2048, 4 up to 4095:
engine/fill.py rows_per_thread): the up-sweep's levels below log2(RPT) run
inside each thread, the next five on each warp's chunk of 32 RPT positions
by shuffles of the threads' last positions, one warp runs every higher
level on the chunk tails, and the down-sweep runs the same levels back,
each warp with the previous chunk's final tail as its one outside source,
then the in-thread levels with the previous thread's last position (the
previous chunk's tail for lane 0) as theirs; the down-sweep computes only
the u part (M, S) of its combines.  Replayed in f32 on seeded elements, it
must give the u part of the twin's scan (dp._assoc_scan,
jax.lax.associative_scan's tree) bit for bit, and make exactly the (source,
destination) combines of the tree's index formulas, level by level."""

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.engine.dp import _assoc_scan, _mp_combine
from poreseq_tpu_torch.engine.fill import rows_per_thread
from poreseq_tpu_torch.engine.roofline import scan_combines

torch.set_num_threads(1)

LENGTHS = [1, 2, 31, 32, 33, 41, 63, 64, 65, 201, 511, 601, 1023, 1024,
           1025, 1401, 2047, 2048, 2049, 4095]
# rows a thread at a width that does not need them: the schedule is the
# same tree at any n
EXTRA = [(2, 1), (2, 33), (2, 64), (2, 129), (4, 1), (4, 5), (4, 127),
         (4, 128), (4, 129), (4, 1401)]


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


def warp_scan_model(elems, log=None, rpt=1):
    """mp_scan on stacked elements [6, n] (position t RPT + j = thread t's
    j-th): returns the scan's u rows [2, n]; log, if given, collects
    (phase, level, source, destination) of every combine."""
    n = elems.shape[1]
    lr = rpt.bit_length() - 1
    chunk = 32 * rpt
    npos = chunk * max((n + chunk - 1) // chunk, 1)
    x = torch.zeros((6, npos), dtype=elems.dtype)
    x[:, :n] = elems
    pos = torch.arange(npos)
    lane = (pos // rpt) % 32
    j = pos % rpt

    def step(x, s, src, dst, phase, L, pos_of):
        if log is not None:
            dsts = torch.nonzero(dst).flatten()
            log.extend((phase, L, int(pos_of[i]), int(pos_of[d]))
                       for i, d in zip(src[dsts].tolist(), dsts.tolist()))
        new = _mp_combine(s, x)
        if phase == "down":     # mp_combine_u: the u rows only
            new = torch.cat([x[:4], new[4:]])
        return torch.where(dst, new, x)

    ident = pos
    for L in range(lr):                         # in-thread levels
        dst = _up_dst(pos, L, n)
        assert bool((j[dst] >= (1 << L)).all())   # source in the thread
        src = torch.where(dst, pos - (1 << L), pos)
        x = step(x, x[:, src], src, dst, "up", L, ident)
    for L in range(5):                          # the warp's chunk
        d = 1 << (L + lr)
        src = torch.where(lane >= (1 << L), pos - d, pos)
        dst = _up_dst(pos, L + lr, n)
        assert bool((j[dst] == rpt - 1).all())    # the threads' last
        x = step(x, x[:, src], src, dst, "up", L + lr, ident)
    nt = n // chunk                             # warp 0: the chunk tails
    tail_pos = torch.arange(32) * chunk + chunk - 1
    y = torch.zeros((6, 32), dtype=elems.dtype)
    y[:, :nt] = x[:, chunk - 1::chunk][:, :nt]
    lanes = torch.arange(32)
    for L in range(5):
        s, src = _shfl_up(y, lanes, 1 << L)
        y = step(y, s, src, _up_dst(lanes, L, nt), "up", L + 5 + lr,
                 tail_pos)
    for L in range(4, -1, -1):
        s, src = _shfl_up(y, lanes, 1 << L)
        y = step(y, s, src, _down_dst(lanes, L, nt), "down", L + 5 + lr,
                 tail_pos)
    x[:, tail_pos[:nt]] = y[:, :nt]
    for L in range(4, -1, -1):                  # the warp's chunk
        d = 1 << (L + lr)
        # lane 2^L - 1 of warp w > 0 reads warp w-1's final tail instead
        outside = (lane == (1 << L) - 1) & (pos >= chunk)
        src = torch.where((lane >= (1 << L)) | outside, pos - d, pos)
        dst = _down_dst(pos, L + lr, n)
        assert bool((j[dst] == rpt - 1).all())
        x = step(x, x[:, src], src, dst, "down", L + lr, ident)
    # in-thread levels: the previous thread's last position (final now),
    # read once before them
    prev = x[:, (pos - j - 1).clamp(min=0)].clone()
    for L in range(lr - 1, -1, -1):
        dst = _down_dst(pos, L, n)
        src = pos - (1 << L)
        inside = src >= pos - j
        assert bool((inside | (j == (1 << L) - 1))[dst].all())
        s = torch.where(inside, x[:, src.clamp(min=0)], prev)
        x = step(x, s, src.clamp(min=0), dst, "down", L, ident)
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
    """At the kernels' own rows a thread for n (1, 2 or 4)."""
    elems = _elements(n, seed=n + 7 * reverse)
    if reverse:                 # the backward fill: row W-1-t at position t
        elems = torch.flip(elems, [1])
    log = []
    got = warp_scan_model(elems, log, rpt=rows_per_thread(n))
    assert torch.equal(got, _assoc_scan(elems)[4:])
    assert sorted(log) == sorted(tree_combines(n))
    assert len(log) == scan_combines(n)     # what the kernels' bounds count


@pytest.mark.parametrize("rpt,n", EXTRA)
def test_warp_scan_model_at_any_rows_a_thread(rpt, n):
    elems = _elements(n, seed=3 * n + rpt)
    log = []
    got = warp_scan_model(elems, log, rpt=rpt)
    assert torch.equal(got, _assoc_scan(elems)[4:])
    assert sorted(log) == sorted(tree_combines(n))


def test_rows_per_thread_limits():
    """1 row a thread to 1024, 2 to 2048, 4 to 4095; outside, ValueError
    naming the limit."""
    assert [rows_per_thread(n) for n in (1, 1024, 1025, 2048, 2049, 4095)] \
        == [1, 1, 2, 2, 4, 4]
    for n in (0, 4096, 4097):
        with pytest.raises(ValueError, match="4095"):
            rows_per_thread(n)
