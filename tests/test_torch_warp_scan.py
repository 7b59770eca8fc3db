"""Models of the CUDA kernels' max-plus column scans (csrc/common.cuh
mp_scan and mp_scan_mem) on the CPU.  In mp_scan thread t holds the RPT
adjacent positions t RPT + j (RPT = 1 up to 1024 rows, 2 up to 2048, 4 up
to 4095: engine/fill.py rows_per_thread): the up-sweep's levels below log2(RPT) run
inside each thread, the next five on each warp's chunk of 32 RPT positions
by shuffles of the threads' last positions, one warp runs every higher
level on the chunk tails, and the down-sweep runs the same levels back,
each warp with the previous chunk's final tail as its one outside source,
then the in-thread levels with the previous thread's last position (the
previous chunk's tail for lane 0) as theirs; the down-sweep computes only
the u part (M, S) of its combines.  Replayed in f32 on seeded elements, it
must give the u part of the twin's scan (dp._assoc_scan,
jax.lax.associative_scan's tree) bit for bit, and make exactly the (source,
destination) combines of the tree's index formulas, level by level.  Past
4095 rows the wide instances' mp_scan_mem keeps the positions in memory and
runs the same tree level by level, the block's 1024 threads striding over a
level's pairs: its NumPy model must equal the twin's scan bit for bit in
f32 and f64.  So must the model of the fill's cluster instance
(mp_scan_cluster): N CTAs of a power-of-two span, the levels below it in
each CTA, the levels above over the CTAs' totals, each CTA's down-sweep
from the u part handed to it (N 2-9, 1 and 2 rows a thread, n 4096 to
16,385; and the group scorer's span and rows a thread, N up to 16)."""

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.engine.dp import _assoc_scan, _mp_combine
from poreseq_tpu_torch.engine.fill import rows_per_thread
from poreseq_tpu_torch.engine.roofline import scan_combines

torch.set_num_threads(1)

LENGTHS = [1, 2, 31, 32, 33, 41, 63, 64, 65, 201, 511, 601, 1023, 1024,
           1025, 1401, 2047, 2048, 2049, 4095]
# the wide instances' widths (rows_per_thread 0)
WIDE_LENGTHS = [4096, 4097, 6000, 8191, 8193, 16385]
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
    """1 row a thread to 1024, 2 to 2048, 4 to 4095, then 0 (the wide
    instance, no rows in registers) at any width; below 1, ValueError."""
    assert [rows_per_thread(n) for n in (1, 1024, 1025, 2048, 2049, 4095,
                                         4096, 4097, 8193, 1 << 20)] \
        == [1, 1, 2, 2, 4, 4, 0, 0, 0, 0]
    for n in (0, -1):
        with pytest.raises(ValueError, match="at least 1"):
            rows_per_thread(n)


def _np_combine(l, v):
    """common.cuh mp_combine in NumPy (the dtype of the operands): v after
    l, [6, m] each."""
    mx = np.maximum
    return np.stack([mx(v[0] + l[0], v[1] + l[2]), mx(v[0] + l[1],
                                                      v[1] + l[3]),
                     mx(v[2] + l[0], v[3] + l[2]), mx(v[2] + l[1],
                                                      v[3] + l[3]),
                     mx(mx(v[0] + l[4], v[1] + l[5]), v[4]),
                     mx(mx(v[2] + l[4], v[3] + l[5]), v[5])])


def wide_scan_model(elems, log=None, nt=1024):
    """common.cuh mp_scan_mem on stacked NumPy elements [6, n]: up-sweep
    level L pairs k < n >> (L+1) (destination (k+1) 2^(L+1) - 1, source
    2^L below), down-sweep level L pairs m = 1.. nd = ((n >> L) - 1) >> 1
    (destination (2m+1) 2^L - 1, source 2^L below, the u rows only); thread
    t takes the level's pairs t, t + nt, ..., a barrier after each level.
    Asserts that no position of a level is both a source and a destination
    (so its pairs may run in any order); returns the u rows [2, n]; log, if
    given, collects (phase, level, source, destination)."""
    sc = elems.copy()
    n = sc.shape[1]

    def level(phase, L, count, dst_of):
        for t in range(min(nt, count)):       # thread t's pairs
            k = np.arange(t, count, nt)
            d = dst_of(k)
            s = d - (1 << L)
            new = _np_combine(sc[:, s], sc[:, d])
            if phase == "down":
                sc[4:, d] = new[4:]
            else:
                sc[:, d] = new
            if log is not None:
                log.extend((phase, L, int(a), int(b)) for a, b in zip(s, d))
        k = np.arange(count)
        d = dst_of(k)
        assert not np.intersect1d(d, d - (1 << L)).size

    L = 0
    while (2 << L) <= n:
        level("up", L, n >> (L + 1), lambda k: ((k + 1) << (L + 1)) - 1)
        L += 1
    for L in range(L - 1, -1, -1):
        level("down", L, ((n >> L) - 1) >> 1,
              lambda m: ((2 * (m + 1) + 1) << L) - 1)
    return sc[4:]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", WIDE_LENGTHS)
def test_wide_scan_model_equals_twin_scan(n, dtype):
    """Past 4095 rows, forward and reversed: the model's u rows equal the
    twin's scan bit for bit, its combines are exactly the tree's."""
    assert rows_per_thread(n) == 0
    elems = _elements(n, seed=n).numpy().astype(dtype)
    for rev in (False, True):
        x = elems[:, ::-1].copy() if rev else elems
        log = []
        got = wide_scan_model(x, log)
        ref = _assoc_scan(torch.as_tensor(x))[4:].numpy()
        assert got.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                      ref.view(f"u{ref.itemsize}"))
        assert sorted(log) == sorted(tree_combines(n))
        assert len(log) == scan_combines(n)


def _cluster_cases():
    """(N, n) with a power-of-two span S a CTA such that N = ceil(n / S):
    cluster sizes 2-9 at widths past 4095 rows."""
    out = []
    for n in CLUSTER_LENGTHS:
        for N in CLUSTER_SIZES:
            out += [(N, n)] if any(-(-n // (1 << k)) == N
                                   for k in range(9, 15)) else []
    return out


CLUSTER_LENGTHS = [4096, 4097, 6144, 8193, 16385]
CLUSTER_SIZES = [2, 3, 4, 5, 8, 9]


def _scorer_span():
    """The group scorer's cluster instance's span a CTA and rows a thread
    (csrc/mutscore.cu GCL_THREADS x GCL_RPT, GCL_RPT)."""
    import re
    from pathlib import Path

    from poreseq_tpu_torch.engine import mutscore

    src = (Path(mutscore.__file__).parents[1] / "csrc"
           / "mutscore.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (-?\d+);",
                                          src)}
    return c["GCL_THREADS"] * c["GCL_RPT"], c["GCL_RPT"]


def _scorer_cluster_cases():
    """(N, n, rpt) of the group scorer's cluster instance at window widths
    that leave its last CTA partial or full: 5001, 10,000 and 16 spans."""
    span, rpt = _scorer_span()
    return [(-(-n // span), n, rpt) for n in (5001, 10000, 16 * span)]


def cluster_scan_model(elems, N, rpt, log=None):
    """common.cuh mp_scan_cluster on NumPy elements [6, n]: N CTAs, CTA k
    holding positions [k S, (k+1) S) with S the power of two for which
    ceil(n / S) = N, rpt positions a thread.  Each CTA runs the tree's
    levels below log2 S on its own positions (up-sweep: in the thread,
    then on a warp's chunk of 32 rpt positions, then on the chunk tails,
    each asserted to pair positions where the kernel holds them); the
    full CTAs' totals (their last positions) go to every higher rank,
    where one warp runs the levels above log2 S over them and its own
    total (lanes above its rank zero; asserted equal to the full tree's
    up to its lane): the u part at its own lane is its last position's
    final value, the one at its rank - 1 the source of the down-sweep's
    first destination of each level.
    Returns the u rows [2, n]; log, if given, collects (phase, level,
    source, destination) of every combine, the top levels' once."""
    sc = elems.copy()
    n = sc.shape[1]
    S = next(1 << k for k in range(40) if -(-n // (1 << k)) == N)
    LS, LR, chunk = S.bit_length() - 1, rpt.bit_length() - 1, 32 * rpt

    def combine(phase, L, s, d, src=None):
        new = _np_combine(sc[:, s] if src is None else src, sc[:, d])
        if phase == "down":
            sc[4:, d] = new[4:]
        else:
            sc[:, d] = new
        if log is not None:
            log.extend((phase, L, int(a), int(b)) for a, b in zip(s, d))

    def placed(L, s, d):
        """Where the kernel holds a level's pair: one thread, one warp's
        chunk tails of threads, or the CTA's chunk tails."""
        if L < LR:
            assert (s // rpt == d // rpt).all()
        elif L < LR + 5:
            assert ((s % rpt == rpt - 1) & (d % rpt == rpt - 1)
                    & (s // chunk == d // chunk)).all()
        else:
            assert ((s % chunk == chunk - 1) & (d % chunk == chunk - 1)).all()

    P = np.arange(n)
    for k in range(N):
        mine = P[k * S:(k + 1) * S]
        for L in range(LS):
            d = mine[(mine < n) & ((mine + 1) % (2 << L) == 0)]
            s = d - (1 << L)
            assert (s >= k * S).all()
            placed(L, s, d)
            combine("up", L, s, d)
    nfull = n // S

    def top_tree(x, full_log=False):
        """The levels above log2 S over the CTA totals x [6, nfull]; u
        rows final, level L - LS, on lanes q (positions (q+1) S - 1)."""
        lanes = np.arange(nfull)
        tail = lambda q: (q + 1) * S - 1
        L = 0
        while (2 << L) <= nfull:
            d = lanes[(lanes + 1) % (2 << L) == 0]
            x[:, d] = _np_combine(x[:, d - (1 << L)], x[:, d])
            if full_log and log is not None:
                log.extend(("up", L + LS, int(tail(a)), int(tail(b)))
                           for a, b in zip(d - (1 << L), d))
            L += 1
        for L in range(L - 1, -1, -1):
            q = (lanes + 1) >> L
            d = lanes[((lanes + 1) % (1 << L) == 0) & (q % 2 == 1)
                      & (q >= 3)]
            x[4:, d] = _np_combine(x[:, d - (1 << L)], x[:, d])[4:]
            if full_log and log is not None:
                log.extend(("down", L + LS, int(tail(a)), int(tail(b)))
                           for a, b in zip(d - (1 << L), d))
        return x

    totals = sc[:, S - 1:nfull * S:S].copy()
    full = top_tree(totals.copy(), full_log=True)
    prefix = {}
    for k in range(N):          # each CTA's own copy of the top levels
        x = np.where(np.arange(nfull) <= k, totals, 0).astype(sc.dtype)
        x = top_tree(x)
        m = min(k + 1, nfull)
        assert np.array_equal(x[4:, :m], full[4:, :m])
        if k:
            prefix[k] = x[:, k - 1]
        if k < nfull:           # its own last position, final
            sc[4:, (k + 1) * S - 1] = x[4:, k]
    for k in range(N):
        mine = P[k * S:(k + 1) * S]
        for L in range(LS - 1, -1, -1):
            q = (mine + 1) >> L
            d = mine[(mine < n) & ((mine + 1) % (1 << L) == 0) & (q % 2 == 1)
                     & (q >= 3)]
            s = d - (1 << L)
            out = s < k * S                  # the previous CTA's last
            assert (s[out] == k * S - 1).all() and out.sum() <= 1
            if out.any():
                src = np.repeat(prefix[k][:, None], len(d), axis=1)
                src[:, ~out] = sc[:, s[~out]]
                combine("down", L, s, d, src)
            else:
                combine("down", L, s, d)
    return sc[4:]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("N,n,rpt", [(N, n, rpt) for N, n in _cluster_cases()
                                     for rpt in (1, 2)]
                         + _scorer_cluster_cases())
def test_cluster_scan_model_equals_twin_scan(N, n, rpt, dtype):
    """The cluster instances' scan: N CTAs of S positions, the top levels
    over their totals in one warp of each CTA, each CTA's down-sweep from
    its handed-in u part; forward and reversed, the u rows equal the
    twin's scan bit for bit and the combines are exactly the tree's (the
    fill's cases at 1 and 2 rows a thread, and the group scorer's span and
    rows a thread up to its 16 CTAs)."""
    elems = _elements(n, seed=n + N).numpy().astype(dtype)
    for rev in (False, True):
        x = elems[:, ::-1].copy() if rev else elems
        log = []
        got = cluster_scan_model(x, N, rpt, log)
        ref = _assoc_scan(torch.as_tensor(x))[4:].numpy()
        np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                      ref.view(f"u{ref.itemsize}"))
        assert sorted(log) == sorted(tree_combines(n))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spans", [1, 4, 8, 16])
def test_cluster_scan_model_with_the_extra_row(spans, dtype):
    """The group scorer's cluster instance at Ws = N spans + 1 (4097, 8193,
    16,385 at 1024 rows a CTA): N CTAs scan the first N spans and the last
    row, a destination of one level-0 down-sweep combine only, is combined
    from the row below after; forward and reversed, the u rows equal the
    twin's scan of all n bit for bit."""
    span, rpt = _scorer_span()
    n = spans * span + 1
    elems = _elements(n, seed=n).numpy().astype(dtype)
    assert [c for c in tree_combines(n) if n - 1 in c[2:]] == \
        [("down", 0, n - 2, n - 1)]
    for rev in (False, True):
        x = elems[:, ::-1].copy() if rev else elems
        head = x[:, :-1].copy()
        u = (cluster_scan_model(head, spans, rpt) if spans > 1
             else _assoc_scan(torch.as_tensor(head))[4:].numpy())
        last = _np_combine(np.concatenate([np.zeros((4, 1), dtype),
                                           u[:, -1:]]), x[:, -1:])
        got = np.concatenate([u, last[4:]], axis=1)
        ref = _assoc_scan(torch.as_tensor(x))[4:].numpy()
        np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                      ref.view(f"u{ref.itemsize}"))
