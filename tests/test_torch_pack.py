"""The port's NumPy host-helper copies equal the JAX package's originals,
array for array, and the torch batch upload round-trips."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poreseq_tpu.core.regions import MutationInfo
from poreseq_tpu.engine.driver import find_point_mutations
from poreseq_tpu.engine.tpu import mutscore as jm
from poreseq_tpu.engine.tpu import pack as jp
from poreseq_tpu.engine.tpu import viterbi as jv
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import mutscore as tm
from poreseq_tpu_torch.engine import pack as tp
from poreseq_tpu_torch.engine import viterbi as tv

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


def _events(seed=4, ref_len=150, coverage=4, trim=True):
    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                             coverage=coverage, draft_error=0.03)
    if trim:
        # a trim hint on one event exercises the packed-range helpers
        ev = pa.events[1]
        ev.trim = (3, len(ev.mean) - 5)
    return pa


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _muts(rng, seq, n):
    muts = []
    for _ in range(n):
        start = int(rng.integers(0, len(seq) - 6))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            o, mu = seq[start], "ACGT"[int(rng.integers(0, 4))]
        elif kind == 1:
            o, mu = "", "ACGT"[int(rng.integers(0, 4)):][:3]
        else:
            o, mu = seq[start : start + int(rng.integers(1, 6))], ""
        muts.append((start, o, mu))
    n0 = len(seq)
    muts += [(n0 - 1, seq[-1], ""), (n0 - 1, seq[-1], "A"), (n0, "", "C"),
             (n0 + 2, "", "G"), (5, seq[5], "T" * 12)]
    out = []
    for start, o, mu in muts:
        m = MutationInfo()
        m.start, m.orig, m.mut = start, o, mu
        out.append(m)
    return out


def test_pack_helpers_match_jax():
    pa = _events()
    evs = pa.events
    a_t, ri_t = tp.pack_events(evs)
    a_j, ri_j = jp.pack_events(evs)
    _assert_same(a_t, a_j)
    _assert_same(ri_t, ri_j)
    for ev in evs:
        assert tp.trim_range(ev) == jp.trim_range(ev)
        _assert_same(tp.event_ref_indexes(ev), jp.event_ref_indexes(ev))
        vals = np.arange(len(ev.mean) + 7, dtype=np.float64)
        _assert_same(tp.place_full(ev, vals), jp.place_full(ev, vals))
    for x, m in ((1, 8), (64, 64), (65, 64), (1000, 256)):
        assert tp.round_up(x, m) == jp.round_up(x, m)
    E = len(a_t["n0"])
    S_e = np.zeros(E, np.int64)
    S_e[: len(evs)] = [140, 120, 146, 90][: len(evs)]
    for S, width in ((146, 12), (S_e, 12), (S_e, 20)):
        _assert_same(tp.fill_geometry(a_t, ri_t, S, 192, width),
                     jp.fill_geometry(a_j, ri_j, S, 192, width))
        _assert_same(tp.limited_geometry(ri_t, a_t["n0"], S, 192, width),
                     jp.limited_geometry(ri_j, a_j["n0"], S, 192, width))


@pytest.mark.parametrize("n_events,e_div", [(5, 3), (5, 4), (70, 8),
                                             (130, 3)])
def test_pack_events_e_div_matches_jax(n_events, e_div):
    """pack_events(e_div=n) rounds the event axis up to a multiple of n (a
    mesh's 'ev' axis), as the JAX package's pack_events does, array for
    array; the added rows are inactive padding."""
    pa = _events(seed=n_events, ref_len=60, coverage=n_events, trim=False)
    evs = pa.events
    a_t, ri_t = tp.pack_events(evs, e_div=e_div)
    a_j, ri_j = jp.pack_events(evs, e_div=e_div)
    _assert_same(a_t, a_j)
    _assert_same(ri_t, ri_j)
    E = len(a_t["n0"])
    assert E % e_div == 0 and E >= len(tp.pack_events(evs)[0]["n0"])
    assert not a_t["active"][n_events:].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_batch_round_trip(dtype):
    arrays, _ = tp.pack_events(_events().events)
    batch = tp.to_device_batch(arrays, dtype, "cpu")
    assert batch.n0.dtype == torch.int32 and batch.active.dtype == torch.bool
    for name, t in batch._asdict().items():
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(arrays[name]).astype(t.numpy().dtype))
    sources = [arrays]
    if dtype == torch.float32:
        # the JAX package's own EventBatch (x64 is off: f32 arrays)
        sources.append(jp.to_device_batch(arrays, jnp.float32))
    for src in sources:
        got = tp.from_jax_arrays(src, dtype, "cpu")
        for name, t in got._asdict().items():
            torch.testing.assert_close(t, getattr(batch, name), rtol=0,
                                       atol=0)


def test_mutscore_host_helpers_match_jax():
    pa = _events(seed=9, trim=False)
    data = AlignData.from_session(pa)
    rng = np.random.default_rng(3)
    seq = data.sequence
    mut_sets = [_muts(rng, seq, 60), find_point_mutations(data)]
    bad = MutationInfo()
    bad.start, bad.orig, bad.mut = 10, seq[10], "N"
    mut_sets.append(_muts(rng, seq, 8) + [bad])     # the non-ACGT path
    for muts in mut_sets:
        K, _ = jm._mut_buckets(muts)
        if all(c in "ACGT" for m in muts for c in m.mut):
            _assert_same(tm._mut_windows_fast(seq, muts, K),
                         jm._mut_windows_fast(seq, muts, K))
        g_t = tm._build_groups(seq, muts, K)
        g_j = jm._build_groups(seq, muts, K)
        _assert_same(g_t, g_j)
        G = g_t["g_start"].shape[0]
        args = ([g_t, g_t], [np.full(G, 140, np.int32)] * 2,
                [np.zeros(G, np.int32), np.ones(G, np.int32)])
        _assert_same(tm._pad_groups(*args), jm._pad_groups(*args))
    for k in (1, 7, 8, 16, 17, 46, 47, 160, 161, 300):
        assert tm._k_bucket(k) == jm._k_bucket(k)
    for d in (0, 4, 5, 40):
        assert tm._d_bucket(d) == jm._d_bucket(d)
    for g in (1, 32, 33, 4096, 4097, 9000):
        assert tm._g_bucket(g) == jm._g_bucket(g)
    datas = [data, data, data]
    muts_list = [mut_sets[0], [], mut_sets[1]]
    part = [True, False, True]
    ct = tm._partition_classes(datas, muts_list, part)
    cj = jm._partition_classes(datas, muts_list, part)
    assert sorted(ct) == sorted(cj)
    for key in ct:
        for (mt, it), (mj, ij) in zip(ct[key], cj[key]):
            assert [id(m) for m in mt] == [id(m) for m in mj] and it == ij


def _mut(start, orig, mut):
    m = MutationInfo()
    m.start, m.orig, m.mut = start, orig, mut
    return m


def _multi_base_muts(rng, seq, n):
    """Mutate-style mutations: orig 0-8 bases, mut 0-200 bases, so that
    the K buckets 7, 16, 46, 160 and past 160 and |D| > 4 all occur."""
    out = []
    for _ in range(n):
        start = int(rng.integers(0, len(seq) - 8))
        lo = int(rng.integers(0, 9))
        lm = int(rng.choice([0, 1, 2, 3, 5, 9, 12, 30, 45, 100, 170, 200]))
        out.append(_mut(start, seq[start : start + lo],
                        "".join(rng.choice(list("ACGT"), lm))))
    return out


def _edge_muts(seq):
    """Starts at 0-3 (a window clipped at the sequence's start), at and
    past its end, an orig past its end, empty orig and mut, and 12
    mutations at one start (two groups)."""
    n0 = len(seq)
    muts = [(0, seq[0], "G"), (1, "", "TT"), (3, seq[3:6], ""),
            (n0 - 2, seq[-2:] + "ACG", "C"), (n0 - 1, seq[-1], ""),
            (n0 - 1, "", "A"), (n0, "", "C"), (n0, seq[-1], ""),
            (n0 + 2, "", "G"), (n0 + 2, "AC", ""), (7, "", ""),
            (9, seq[9], seq[9])]
    muts += [(20, seq[20 : 20 + k % 3], "ACGT"[k % 4] * (k % 5))
             for k in range(12)]
    return [_mut(*m) for m in muts]


def _columnar_case(case):
    """(datas, muts_list, participate) of one case: three regions, each a
    session's sequence ('N' bases written into the third one's in the
    non_acgt case)."""
    rng = np.random.default_rng(17)
    pas = [_events(seed=s, ref_len=n, trim=False)
           for s, n in ((9, 150), (10, 120), (11, 170))]
    datas = [AlignData.from_session(pa) for pa in pas]
    seqs = [d.sequence for d in datas]
    if case == "refine":
        return datas, [find_point_mutations(d) for d in datas], [
            True, False, True]
    if case == "mutate":
        return datas, [_multi_base_muts(rng, s, 60) for s in seqs], [True] * 3
    if case == "edges":
        return datas, [_edge_muts(s) for s in seqs], [True] * 3
    # non_acgt: a non-ACGT mut in the second region, an 'N' in the third
    # region's sequence, the first region pure
    muts_list = [_multi_base_muts(rng, s, 30) + _muts(rng, s, 10)
                 for s in seqs]
    muts_list[1].append(_mut(12, seqs[1][12], "N"))
    seq2 = seqs[2][:40] + "N" + seqs[2][41:]
    datas = [SimpleNamespace(sequence=s) for s in seqs[:2] + [seq2]]
    return datas, muts_list, [True] * 3


def _per_object_groups(datas, muts_list, participate, S_r, evoff_r):
    """[((K, D), gp, idx_maps)] as the scorer assembled them from the JAX
    package's per-object helpers, one region at a time."""
    classes = jm._partition_classes(datas, muts_list, participate)
    out = []
    for key in sorted(classes):
        parts, g_S, g_region, g_evoff, idx_maps = [], [], [], [], []
        for r, (muts_c, idx_c) in enumerate(classes[key]):
            if not muts_c:
                continue
            part = jm._build_groups(datas[r].sequence, muts_c, key[0])
            G = part["g_start"].shape[0]
            parts.append(part)
            g_S.append(np.full(G, S_r[r], np.int32))
            g_region.append(np.full(G, r, np.int32))
            g_evoff.append(np.full(G, evoff_r[r], np.int32))
            idx_maps.append(np.asarray(idx_c, dtype=np.int64))
        gp = jm._pad_groups(parts, g_S, g_region)
        gp["g_evoff"][: gp["G"]] = np.concatenate(g_evoff)
        out.append((key, gp, idx_maps))
    return out


@pytest.mark.parametrize("case", ["refine", "mutate", "edges", "non_acgt"])
def test_columnar_groups_match_per_object_helpers(case):
    """The columnar builder's classes, padded group arrays (every key,
    dtype and value) and index maps equal what the JAX package's
    per-object helpers give; a (class, region) subset holding a non-ACGT
    base takes the per-object windows and only the others count as
    columnar."""
    datas, muts_list, participate = _columnar_case(case)
    S_r = np.array([len(d.sequence) - 4 for d in datas])
    evoff_r = np.array([0, 12, 30], dtype=np.int32)
    cols = tm._mut_columns(*tm._participants(datas, muts_list, participate))
    kd, members, per_object = tm._classes(cols)
    got = [(key, *tm._groups(cols, sel, per_object, key[0], S_r, evoff_r))
           for key, sel in zip(kd, members)]
    want = _per_object_groups(datas, muts_list, participate, S_r, evoff_r)
    assert [k for k, _, _ in got] == [k for k, _, _ in want]
    for (_, gp_t, im_t), (_, gp_j, im_j) in zip(got, want):
        _assert_same(gp_t, gp_j)
        assert type(gp_t["G"]) is int and type(gp_t["G_pad"]) is int
        _assert_same(im_t, im_j)
    if case == "mutate":
        assert {k for k, _ in kd} == {7, 16, 46, 160, 256}
        assert {d for _, d in kd} == {4, 32}

    # the columnar count leaves out exactly the subsets holding a non-ACGT
    # base, in their region's sequence or in one of their muts
    pure = lambda s: set(s) <= set("ACGT")
    want_n = sum(len(muts_c) for cls in jm._partition_classes(
        datas, muts_list, participate).values()
        for r, (muts_c, _) in enumerate(cls)
        if pure(datas[r].sequence) and all(pure(m.mut) for m in muts_c))
    assert int((~per_object).sum()) == want_n
    if case == "non_acgt":
        assert 0 < want_n < sum(map(len, muts_list)) - 1
    else:
        assert want_n == sum(len(m) for m, p in zip(muts_list, participate)
                             if p)

    ct = tm._partition_classes(datas, muts_list, participate)
    cj = jm._partition_classes(datas, muts_list, participate)
    assert list(ct) == sorted(cj)
    for key in ct:
        for (mt, it), (mj, ij) in zip(ct[key], cj[key]):
            assert [id(m) for m in mt] == [id(m) for m in mj] and it == ij


def test_score_write_back_is_the_assign_loop():
    """score_mutations_multi on a 3-region call (point mutations, multi-base
    ones with a non-ACGT mut, a region without mutations) returns what the
    per-slot assign loop gives on the same group totals, score for score
    with ==; the non-ACGT mut's subset is left out of the columnar count."""
    from torch.profiler import ProfilerActivity, profile

    from poreseq_tpu_torch import obs
    from poreseq_tpu_torch.core.regions import MutationInfo as TMut
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.types import AlignData as TAlignData
    from poreseq_tpu_torch.engine.types import make_mutscores

    rng = np.random.default_rng(4)
    pas = [_events(seed=s, ref_len=80, coverage=3, trim=False)
           for s in (21, 22, 23)]
    for pa in pas:
        pa.params.update(realign_width=12, scoring_width=6)
    seqs = [pa.sequence for pa in pas]

    def tmut(start, orig, mut):
        m = TMut()
        m.start, m.orig, m.mut = start, orig, mut
        return m

    points = find_point_mutations(AlignData.from_session(pas[0]))
    muts_list = [[tmut(m.start, m.orig, m.mut) for m in points[::3]],
                 [tmut(m.start, m.orig, m.mut)
                  for m in _multi_base_muts(rng, seqs[1], 20)]
                 + [tmut(30, seqs[1][30], "N")],
                 []]
    engine = TorchEngine("cpu", torch.float32)
    participate = [True, True, False]

    old = [make_mutscores(m) for m in muts_list]
    datas = [TAlignData.from_session(pa) for pa in pas]
    for gp, idx_maps, args in tm.group_launches(engine, datas, muts_list,
                                                participate):
        totals_h = tm.group_totals(*args).to(torch.float64).cpu().numpy()
        for g in range(gp["G"]):
            r = int(gp["g_region"][g])
            im = idx_maps[int(gp["g_part"][g])]
            for t in range(tm.P_SLOTS):
                mi = gp["s_idx"][g, t]
                if mi >= 0:
                    old[r][int(im[mi])].score += totals_h[g, t]

    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        new = tm.score_mutations_multi(
            engine, [TAlignData.from_session(pa) for pa in pas], muts_list)
    counts = obs._totals(obs.take())
    assert [len(m) for m in new] == [len(m) for m in muts_list]
    for a, b in zip(old, new):
        for x, y in zip(a, b):
            assert (x.start, x.orig, x.mut) == (y.start, y.orig, y.mut)
            assert x.score == y.score
    assert any(x.score != -1e-6 for x in new[0])
    n_bad = len(tm._partition_classes(datas, muts_list, participate)
                [(7, 4)][1][0])
    assert counts["psq.mutations_columnar"] == sum(map(len, muts_list)) - n_bad


def test_viterbi_host_helpers_match_jax():
    pa = _events(seed=5, trim=False)
    _assert_same(tv._position_stats(pa.events), jv._position_stats(pa.events))
    _assert_same(tv._build_T(0.05, 0.01), jv._build_T(0.05, 0.01))
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.integers(0, 3, 200)) % 1024
    states = np.array([(int(s) * 37) % 1024 for s in walk])
    assert tv._states_to_seq(states) == jv._states_to_seq(states)
    for b in (1, 2, 3, 5, 9, 16, 17, 40):
        assert tv._b_bucket(b) == jv._b_bucket(b)
