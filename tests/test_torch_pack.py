"""The port's NumPy host-helper copies equal the JAX package's originals,
array for array, and the torch batch upload round-trips."""

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
