"""The port's Viterbi candidate generator against the JAX package: the
observations and the sweep in f64 within 1e-9, the deterministic (nkeep=0)
string equal to the exact engine's, plausible stochastic candidates, a
NumPy model of the Gumbel kernel's threefry noise and row layout, and
candidates that do not depend on the batch a region is sampled in
(tests/test_torch_prng.py holds the noise to JAX's,
tests/test_torch_candidates.py the candidates to TpuEngine's)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu.api import swalign
from poreseq_tpu.engine.exact import ExactEngine
from poreseq_tpu.engine.tpu import viterbi as jv
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine import viterbi as tv
from test_torch_kernels_cuda import GUMBEL_SHAPES, _gumbel_grid_rows

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _session(seed, ref_len=150, coverage=6):
    return simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                            coverage=coverage)


def test_obs_and_sweep_match_jax_f64(x64):
    """Two regions of different lengths in one batch (the second's rows past
    its end pass the carry): obs, liks, fwds and the solo sweep's
    backpointers agree with the JAX programs."""
    evs = [_session(3)[0].events, _session(9, ref_len=110, coverage=4)[0]
           .events]
    stats = [tv._position_stats(e) for e in evs]
    R = max(len(s[0]) for s in stats)
    E = max(len(e) for e in evs)
    lvl = np.zeros((2, R, E))
    sd = np.zeros((2, R, E))
    valid = np.zeros((2, R, E), dtype=bool)
    tabs = np.stack([tv._model_tabs(e, E) for e in evs])
    n_real = np.array([len(s[0]) for s in stats])
    for b, (l, s, v) in enumerate(stats):
        lvl[b, : len(l), : l.shape[1]] = l
        sd[b, : len(l), : l.shape[1]] = s
        valid[b, : len(l), : l.shape[1]] = v
    obs_j = jv._obs_multi_fn()(*(jnp.asarray(x) for x in (lvl, sd, valid,
                                                          tabs)))
    obs_t = tv.obs_multi(*(torch.as_tensor(x) for x in (lvl, sd, valid,
                                                        tabs)))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0,
                               atol=1e-9)
    liks_j, fwds_j = jv._viterbi_sweep_multi(obs_j, jnp.asarray(n_real),
                                             0.05, 0.01)
    liks_t, fwds_t, _ = tv.viterbi_sweep(obs_t, torch.as_tensor(n_real),
                                         0.05, 0.01)
    np.testing.assert_allclose(liks_t.numpy(), np.asarray(liks_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(fwds_t.numpy(), np.asarray(fwds_j), rtol=0,
                               atol=1e-9)
    # backpointers of the solo sweep (the nkeep=0 path)
    n = int(n_real[0])
    _, bps_j, _ = jv._viterbi_sweep(obs_j[0, :n], n, 0.05, 0.01)
    _, _, bps_t = tv.viterbi_sweep(obs_t[:1, :n], torch.tensor([n]), 0.05,
                                   0.01, need_bp=True)
    np.testing.assert_array_equal(bps_t[0].numpy(), np.asarray(bps_j))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_deterministic_viterbi_matches_exact(dtype):
    pa, _ = _session(5)
    se = ExactEngine().viterbi_mutate(AlignData.from_session(pa).events, 0,
                                      0.05, 0.01, 0.33, 0.75)
    st = TorchEngine("cpu", dtype).viterbi_mutate(pa.events, 0, 0.05, 0.01,
                                                  0.33, 0.75)
    assert len(st) == 1 and st[0] == se[0]


def test_stochastic_candidates_plausible_and_seeded():
    pa, truth = _session(3)
    eng = TorchEngine("cpu", torch.float32, seed=7)
    seqs = eng.viterbi_mutate_multi([pa.events, []], 4, 0.05, 0.01, 0.33,
                                    0.75)
    assert len(seqs[0]) == 4 and seqs[1] == []
    for s in seqs[0]:
        # candidates seed proposals only; the engines produce ~55-65% here
        assert swalign(s, truth)[0] > 45.0
    # the draws depend on the engine's seed only
    assert eng.viterbi_mutate_multi([pa.events, []], 4, 0.05, 0.01, 0.33,
                                    0.75) == seqs


def _np_halving(x, levels, op):
    """NumPy halving tree over the last axis: level L pairs c with c + n/2."""
    out = []
    for _ in range(levels):
        n = x.shape[-1]
        x = op(x[..., : n // 2], x[..., n // 2 :])
        out.append(x)
    return out


def _np_first_argmax(v, s, ov, os):
    """(value, state) of the first maximum of two candidates."""
    take = (ov > v) | ((ov == v) & (os < s))
    return np.where(take, ov, v), np.where(take, os, s)


def _np_sweep_row(liks, fwd, ob, consts, exp, dt):
    """One sweep row in NumPy, on the halving tree: (newlik, f, bp).  The
    group reductions are levels 2, 4, 6 (state s reads index s >> 2j), the
    argmax keeps (value, state) pairs with the first state on ties."""
    lsp1, lsp2, lsp3, stay_lik, sp1, sp2, sp3, stay_p = (dt(c) for c in
                                                         consts)
    states = np.arange(1024)
    gm = _np_halving(liks, 6, np.maximum)
    gs = _np_halving(fwd, 6, np.add)
    v, s = liks, np.broadcast_to(states, liks.shape)
    ga = []
    for _ in range(6):
        h = v.shape[-1] // 2
        v, s = _np_first_argmax(v[..., :h], s[..., :h], v[..., h:],
                                s[..., h:])
        ga.append(s)
    at = lambda lv, j: lv[2 * j - 1][:, states >> (2 * j)]
    m = [at(gm, j) + c for j, c in ((1, lsp1), (2, lsp2), (3, lsp3))]
    mstay = liks + stay_lik
    newlik = ob + np.maximum(np.maximum(m[0], m[1]), np.maximum(m[2], mstay))
    bp, cur = at(ga, 1), m[0]
    for j in (2, 3):
        upd = m[j - 1] > cur
        bp, cur = np.where(upd, at(ga, j), bp), np.where(upd, m[j - 1], cur)
    bp = np.where(mstay > cur, states, bp)
    f = (((sp1 * at(gs, 1) + sp2 * at(gs, 2)) + sp3 * at(gs, 3))
         + stay_p * fwd)
    f = f * exp(ob)
    return newlik, f / _np_halving(f, 10, np.add)[-1], bp


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweep_twin_equals_numpy_halving_tree(dtype):
    """The twin's sweep, row by row, equals an independent NumPy model of a
    row on the halving tree bit for bit (liks, fwds and backpointers, a
    padded region and padded rows included).  exp comes from torch on the
    same [B, 1024] rows, so the model checks the reduction order and the
    expression trees, not a libm."""
    rng = np.random.default_rng(11)
    dt = np.float64 if dtype == torch.float64 else np.float32
    B, R = 4, 24
    obs = rng.normal(-3.0, 2.0, (B, R, 1024)).astype(dt)
    n_real = np.array([24, 17, 0, 9])
    liks_t, fwds_t, bps_t = tv.viterbi_sweep_reference(
        torch.from_numpy(obs), torch.from_numpy(n_real), 0.05, 0.01,
        need_bp=True)
    consts = tv.sweep_constants(0.05, 0.01)
    exp = lambda x: torch.exp(torch.from_numpy(x)).numpy()
    liks = np.zeros((B, 1024), dt)
    fwd = np.full((B, 1024), 1.0 / 1024.0, dt)
    for t in range(R):
        newlik, f, bp = _np_sweep_row(liks, fwd, obs[:, t], consts, exp, dt)
        np.testing.assert_array_equal(bps_t[:, t].numpy(), bp)
        v = (t < n_real)[:, None]
        liks, fwd = np.where(v, newlik, liks), np.where(v, f, fwd)
        assert fwd.dtype == dt
        np.testing.assert_array_equal(fwds_t[:, t].numpy(), fwd)
    np.testing.assert_array_equal(liks_t.numpy(), liks)


def test_tree_levels_are_the_predecessor_groups():
    """Levels 2, 4 and 6 of the halving tree under max are exactly the
    j-step group maxima (members c + k * (1024 >> 2j)) for j = 1, 2, 3."""
    V = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 1024)))
    lv = tv.halving_levels(V, 6, torch.maximum)
    for j in (1, 2, 3):
        n = 1 << (2 * j)
        group = V.reshape(3, n, 1024 >> (2 * j)).amax(dim=1)
        assert torch.equal(lv[2 * j - 1], group)
        assert torch.equal(tv._spread(lv[2 * j - 1], j),
                           torch.repeat_interleave(group, n, dim=1))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sampler_twin_equals_numpy_halving_tree(dtype):
    """The twin's sampled paths, and each row's scores, equal an
    independent NumPy model of a sampler row (T[cur] * f^atten,
    halving-tree total, log + Gumbel, first argmax) bit for bit; pow and log
    come from torch on the twin's shapes."""
    rng = np.random.default_rng(12)
    dt = np.float64 if dtype == torch.float64 else np.float32
    B, R, nk = 3, 20, 3
    fw = rng.random((B, R, 1024)) ** 4
    fwds = (fw / fw.sum(axis=2, keepdims=True)).astype(dt)
    n_real = np.array([20, 13, 0])
    valid = np.arange(R)[None, :] < n_real[:, None]
    fwds = np.where(valid[..., None], fwds, dt(1.0 / 1024.0))
    T = tv._build_T(0.05, 0.01).astype(dt)
    startst = rng.integers(0, 1024, B)
    attens = np.array([0.33 + 0.42 * k / nk for k in range(nk)], dt)
    t = torch.from_numpy
    got = tv.sample_paths_reference(t(T), t(fwds), t(valid), t(startst),
                                    t(attens), 7).numpy()
    eps = dt(1e-300)                     # 0 in float32, as torch casts it
    assert (eps == 0) == (dt == np.float32)
    cur = np.repeat(startst[:, None], nk, axis=1)
    for i in range(R - 1, -1, -1):
        np.testing.assert_array_equal(got[:, :, i], cur)
        gumbel = tv.gumbel_reference(7, nk, torch.tensor([i]),
                                     dtype)[:, 0].numpy()     # [nk, 1024]
        f = (t(fwds[:, i])[:, None, :] ** t(attens)[None, :, None]).numpy()
        p = T[cur] * f
        p = p / _np_halving(p, 10, np.add)[-1]
        x = torch.log(t(p + eps)).numpy() + gumbel[None]
        np.testing.assert_array_equal(
            tv.draw_scores(t(T), t(fwds[:, i]), t(cur), t(attens),
                           t(gumbel)).numpy(), x)
        v, s = x, np.broadcast_to(np.arange(1024), x.shape)
        for _ in range(10):
            h = v.shape[-1] // 2
            v, s = _np_first_argmax(v[..., :h], s[..., :h], v[..., h:],
                                    s[..., h:])
        cur = np.where(valid[:, i][:, None], s[..., 0], cur)


@pytest.mark.parametrize("dtype,coverages", [
    (torch.float64, (6, 4, 5)),
    # equal event counts: E_pad adds no padding, so only the draws differ
    (torch.float32, (5, 5, 5))])
def test_candidates_do_not_depend_on_the_batch(dtype, coverages):
    """A region's sampled candidates are the same alone, inside [A, B, C]
    and inside [C, A] (its slot, the batch bucket and the padded row count
    all change)."""
    A, B, C = (_session(seed, ref_len=n, coverage=c)[0].events
               for seed, n, c in zip((3, 9, 4), (150, 110, 200), coverages))
    eng = TorchEngine("cpu", dtype, seed=7)
    run = lambda evs: eng.viterbi_mutate_multi(evs, 16, 0.05, 0.01, 0.33,
                                               0.75)
    solo = [run([x])[0] for x in (A, B, C)]
    assert all(len(s) == 16 for s in solo)
    assert run([A, B, C]) == solo
    assert run([C, A]) == [solo[2], solo[0]]


# ------------------------------------------------ the kernels' lane layout

# levels 1..LEVELS_IN[team] are in-thread (common.cuh thread_levels): the
# sweep's team of 8 warps and the sampler's 4
LEVELS_IN = {4: 3, 8: 2}


def _lanes(x, team):
    """[..., 1024] -> [..., team, 32, 32 / team]: warp w, lane l, slot q
    holds state l + 32 (w + team q) (common.cuh team_state)."""
    w = np.arange(team)[:, None, None]
    l = np.arange(32)[None, :, None]
    q = np.arange(32 // team)[None, None, :]
    return x[..., l + 32 * (w + team * q)]


def _from_lanes(x, team):
    """[..., team, 32, nq] slot values back to tree index l + 32(w + team q)."""
    nq = x.shape[-1]
    out = np.empty(x.shape[:-3] + (32 * team * nq,), x.dtype)
    w = np.arange(team)[:, None, None]
    l = np.arange(32)[None, :, None]
    q = np.arange(nq)[None, None, :]
    out[..., l + 32 * (w + team * q)] = x
    return out


def _team_tree(xs, team, op, planted=False):
    """NumPy model of the Viterbi kernels' reductions (common.cuh
    thread_levels, exchange_levels, the shuffles): xs a tuple of [..., 1024]
    arrays (value, or value and state), op on such tuples.  In-thread levels
    pair slot q with q + n; the exchange hands every warp the team's values;
    level 6 is a shfl_down by 16; the total takes levels 6-10 by xor
    shuffles, each lane's own value first.  Returns ({2, 4, 6: level by
    tree index}, [..., 32] every lane's total).  planted pairs q with
    (q + n) ^ 1 at level 1 (a wrong tree)."""
    cut = lambda t, a, b: tuple(v[..., a:b] for v in t)
    x = tuple(_lanes(v, team) for v in xs)
    got = {}
    for L in range(1, LEVELS_IN[team] + 1):
        n = (16 >> (L - 1)) // team
        other = cut(x, n, 2 * n)
        if planted and L == 1 and n > 1:
            other = tuple(v[..., np.arange(n, 2 * n) ^ 1] for v in x)
        x = op(cut(x, 0, n), other)
        if L in (2, 4):
            got[L] = tuple(_from_lanes(v, team) for v in x)
    y = tuple(np.swapaxes(v[..., 0], -1, -2) for v in x)   # [..., 32, team]
    for L in range(LEVELS_IN[team] + 1, 6):
        n = 16 >> (L - 1)
        y = op(cut(y, 0, n), cut(y, n, 2 * n))
        if L == 4:
            got[4] = tuple(np.swapaxes(v, -1, -2).reshape(v.shape[:-2] + (64,))
                           for v in y)
    v5 = tuple(v[..., 0] for v in y)                        # lane l: c = l
    got[6] = op(cut(v5, 0, 16), cut(v5, 16, 32))
    tot, lanes = v5, np.arange(32)
    for off in (16, 8, 4, 2, 1):
        tot = op(tot, tuple(v[..., lanes ^ off] for v in tot))
    return got, tot


def _np_first_of(a, b):
    v, s = _np_first_argmax(a[0], a[1], b[0], b[1])
    return v, s


@pytest.mark.parametrize("team", [4, 8])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lane_layout_model_equals_halving_tree(team, dtype):
    """The kernels' lane layout (lane l holds states l + 32m, levels
    in-thread, one exchange, shuffles) gives the twins' halving tree bit for
    bit: the sweep's group sums, maxima and first argmaxima (levels 2, 4,
    6), the sampler's total on every lane and its first argmax; a planted
    pairing change does not."""
    rng = np.random.default_rng(team)
    x = np.exp(rng.normal(0.0, 6.0, (5, 1024))).astype(dtype)
    ties = rng.integers(-30, 4, (5, 1024)).astype(dtype)
    states = np.broadcast_to(np.arange(1024), x.shape)
    add = lambda a, b: (a[0] + b[0],)
    mxo = lambda a, b: (np.maximum(a[0], b[0]),)
    ref_s = _np_halving(x, 10, np.add)
    ref_m = _np_halving(ties, 6, np.maximum)
    ref_a, v, s = [], ties, states
    for _ in range(10):
        h = v.shape[-1] // 2
        v, s = _np_first_argmax(v[..., :h], s[..., :h], v[..., h:], s[..., h:])
        ref_a.append(s)
    got_s, tot = _team_tree((x,), team, add)
    got_m, _ = _team_tree((ties,), team, mxo)
    got_a, best = _team_tree((ties, states), team, _np_first_of)
    for L in (2, 4, 6):
        np.testing.assert_array_equal(got_s[L][0], ref_s[L - 1])
        np.testing.assert_array_equal(got_m[L][0], ref_m[L - 1])
        np.testing.assert_array_equal(got_a[L][1], ref_a[L - 1])
    np.testing.assert_array_equal(tot[0], np.repeat(ref_s[9], 32, axis=1))
    np.testing.assert_array_equal(best[1], np.repeat(ref_a[9], 32, axis=1))
    assert (ties == ties.max(axis=1, keepdims=True)).sum() > 5   # ties exist
    planted, _ = _team_tree((x,), team, add, planted=True)
    assert not np.array_equal(planted[2][0], ref_s[1])


@pytest.mark.parametrize("skip_stay", [(0.05, 0.01), (0.141, 0.043),
                                       (0.088, 0.057)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_transition_table_equals_build_T(skip_stay, dtype):
    """The sampler's 17 values of T, made from (skip, stay) in f64 and cast
    to the working type as the kernel's launch casts them, indexed by the
    step mask and the diagonal of every (cur, p), equal _build_T cast to
    that type over all 1024 x 1024 pairs (the main path's skip/stay and two
    of train's)."""
    T = tv._build_T(*skip_stay)
    tab = np.array(tv.transition_table(*skip_stay))
    assert tab.shape == (17,) and tab.dtype == np.float64
    idx = tv.transition_index(np.arange(1024)[:, None],
                              np.arange(1024)[None, :])
    np.testing.assert_array_equal(tab[idx], T)
    got = torch.as_tensor(tab).to(dtype).numpy()[idx]
    np.testing.assert_array_equal(
        got, tv.transition_matrix(*skip_stay, dtype, "cpu").numpy())


def _np_threefry(k0, k1, x0, x1):
    """threefry2x32 on uint32 arrays, as csrc/viterbi_gumbel.cu:threefry
    computes it: wrapping adds, rotations, the key injected after every 4
    rounds with its count."""
    rot = lambda x, r: (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for n, rots in enumerate([(13, 15, 26, 6), (17, 29, 16, 24)] * 2
                                 + [(13, 15, 26, 6)]):
            for r in rots:
                x0 = x0 + x1
                x1 = rot(x1, r) ^ x0
            x0 = x0 + ks[(n + 1) % 3]
            x1 = x1 + ks[(n + 2) % 3] + np.uint32(n + 1)
    return x0, x1


def _np_noise(a, b, dtype):
    """The kernel's noise of the rows under keys (a, b) [n] uint32: [n,
    1024], -log(-log(u)) with u from the fraction bits set into 1.m, less
    1, times (1 - tiny) plus tiny, at least tiny (the logs by torch)."""
    s = np.arange(1024, dtype=np.uint32)
    zero = np.zeros(1024, dtype=np.uint32)
    y0, y1 = _np_threefry(a[:, None], b[:, None], zero, s)
    if dtype == torch.float64:
        m = (y0.astype(np.uint64) << np.uint64(20)) | (y1 >> np.uint32(12))
        f = (m | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
    else:
        m = (y0 ^ y1) >> np.uint32(9)
        f = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    tiny = np.finfo(f.dtype).tiny
    u = np.maximum(f * (f.dtype.type(1) - tiny) + tiny, tiny)
    return (-torch.log(-torch.log(torch.from_numpy(u)))).numpy()


def _gumbel_kernel_model(seed, nk, R):
    """NumPy model of gumbel_kernel's launch: rows = nk R rows of 1024
    states, min(ceil(rows / RB), 132 SM_BLOCKS) blocks of NT threads, RB =
    NT / 256 rows a block at once, a warp's rows base, base + stride, ...
    (stride = blocks RB) taken 32 a pass: lane j derives the key of its
    pass's row base + j stride (k = r / R, i = r - k R in uint32; split
    then fold_in) and row j of the pass takes lane j's key.  Every warp of a
    row writes its 32 x 4 states.  Returns (how often each row was
    written, the row keys (a, b) as the lanes derived them)."""
    nt, sm_blocks = _cu_consts("viterbi_gumbel", "NT", "SM_BLOCKS")
    rb = nt // 256
    rows = nk * R
    blocks = min(-(-rows // rb), 132 * sm_blocks)
    stride = blocks * rb
    # a thread's 4 states, over the 256 threads of a row: each state once
    t = np.arange(256)
    assert np.array_equal(np.sort((4 * t[:, None] + np.arange(4)).ravel()),
                          np.arange(1024))
    first = np.arange(blocks)[:, None] * rb + np.arange(rb)[None, :]
    passes = -(-rows // (32 * stride))
    base = (first.ravel()[None, :]
            + 32 * stride * np.arange(passes)[:, None]).ravel()
    base = base[base < rows]
    rj = base[:, None] + stride * np.arange(32)[None, :]     # [warp pass, j]
    lane_rows = rj[rj < rows].astype(np.uint32)
    k = lane_rows // np.uint32(R)
    i = lane_rows - k * np.uint32(R)
    zero = np.zeros_like(k)
    key0, key1 = (np.uint32(seed >> 32 & 0xFFFFFFFF),
                  np.uint32(seed & 0xFFFFFFFF))
    a, b = _np_threefry(key0, key1, zero, k)                # split
    a, b = _np_threefry(a, b, zero, i)                      # fold_in
    # rows written in a pass: row j of it (j < n) under lane j's key
    n = np.minimum(32, (rows - 1 - base) // stride + 1)
    written = rj[np.arange(32)[None, :] < n[:, None]]
    keys = (np.zeros(rows, np.uint32), np.zeros(rows, np.uint32))
    keys[0][written], keys[1][written] = a, b
    return np.bincount(written, minlength=rows), keys


@pytest.mark.parametrize("shape", list(GUMBEL_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gumbel_kernel_indexing_model(shape, dtype):
    """A model of the Gumbel kernel's row layout (its block count, the
    grid-stride loop over rows, each warp's row keys derived 32 rows at a
    time and handed lane to lane, a thread's 4 states) writes every row
    of the twin's [nk, R, 1024] block once under its own key, and its
    threefry noise equals the twin's element by element: nk R below, equal
    to and above the rows the grid takes in one pass and in one pass of
    row keys (32 rows a warp), R = 1 and nk = 1
    (test_torch_kernels_cuda.GUMBEL_SHAPES, held on the card there).  Past
    4,096 rows the noise is compared on the first and last 64 rows of each
    key pass and around the grid's pass ends."""
    nk, R = GUMBEL_SHAPES[shape](_gumbel_grid_rows())
    visits, (a, b) = _gumbel_kernel_model(7, nk, R)
    rows = nk * R
    assert np.all(visits == 1)
    G = _gumbel_grid_rows()
    if rows <= 4096:
        check = np.arange(rows)
    else:
        edges = np.arange(0, rows, G)
        check = np.unique(np.concatenate(
            [np.arange(64), rows - 64 + np.arange(64), edges, edges - 1,
             (np.arange(0, rows, 32 * G)[:, None]
              + np.arange(-64, 64)[None, :]).ravel()]))
        check = check[(check >= 0) & (check < rows)]
    k, i = check // R, check % R
    ii = np.unique(i)
    ref = tv.gumbel_reference(7, nk, torch.as_tensor(ii), dtype).numpy()
    np.testing.assert_array_equal(_np_noise(a[check], b[check], dtype),
                                  ref[k, np.searchsorted(ii, i)])


def test_smoke_holds_the_gumbel_kernel_at_the_test_shapes():
    """chip_smoke.py's phase 2 holds the Gumbel kernel to its twin at the
    shapes the model above and the card's test take."""
    import chip_smoke

    G = _gumbel_grid_rows()
    assert chip_smoke.gumbel_shapes() == {
        name: shape(G) for name, shape in GUMBEL_SHAPES.items()}


def _order_key(v):
    """NumPy model of common.cuh order_key: NaN on top, -0 as +0, the
    sign-magnitude bits made monotone."""
    bits = {np.float32: (np.uint32, 31), np.float64: (np.uint64, 63)}
    ut, top = bits[v.dtype.type]
    u = (v + v.dtype.type(0)).view(ut)
    neg = (u >> ut(top)) == 1
    key = np.where(neg, ~u, u | (ut(1) << ut(top)))
    return np.where(np.isnan(v), np.iinfo(ut).max, key)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_argmax_order_key_equals_torch_argmax(dtype):
    """The sampler's argmax (the largest order key, then the smallest state
    among its holders) is torch.argmax's first maximum: NaN first, -0 equal
    to +0, ties to the smaller index."""
    rng = np.random.default_rng(3)
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5,
                        np.finfo(dtype).tiny / 4, -np.finfo(dtype).max],
                       dtype)
    for _ in range(200):
        v = rng.choice(special, 64)
        if rng.random() < 0.5:
            v = np.where(np.isnan(v), dtype(2.0), v)
        key = _order_key(v)
        got = int(np.nonzero(key == key.max())[0][0])
        assert got == int(torch.argmax(torch.from_numpy(v))), v
    x = rng.normal(size=4096).astype(dtype)
    order = np.argsort(_order_key(x), kind="stable")
    assert np.all(np.diff(x[order]) >= 0)


def _div_total(a, tot):
    """NumPy model of common.cuh div_total: a zero numerator is not divided
    (0 / tot is that zero for a positive finite tot), and an f32 quotient
    is taken in f64 and rounded to f32."""
    ok = (tot > 0) & np.isfinite(tot)
    zero = (a == 0) & ok
    wide = np.float64 if a.dtype == np.float32 else a.dtype.type
    q = (np.where(zero, 1, a).astype(wide) / wide(tot)).astype(a.dtype)
    return np.where(zero, a, q)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_div_total_is_the_divide(dtype):
    """The kernels' row-total divide gives the divide's bits: zeros of either
    sign, subnormal and normal numerators, exact quotients and subnormal
    midpoints, over positive, zero, infinite and NaN totals."""
    rng = np.random.default_rng(8)
    fi = np.finfo(dtype)
    mant = rng.random(20000) + 0.5
    expo = rng.integers(fi.minexp - fi.nmant - 2, 4, 20000)
    a = (mant * np.exp2(expo.astype(np.float64))).astype(dtype)
    a[::7] = 0
    a[1::7] = -0.0
    a[2::7] = fi.smallest_subnormal * rng.integers(1, 64, a[2::7].size)
    sub_mid = np.array([9, 15, 21], dtype) * fi.smallest_subnormal  # / 6
    with np.errstate(divide="ignore", invalid="ignore"):
        for tot in (dtype(1), dtype(6), dtype(0.37), dtype(1e-3),
                    dtype(3.0e4), dtype(0), dtype(np.inf), dtype(np.nan)):
            for x in (a, sub_mid):
                got, ref = _div_total(x, tot), x / tot
                assert got.dtype == ref.dtype
                np.testing.assert_array_equal(got.view(f"u{got.itemsize}")[
                    ~np.isnan(ref)], ref.view(f"u{ref.itemsize}")[
                    ~np.isnan(ref)])
                assert np.array_equal(np.isnan(got), np.isnan(ref))


def _np_trimmed_mean(per, valid):
    """NumPy model of the observation trim, one (region, row, state) at a
    time: the nskip smallest (value, event index) pairs of the valid events
    dropped, the rest summed in event index order, over max(nlik - nskip,
    1)."""
    B, R, E, S = per.shape
    one = per.dtype.type
    out = np.zeros((B, R, S), dtype=per.dtype)
    for b in range(B):
        for r in range(R):
            ev = np.nonzero(valid[b, r])[0]
            nlik = len(ev)
            nskip = nlik // 4
            if nskip > nlik - 2 or nlik <= 1:
                nskip = 0
            for s in range(S):
                order = np.lexsort((ev, per[b, r, ev, s]))
                tot = one(0)
                for e in np.sort(ev[order[nskip:]]):
                    tot = tot + per[b, r, e, s]
                out[b, r, s] = tot / one(max(nlik - nskip, 1))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_trimmed_mean_twin_equals_numpy_model(dtype):
    """The twin's drop rule and sum order, bit for bit: rows with nlik = 0,
    1, 2, 3, 5, 8, 9 and 13 valid events of 16, values drawn from a few
    magnitudes so that ties are common and the sum's order shows in its
    bits."""
    rng = np.random.default_rng(11)
    B, E, S = 2, 16, 24
    counts = [0, 1, 2, 3, 5, 8, 9, 13]
    valid = np.zeros((B, len(counts), E), dtype=bool)
    for b in range(B):
        for r, n in enumerate(counts):
            valid[b, r, rng.choice(E, n, replace=False)] = True
    pool = np.array([-3.7, -3.7, -0.1, 0.3, 2.2, 1e7, -1e-3, 41.9])
    per = rng.choice(pool, (B, len(counts), E, S)).astype(dtype)
    per += (rng.random(per.shape) < 0.3) * rng.random(per.shape).astype(
        dtype)
    got = tv.trimmed_mean(torch.as_tensor(per), torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), _np_trimmed_mean(per, valid))


def _cu_consts(src, *names):
    """The integer constants `constexpr int NAME = n;` of csrc/<src>.cu."""
    text = (Path(tv.__file__).resolve().parents[1] / "csrc"
            / f"{src}.cu").read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in names]


def _np_obs_tiled_row(per, ok):
    """NumPy model of one row of csrc/viterbi_obs.cu's tiled path on a slice
    of states: per [E, S] the row's emissions, ok [E] its valid flags.  The
    valid events compacted in event order, nskip passes each dropping the
    first least value not yet dropped, the kept summed in that order."""
    one = per.dtype.type
    v = per[np.nonzero(ok)[0]]                          # [nlik, S]
    nlik, S = v.shape
    nskip = nlik // 4
    if nskip > nlik - 2 or nlik <= 1:
        nskip = 0
    drop = np.zeros((nlik, S), dtype=bool)
    for _ in range(nskip):
        mv, mj = np.full(S, np.inf, per.dtype), np.full(S, -1)
        for j in range(nlik):
            take = ~drop[j] & ((mj < 0) | (v[j] < mv))
            mv, mj = np.where(take, v[j], mv), np.where(take, j, mj)
        drop[mj, np.arange(S)] = True
    acc = np.zeros(S, dtype=per.dtype)
    for j in range(nlik):
        acc = np.where(drop[j], acc, acc + v[j])
    return acc / one(max(nlik - nskip, 1))


def _np_before(a, ia, b, ib):
    return (a < b) | ((a == b) & (ia < ib))


# modes of viterbi_obs.cu's chunked selection (its enum Mode)
_SUM, _KEYED, _COLLECT, _RADIX = range(4)


def _np_collect(per, ev, inb, kbuf):
    """The chunked instance's collect pass on per [E, S] at the valid events
    ev: per state, the sorted register list (value, index) of the kbuf
    smallest pairs in its bucket (inb [nlik, S]), filled by insertion in
    event order.  Returns the list (bv, bi) [kbuf, S]."""
    S = per.shape[1]
    bv = np.full((kbuf, S), np.inf, per.dtype)
    bi = np.full((kbuf, S), np.iinfo(np.int32).max)
    for j, e in enumerate(ev):
        x, xi = per[e].copy(), np.full(S, e)
        go = inb[j] & _np_before(x, xi, bv[-1], bi[-1])
        for k in range(kbuf):
            sw = go & _np_before(x, xi, bv[k], bi[k])
            bv[k], x = np.where(sw, x, bv[k]), np.where(sw, bv[k], x)
            bi[k], xi = np.where(sw, xi, bi[k]), np.where(sw, bi[k], xi)
    return bv, bi


def _np_obs_chunk_row(per, ok, kbuf, digit):
    """NumPy model of one row of viterbi_obs.cu's chunked instance on a
    slice of states (per [E, S] the row's emissions, ok [E] its valid
    flags).  The drop threshold, the nskip-th smallest (value, index), by
    passes over the events: a state whose rank is at most kbuf collects its
    bucket's smallest kbuf pairs (the threshold is the rank-th); else it
    counts its bucket's order keys by the next `digit` bits, keeps the digit
    where the rank falls and the rank within it, and goes on until the rank
    is at most kbuf or the key is whole (the threshold is then the rank-th
    pair of that key in event order); the pairs after the threshold are
    summed in event order.  Returns (obs [S], passes, the states' final
    modes)."""
    one = per.dtype.type
    E, S = per.shape
    ev = np.nonzero(ok)[0]
    nlik = len(ev)
    nskip = nlik // 4
    if nskip > nlik - 2 or nlik <= 1:
        nskip = 0
    keys = _order_key(per[ev]) if nlik else np.zeros((0, S), np.uint64)
    kt = _order_key(per[:1]).dtype.type
    keys = keys.astype(kt)
    bits, nb = 8 * np.dtype(kt).itemsize, 1 << digit
    mode = np.full(S, _SUM if nskip == 0 else
                   _COLLECT if nskip <= kbuf else _RADIX)
    rank, sh = np.full(S, nskip), np.full(S, bits - digit)
    pfx, hi = np.zeros(S, kt), np.zeros(S, kt)
    tv, ti = np.full(S, -np.inf, per.dtype), np.full(S, -1)
    passes = 0
    while (mode >= _COLLECT).any():
        passes += 1
        inb = ((keys ^ pfx) & hi) == 0                  # [nlik, S]
        rad, col = mode == _RADIX, mode == _COLLECT
        if rad.any():
            s = np.where(rad, sh, 0).astype(kt)
            dig = (keys >> s) & kt(nb - 1)
            cnt = np.stack([((dig == d) & inb).sum(axis=0)
                            for d in range(nb)])         # [nb, S]
            cum = np.cumsum(cnt, axis=0)
            dsel = np.argmax(cum >= rank, axis=0)
            assert (cum[-1] >= rank)[rad].all()
            below = cum[dsel, np.arange(S)] - cnt[dsel, np.arange(S)]
            r2 = rank - below
            p2 = pfx | (dsel.astype(kt) << s)
            h2 = hi | (kt(nb - 1) << s)
            m2 = np.where(r2 <= kbuf, _COLLECT,
                          np.where(sh - digit < 0, _KEYED, _RADIX))
            rank, pfx, hi = (np.where(rad, a, b) for a, b in
                             ((r2, rank), (p2, pfx), (h2, hi)))
            sh = np.where(rad, sh - digit, sh)
        if col.any():
            bv, bi = _np_collect(per, ev, inb, kbuf)
            pick = np.clip(rank - 1, 0, kbuf - 1)
            tv = np.where(col, bv[pick, np.arange(S)], tv)
            ti = np.where(col, bi[pick, np.arange(S)], ti)
        mode = np.where(col, _SUM, np.where(rad, m2, mode) if rad.any()
                        else mode)
    acc = np.zeros(S, dtype=per.dtype)
    seen = np.zeros(S, dtype=int)
    keyed = mode == _KEYED
    for j, e in enumerate(ev):
        eq = keys[j] == pfx
        seen = np.where(keyed & eq, seen + 1, seen)
        keep = np.where(keyed, (keys[j] > pfx) | (eq & (seen > rank)),
                        _np_before(tv, ti, per[e], e))
        acc = np.where(keep, acc + per[e], acc)
    return acc / one(max(nlik - nskip, 1)), passes, mode


def _np_obs_grid(per, valid, instance):
    """NumPy model of csrc/viterbi_obs.cu's grid for one instance: "tiled"
    and "tiled64" (a block: NS states x RT rows of one region, its thread
    group g of RG taking rows g, g + RG, ... of the tile; tiled64 at
    RG_WIDE, and in f64 NS_WIDE_F64 states), "chunked" (a block: 32 states
    x CR rows, a warp a row).  Asserts that every (region, row, state) is
    written exactly once; returns obs [B, R, 1024]."""
    ns, ns64, rg, rgw, rt, cr, kbuf, digit = _cu_consts(
        "viterbi_obs", "NS", "NS_WIDE_F64", "RG", "RG_WIDE", "RT", "CR",
        "KBUF", "DIGIT")
    B, R, E, S = per.shape
    out = np.full((B, R, S), np.nan, dtype=per.dtype)
    hits = np.zeros((B, R, S), dtype=int)
    if instance in ("tiled", "tiled64"):
        if instance == "tiled64":
            rg = rgw
            ns = ns if per.dtype == np.float32 else ns64
        blocks = [(z, range(y * rt + g, min(y * rt + rt, R), rg), x * ns, ns)
                  for z in range(B) for y in range(-(-R // rt))
                  for x in range(S // ns) for g in range(rg)]
        row = _np_obs_tiled_row
    else:
        blocks = [(z, range(r, r + 1), x * 32, 32)
                  for z in range(B) for y in range(-(-R // cr))
                  for r in range(y * cr, min(y * cr + cr, R))
                  for x in range(S // 32)]
        row = lambda p, ok: _np_obs_chunk_row(p, ok, kbuf, digit)[0]
    for z, rows, s0, n in blocks:
        for r in rows:
            out[z, r, s0:s0 + n] = row(per[z, r, :, s0:s0 + n], valid[z, r])
            hits[z, r, s0:s0 + n] += 1
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("B,R,E", [(1, 1, 8), (8, 3, 31), (1, 33, 32),
                                   (2, 37, 33), (1, 41, 40), (1, 9, 63),
                                   (1, 10, 64), (1, 9, 65), (1, 9, 100)])
def test_obs_kernel_grid_model_equals_twin(B, R, E, dtype):
    """The observation kernel's decomposition, bit for bit against
    obs_multi_reference, in every instance whose cap holds E_pad: R = 1,
    B = 8 and R not a multiple of the row tile; E_pad at and around the
    tiled instance's cap of 32 and the tiled64 instance's of 64, 40 and 100
    (rows reach nskip 9-25, past the chunked instance's register list: its
    histogram passes).  Each region has rows with no valid event and with
    every event valid; event 1 is a copy of event 0 (ties), and a stdv is 0
    now and then (the clamp)."""
    cap, cap_w = _cu_consts("viterbi_obs", "CAP", "CAP_WIDE")
    assert (E <= cap) == (E in (8, 31, 32))
    assert tv.obs_path(E)[1] == ("tiled" if E <= cap else
                                 "tiled64" if E <= cap_w else "chunked")
    rng = np.random.default_rng(E)
    lvl = rng.normal(60, 8, (B, R, E))
    sd = np.where(rng.random((B, R, E)) < 0.05, 0.0,
                  rng.uniform(0.5, 3, (B, R, E)))
    counts = rng.integers(0, E + 1, (B, R))
    counts[:, 0] = E
    counts[:, -1] = 0 if R > 1 else E
    if R > 2:
        counts[:, 1] = min(E, 38)
    valid = np.zeros((B, R, E), dtype=bool)
    for b in range(B):
        for r in range(R):
            valid[b, r, rng.choice(E, counts[b, r], replace=False)] = True
    lm, ls = rng.normal(60, 8, (B, E, 1024)), rng.uniform(1, 3, (B, E, 1024))
    sm, lam = rng.uniform(0.8, 2, (B, E, 1024)), rng.uniform(1, 4,
                                                             (B, E, 1024))
    tabs = np.stack([lm, ls, np.log(ls), sm, lam, np.log(lam)], 1)
    lvl[:, :, 1], sd[:, :, 1] = lvl[:, :, 0], sd[:, :, 0]
    tabs[:, :, 1] = tabs[:, :, 0]
    ops = [torch.as_tensor(x.astype(dtype)) for x in (lvl, sd)]
    ops.insert(2, torch.as_tensor(valid))
    ops.append(torch.as_tensor(tabs.astype(dtype)))
    ref = tv.obs_multi_reference(*ops).numpy()
    per = tv.obs_emissions(ops[0], ops[1], ops[3]).numpy()
    ran = [name for c, name in tv.OBS_PATHS if c is None or E <= c]
    for name in ran:
        np.testing.assert_array_equal(_np_obs_grid(per, valid, name), ref)
    assert ran[-1] == "chunked" and len(ran) == 3 - (E > cap) - (E > cap_w)
    nlik = valid.sum(axis=2)
    assert (nlik == E).any() and (R == 1 or (nlik == 0).any())
    if E >= 40:
        assert (nlik // 4 > 8).any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("E,counts", [(40, (40, 39, 36, 12, 2, 1, 0)),
                                      (100, (100, 97, 64, 37, 36, 5))])
def test_obs_bisect_threshold_equals_twin(E, counts, dtype):
    """The chunked instance's selection past its register list (nskip >
    KBUF; the general path's order-key bisection before it): histogram
    passes over the order keys' digits, then a collect pass or, where more
    than KBUF equal keys remain, the threshold key's rank in event order,
    on rows of `counts` valid events of E.  Values are drawn from a few
    magnitudes with -0 and +0 among them, so that equal keys (ties by
    index) are common; the row model equals the twin's trim bit for bit,
    and both ends of the selection (a collect pass after histogram passes,
    a whole key) are reached."""
    kbuf, digit = _cu_consts("viterbi_obs", "KBUF", "DIGIT")
    rng = np.random.default_rng(E)
    S = 64
    pool = np.array([-3.7, -3.7, -0.0, 0.0, 0.3, 2.2, 1e7, -1e-3, -41.9])
    per = rng.choice(pool, (1, len(counts), E, S)).astype(dtype)
    per += (rng.random(per.shape) < 0.2) * rng.normal(size=per.shape)
    per = per.astype(dtype)
    valid = np.zeros((1, len(counts), E), dtype=bool)
    for r, n in enumerate(counts):
        valid[0, r, rng.choice(E, n, replace=False)] = True
    ref = tv.trimmed_mean(torch.as_tensor(per), torch.as_tensor(valid))
    modes, passes = set(), []
    for r, n in enumerate(counts):
        got, p, mode = _np_obs_chunk_row(per[0, r], valid[0, r], kbuf, digit)
        np.testing.assert_array_equal(got, ref[0, r].numpy())
        modes |= set(mode.tolist())
        passes.append(p)
    assert max(counts) // 4 > kbuf
    assert {_SUM, _KEYED} <= modes and max(passes) > 2


def test_obs_paths_follow_the_kernel_constants():
    """obs_path's caps are csrc/viterbi_obs.cu's CAP and CAP_WIDE; past
    them any event count takes the chunked instance."""
    cap, cap_w = _cu_consts("viterbi_obs", "CAP", "CAP_WIDE")
    got = [tv.obs_path(E) for E in (1, cap, cap + 1, cap_w, cap_w + 1,
                                    8193, 12289, 1 << 20)]
    assert got == [(0, "tiled")] * 2 + [(1, "tiled64")] * 2 + [
        (2, "chunked")] * 4


@pytest.mark.parametrize("instance,E,match", [
    ("tiled", 33, "at most"), ("tiled64", 65, "at most"),
    ("staged", 33, "none of")])
def test_obs_kernel_wrapper_refuses_an_instance_below_e_pad(instance, E,
                                                            match):
    """obs_multi_cuda refuses an instance whose cap (OBS_PATHS) is below
    E_pad, or a name OBS_PATHS does not hold, before anything is launched
    (CPU operands reach the refusal)."""
    B, R = 1, 4
    lvl = torch.zeros((B, R, E))
    valid = torch.ones((B, R, E), dtype=torch.bool)
    tabs = torch.zeros((B, 6, E, 1024))
    n = tv.VITERBI_OBS.launches
    with pytest.raises(ValueError, match=match):
        tv.obs_multi_cuda(lvl, lvl, valid, tabs, instance=instance)
    assert tv.VITERBI_OBS.launches == n


def _jax_obs_case(evs):
    """One region's observation operands ([1, R, E] level data and its
    model tables) from a session's events."""
    lvl, sd, valid = tv._position_stats(evs)
    return [x[None] for x in (lvl, sd, valid)] + [
        tv._model_tabs(evs, len(evs))[None]]


@pytest.mark.parametrize("coverage", [48, 100])
def test_obs_and_sweep_match_jax_past_the_tiled_cap(x64, coverage):
    """Regions of one event row a read at 48 and 100 reads (E_pad past the
    tiled instance's 32 events: the tiled64 and the chunked instance on the
    card), 120 b, 90 % of the levels anchored: the twin's obs, liks and
    fwds equal
    _obs_multi_fn's and _viterbi_sweep_multi's within 1e-9 in f64, on rows
    that drop more than 8 events."""
    # most levels anchored, so that rows hold most reads' events
    evs = simulate_session(np.random.default_rng(coverage), ref_len=120,
                           coverage=coverage, seed_subsample=0.9)[0].events
    ops = _jax_obs_case(evs)
    nlik = ops[2].sum(axis=2)
    assert ops[0].shape[2] == coverage and (nlik // 4 > 8).any()
    assert tv.obs_path(coverage)[1] == ("tiled64" if coverage <= 64
                                        else "chunked")
    obs_j = jv._obs_multi_fn()(*(jnp.asarray(x) for x in ops))
    obs_t = tv.obs_multi(*(torch.as_tensor(x) for x in ops))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0,
                               atol=1e-9)
    n_real = np.array([ops[0].shape[1]])
    liks_j, fwds_j = jv._viterbi_sweep_multi(obs_j, jnp.asarray(n_real),
                                             0.05, 0.01)
    liks_t, fwds_t, _ = tv.viterbi_sweep(obs_t, torch.as_tensor(n_real),
                                         0.05, 0.01)
    np.testing.assert_allclose(liks_t.numpy(), np.asarray(liks_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(fwds_t.numpy(), np.asarray(fwds_j), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_obs_kernel_wrapper_refuses_misaligned_tables(dtype):
    """obs_multi_cuda refuses tables that start off a 16-byte boundary (the
    kernel stages them 16 bytes a copy) before anything is launched; the
    operand checks come first, so CPU operands reach the refusal too."""
    B, R, E = 1, 4, 6
    lvl, sd = torch.zeros((B, R, E), dtype=dtype), torch.ones((B, R, E),
                                                               dtype=dtype)
    valid = torch.ones((B, R, E), dtype=torch.bool)
    flat = torch.zeros(B * 6 * E * 1024 + 1, dtype=dtype)
    tabs = flat[1:].view(B, 6, E, 1024)
    assert tabs.is_contiguous() and tabs.data_ptr() % 16
    n = tv.VITERBI_OBS.launches
    with pytest.raises(ValueError, match="16-byte"):
        tv.obs_multi_cuda(lvl, sd, valid, tabs)
    assert tv.VITERBI_OBS.launches == n
