"""The ev x mut device mesh on the port (``parallel/mesh.py``), on the CPU:
every shard of a mesh is the CPU, so the plain twins run per shard.

Tolerances: the port on a mesh equals the port on one device bit for bit
(f64, and f32 on the same band geometry), since every shard runs the
single-device fill, backtrace and group scorer on its rows and the sum over
'ev' runs in the single device's row order.  Against the JAX TpuEngine on
its own 4x2 mesh (8 virtual CPU devices) in f64 the port is held to
tests/test_tpu_engine.py's tolerances: scores within 1e-9, mutation deltas
within 1e-8, ref_align identical.  Widths 16/8/6 throughout."""

import sys

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine.driver import find_point_mutations
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.parallel.mesh import make_mesh, pad_axis
from poreseq_tpu_torch.sim import simulate_session

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

PARAMS = dict(realign_width=16, scoring_width=8, point_width=6)
# 14 + 20 + 16 events in a 64-row bucket: on 2 and 4 'ev' shards (32 and
# 16 rows) a region's rows straddle every shard boundary inside 0..49
COVERAGES = ((1, 14), (2, 20), (3, 16))


def _cpu_mesh(n_ev, n_mut):
    return make_mesh(n_ev, n_mut, ["cpu"] * (n_ev * n_mut))


def _sessions(ref_len=60):
    out = []
    for seed, cov in COVERAGES:
        pa, _ = simulate_session(np.random.default_rng(seed),
                                 ref_len=ref_len, coverage=cov,
                                 draft_error=0.04, params=dict(PARAMS))
        out.append(pa)
    return out


def _straddles(n_ev, E=64):
    """Whether some region's rows cross a shard boundary."""
    ends = np.cumsum([c for _, c in COVERAGES])
    starts = ends - [c for _, c in COVERAGES]
    cuts = np.arange(1, n_ev) * (E // n_ev)
    return any(((starts < c) & (c < ends)).any() for c in cuts)


def _score(engine, pas):
    """score_alignments_multi then score_mutations_multi (every point
    mutation at point width) on the regions: scores, likes, ref_align /
    ref_like after each call, mutation totals."""
    datas = [AlignData.from_session(pa) for pa in pas]
    likes = [np.zeros(len(pa.sequence)) for pa in pas]
    scores = engine.score_alignments_multi(datas, likes_list=likes)
    engine.flush_ref_likes()
    after1 = [(ev.ref_align.copy(), ev.ref_like.copy())
              for d in datas for ev in d.events]
    for d in datas:
        d.params.scoring_width = PARAMS["point_width"]
    muts = [find_point_mutations(d) for d in datas]
    ms = engine.score_mutations_multi(datas, muts)
    engine.flush_ref_likes()
    after2 = [(ev.ref_align.copy(), ev.ref_like.copy())
              for d in datas for ev in d.events]
    return dict(scores=scores, likes=likes, after1=after1, after2=after2,
                totals=[[m.score for m in x] for x in ms])


def _assert_bits(a, b):
    if isinstance(a, dict):
        for k in a:
            _assert_bits(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bits(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def single_f64():
    return _score(TorchEngine("cpu", torch.float64), _sessions())


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)])
def test_mesh_engine_equals_single_device_f64(single_f64, shape):
    assert _straddles(shape[0])
    mesh = _cpu_mesh(*shape)
    got = _score(TorchEngine("cpu", torch.float64, mesh=mesh), _sessions())
    _assert_bits(got, single_f64)


def test_mesh_group_scorer_equals_single_device_f32():
    """f32 on the same band geometry (the host's, which a mesh takes):
    totals equal to one device's bit for bit."""
    from poreseq_tpu_torch.engine.mutscore import (group_launches,
                                                   group_totals,
                                                   group_totals_sharded)

    totals = {}
    for name, mesh in (("single", None), ("mesh", _cpu_mesh(4, 2))):
        pas = _sessions()
        datas = [AlignData.from_session(pa) for pa in pas]
        for d in datas:
            d.params.scoring_width = PARAMS["point_width"]
        muts = [find_point_mutations(d) for d in datas]
        eng = TorchEngine("cpu", torch.float32, mesh=mesh)
        run = group_totals if mesh is None else group_totals_sharded
        totals[name] = [run(*args) for _, _, args in group_launches(
            eng, datas, muts, [True] * 3, host_geometry=True)]
    assert len(totals["single"]) == len(totals["mesh"]) > 0
    for a, b in zip(totals["single"], totals["mesh"]):
        assert torch.equal(a, b)


def _step_inputs(n_ev, n_mut, seed=1, coverage=8, n_muts=16):
    """One region's operands for sharded_consensus_step, as
    __graft_entry__._tiny_inputs builds the JAX step's: substitutions at
    starts 10..10+n_muts-1, band geometry from the seed alignment."""
    from poreseq_tpu_torch.core.regions import MutationInfo
    from poreseq_tpu_torch.core.sequence import seq_to_states
    from poreseq_tpu_torch.engine.mutscore import (_build_groups,
                                                   _pad_groups)
    from poreseq_tpu_torch.engine.pack import (fill_geometry,
                                               limited_geometry,
                                               pack_events, round_up)

    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=64,
                             coverage=coverage)
    data = AlignData.from_session(pa)
    states = seq_to_states(data.sequence)
    S = len(states)
    C = round_up(S + 8, 64)
    arrays, ris = pack_events(data.events, e_div=n_ev)
    E = len(arrays["n0"])
    states2 = np.full((C, E), -1, dtype=np.int32)
    states2[:S, : len(data.events)] = states[:, None]
    S_e = np.zeros(E, np.int64)
    S_e[: len(data.events)] = S
    fi = fill_geometry(arrays, ris, S_e, C, 16)
    i0r, i1r = limited_geometry(ris, arrays["n0"], S_e, C, 8)
    i1r = np.minimum(i1r, i0r + 16)
    seq = data.sequence
    muts = []
    for t in range(n_muts):
        m = MutationInfo()
        m.start, m.orig = 10 + t, seq[10 + t]
        m.mut = "A" if seq[10 + t] != "A" else "C"
        muts.append(m)
    part = _build_groups(seq, muts, 7)
    G = part["g_start"].shape[0]
    gp = _pad_groups([part], [np.full(G, S, np.int32)],
                     [np.zeros(G, np.int32)])
    gp = {k: pad_axis(np.asarray(v), n_mut, fill=-1 if k in (
        "g_region", "s_win") else 0) for k, v in gp.items()
        if isinstance(v, np.ndarray)}
    ev_region = np.where(np.arange(E) < len(data.events), 0, -1).astype(
        np.int32)
    return (arrays, states2, fi["i0"], fi["i1"], fi["is_pad"], i0r, i1r,
            ev_region, gp, 4.5, len(data.events))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_step_matches_single_device(dtype):
    """Twin of tests/test_parallel.py::test_sharded_step_matches_single_device
    on the port: the step on a 4x2 mesh equals a 1x1 mesh's, bit for bit
    (scores, totals, accept)."""
    from poreseq_tpu_torch.parallel.mesh import sharded_consensus_step

    out = {}
    for shape in ((1, 1), (4, 2)):
        mesh = _cpu_mesh(*shape)
        step = sharded_consensus_step(mesh, 16, 8, 7, 9, 4, dtype)
        out[shape] = step(*_step_inputs(4, 2))
    for a, b in zip(out[(1, 1)], out[(4, 2)]):
        assert torch.equal(a, b)
    scores, totals, accept = out[(4, 2)]
    assert scores.dtype == totals.dtype == dtype
    assert bool((scores[:8] > 0).all()) and totals.shape[1] == 9
    assert bool(accept.any()) or bool((totals <= 0).all())


@pytest.fixture(scope="module")
def x64():
    import jax

    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_mesh_matches_jax_mesh_f64(x64):
    """The port on a 4x2 CPU mesh against the JAX TpuEngine on a 4x2 mesh
    of virtual CPU devices, f64, on the same sessions: ScoreEvents scores
    within 1e-9, ref_align identical, ScoreMutations deltas within 1e-8."""
    import jax
    import jax.numpy as jnp

    from poreseq_tpu.engine.driver import (
        find_point_mutations as jax_point_mutations)
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.engine.types import AlignData as JAlignData
    from poreseq_tpu.parallel.mesh import make_mesh as jax_mesh
    from poreseq_tpu.sim import simulate_session as jax_session

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    runs = {}
    engines = (("torch", TorchEngine("cpu", torch.float64,
                                     mesh=_cpu_mesh(4, 2)), AlignData,
                simulate_session, find_point_mutations),
               ("jax", TpuEngine(dtype=jnp.float64,
                                 mesh=jax_mesh(4, 2, jax.devices()[:8])),
                JAlignData, jax_session, jax_point_mutations))
    for name, eng, align_data, session, point_mutations in engines:
        pas = [session(np.random.default_rng(seed), ref_len=60,
                       coverage=cov, draft_error=0.04)[0]
               for seed, cov in COVERAGES[:2]]
        datas = [align_data.from_session(pa) for pa in pas]
        for d in datas:
            d.params.realign_width = PARAMS["realign_width"]
            d.params.scoring_width = PARAMS["point_width"]
        scores = eng.score_alignments_multi(datas)
        eng.flush_ref_likes()
        rals = [ev.ref_align.copy() for d in datas for ev in d.events]
        muts = [point_mutations(d)[::7] for d in datas]
        ms = eng.score_mutations_multi(datas, muts)
        runs[name] = (scores, rals, [[m.score for m in x] for x in ms],
                      [ev.ref_align.copy() for d in datas for ev in d.events])
    (sP, rP, mP, r2P), (sJ, rJ, mJ, r2J) = runs["torch"], runs["jax"]
    for a, b in zip(sP, sJ):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    for a, b in zip(mP, mJ):
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    for a, b in zip(rP + r2P, rJ + r2J):
        np.testing.assert_array_equal(a, b)


def _consensus(seed, mesh, ref_len=120, coverage=6, draft_error=0.04,
               reps=2, params=None):
    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                             coverage=coverage, draft_error=draft_error,
                             params=dict(params or PARAMS))
    pa._engine = TorchEngine("cpu", torch.float64, mesh=mesh)
    pa.Mutate(reps=reps)
    pa.Mutate(seqs="viterbi", reps=1)
    pa.Refine()
    return pa.sequence


@pytest.mark.slow
@pytest.mark.parametrize("seed", [3, 9, 17])
def test_engine_mesh_consensus_matches_single_device(seed):
    """Twin of tests/test_parallel.py:29: full consensus (Mutate, Viterbi
    candidates, Refine) on a 4x2 mesh gives the single device's
    sequence."""
    assert (_consensus(seed, _cpu_mesh(4, 2))
            == _consensus(seed, None))


@pytest.mark.slow
def test_engine_mesh_consensus_matches_single_device_production_widths():
    """Twin of tests/test_parallel.py:117 at the production widths
    300/100/20 on a 1 kb region."""
    kw = dict(ref_len=1000, coverage=6, draft_error=0.03, reps=1,
              params=dict(realign_width=300, scoring_width=100,
                          point_width=20))
    assert (_consensus(23, _cpu_mesh(4, 2), **kw)
            == _consensus(23, None, **kw))


CONF = ("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
        "max_length = 10000\nlik_offset = 4.5\n")


def _cli_run(tmp_path):
    from poreseq_tpu_torch.sim import write_run

    _, _, reads, bam, fasta = write_run(
        str(tmp_path), np.random.default_rng(5), ref_len=200, n_reads=4,
        read_len=140, draft_error=0.03)
    conf = tmp_path / "params.conf"
    conf.write_text(CONF)
    rf = tmp_path / "regions.txt"
    rf.write_text("synthref:0:100\nsynthref:100:200\n")
    return [fasta, bam, reads, "-R", str(rf), "-p", str(conf), "-i", "1",
            "--region-batch", "2"]


def test_cli_consensus_mesh_equals_single_device(tmp_path):
    """consensus --mesh 2x2 --device cpu writes the FASTA of the run
    without --mesh, byte for byte."""
    from poreseq_tpu_torch import cli

    args = _cli_run(tmp_path)
    outs = []
    for extra in ([], ["--mesh", "2x2"]):
        out = tmp_path / "out{}.fasta".format(len(extra))
        cli.main(["consensus", *args, "-o", str(out), "--device", "cpu",
                  *extra])
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b">") == 2


@pytest.mark.cuda
def test_cli_mesh_with_too_few_cards_runs_single_device(tmp_path, capsys,
                                                       monkeypatch):
    """--mesh 4x2 --device cuda with fewer than 8 cards: one stderr line
    naming the counts, then the single-device run on the same card."""
    from poreseq_tpu_torch import cli

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.device_count() >= 8:
        pytest.skip("8 or more cards: the mesh fits")
    try:
        import h5py  # noqa: F401
    except ImportError:
        # the GPU machine has no h5py: the port's npz stand-in writes and
        # reads the run's fast5 files through the same reader
        from poreseq_tpu_torch.io import npz_h5

        monkeypatch.setitem(sys.modules, "h5py", npz_h5)
    args = _cli_run(tmp_path)
    outs = []
    for extra in ([], ["--mesh", "4x2"]):
        out = tmp_path / "out{}.fasta".format(len(extra))
        cli.main(["consensus", *args, "-o", str(out), "--device", "cuda",
                  *extra])
        outs.append(out.read_bytes())
    err = capsys.readouterr().err
    assert "--mesh 4x2 needs 8 devices, have {}; running single-device".format(
        torch.cuda.device_count()) in err
    assert outs[0] == outs[1]


def test_resolve_mesh(monkeypatch, capsys):
    """--mesh's meaning: the JAX CLI's (poreseq_tpu/engine/tpu/__init__.py
    _mesh_from_env), with shard k on cuda:N+k or every shard on the CPU."""
    from poreseq_tpu_torch.cli import resolve_mesh

    cpu = torch.device("cpu")
    for spec in (None, "", "off", "none", "0", "auto"):
        assert resolve_mesh(spec, cpu) is None
    m = resolve_mesh("4x2", cpu)
    assert (m.n_ev, m.n_mut) == (4, 2) and m.first == cpu
    assert (resolve_mesh("3", cpu).n_ev, resolve_mesh("3", cpu).n_mut) == (
        3, 1)
    # three cards seen: shard k on cuda:k, or cuda:1+k from --device cuda:1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = resolve_mesh("auto", torch.device("cuda"))
    assert [str(r[0]) for r in m.devices] == ["cuda:0", "cuda:1", "cuda:2"]
    m = resolve_mesh("2", torch.device("cuda:1"))
    assert [str(r[0]) for r in m.devices] == ["cuda:1", "cuda:2"]
    assert resolve_mesh("2x2", torch.device("cuda")) is None
    assert capsys.readouterr().err == (
        "--mesh 2x2 needs 4 devices, have 3; running single-device\n")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_mesh("auto", torch.device("cuda")) is None


def test_make_mesh_and_pad_axis():
    m = make_mesh(2, 3, ["cpu"] * 6)
    assert (m.n_ev, m.n_mut) == (2, 3) and m.row_devices(1) == [
        torch.device("cpu")]
    assert m.serves(0, torch.device("cpu")) == [0, 1, 2]
    assert make_mesh(None, 2, ["cpu"] * 5).n_ev == 2
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(4, 2, ["cpu"] * 4)
    x = np.arange(5)
    np.testing.assert_array_equal(pad_axis(x, 4, fill=-1),
                                  [0, 1, 2, 3, 4, -1, -1, -1])
    assert pad_axis(x, 5) is x


class _Stub:
    def __init__(self, device):
        self.device = torch.device(device)


def test_route_refuses_operands_on_two_cards():
    """A kernel's operands must lie on one card: route() refuses a spread
    over two CUDA devices as it refuses a cpu/cuda mix (stub operands, so
    no card is needed)."""
    from poreseq_tpu_torch._build import route

    assert route(_Stub("cpu"), _Stub("cpu")) == "cpu"
    assert route(_Stub("cuda:1"), _Stub("cuda:1")) == "cuda"
    with pytest.raises(ValueError, match="one CUDA device"):
        route(_Stub("cuda:0"), _Stub("cuda:1"))
    with pytest.raises(ValueError, match="all-cpu"):
        route(_Stub("cpu"), _Stub("cuda:0"))


def test_kernel_call_runs_under_its_operands_device(monkeypatch):
    """Kernel.call enters the operands' device before the C entry runs, so
    the entry's cudaFuncSetAttribute and launch reach that card (a stub
    library and device guard stand in for CUDA)."""
    from poreseq_tpu_torch.engine.fill import FILL

    seen, entered = [], []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            entered.pop()

    class Lib:
        def psq_fill_f32(self, *args):
            seen.append((list(entered), args))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(FILL, "_lib", Lib())
    n = FILL.launches
    FILL.call("psq_fill_f32", torch.device("cuda:1"), "args", "stream")
    assert seen == [([torch.device("cuda:1")], ("args", "stream"))]
    assert FILL.launches == n + 1 and entered == []
