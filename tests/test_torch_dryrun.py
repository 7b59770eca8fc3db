"""The port's driver entry points on the CPU: tools/dryrun.py (entry against
__graft_entry__.entry, the mesh dry run against one device) and
tools/bench_multihost.py (two coordinated processes against one), with
the host-geometry switch the dry run's one-device run takes."""


import numpy as np
import pytest
import torch

from tools import bench_multihost as mh
from tools import dryrun as dr

torch.set_num_threads(1)




def test_entry_equals_the_jax_entry():
    """entry()'s fill step on the CPU (the fill's twin, f32) gives
    __graft_entry__.entry()'s best scores on the same simulated region,
    within phase 2's f32 fill tolerances."""
    import jax

    import __graft_entry__ as jentry

    jfn, jargs = jentry.entry()
    exp = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = dr.entry("cpu")
    got = fn(*args).numpy()
    assert got.shape == exp.shape == (64,)
    assert np.abs(exp).max() > 50
    np.testing.assert_allclose(got, exp, rtol=2e-5, atol=2e-4)


def test_dryrun_mesh_equals_one_device_tiny():
    """A 2x2 mesh of CPU shards ends the session with one device's
    sequence and base count (an 80 b region at widths 12/6/4)."""
    res = dr.dryrun_multichip(4, 80, "cpu", widths=(12, 6, 4))
    assert res["equal_to_one_device"] and res["mesh"] == "2x2"
    assert res["devices"] == ["cpu"] * 4 and res["n_events"] == 4
    assert res["bases_mutated"] == res["one_device_bases_mutated"] > 0
    assert np.isfinite(res["accuracy_after_pct"])


@pytest.mark.slow
def test_dryrun_mesh_equals_one_device_at_a_moving_band():
    """The dry run at ref_len 1500 and the production widths 300/100/20
    (C = 1,536 columns against W = 601 band rows: the band moves)."""
    res = dr.dryrun_multichip(4, 1500, "cpu")
    assert res["equal_to_one_device"]
    assert isinstance(res["equal_to_device_geometry"], bool)


def test_dev_geom_switch_takes_the_host_geometry(monkeypatch):
    """PSQ_DEV_GEOM=0 (the JAX engine's switch, mutscore.py:844) makes an
    f32 single-device ScoreMutations call take the host's geometry: the
    device geometry is never computed, and the scores equal a call on a
    1x1 mesh (which always takes the host's)."""
    from poreseq_tpu_torch.engine import TorchEngine, mutscore
    from poreseq_tpu_torch.engine.driver import find_point_mutations
    from poreseq_tpu_torch.engine.types import AlignData
    from poreseq_tpu_torch.parallel.mesh import make_mesh
    from poreseq_tpu_torch.sim import simulate_session

    def scores(engine):
        pa, _ = simulate_session(np.random.default_rng(5), ref_len=80,
                                 coverage=4, params=dict(realign_width=12,
                                                         scoring_width=6))
        data = AlignData.from_session(pa)
        return [m.score for m in engine.score_mutations(
            data, find_point_mutations(data)[:60])]

    calls = []
    real = mutscore.geom_body
    monkeypatch.setattr(mutscore, "geom_body",
                        lambda *a: calls.append(1) or real(*a))
    scores(TorchEngine("cpu"))
    assert calls                       # f32 on one device: the device's
    calls.clear()
    monkeypatch.setenv("PSQ_DEV_GEOM", "0")
    got = scores(TorchEngine("cpu"))
    assert not calls
    assert got == scores(TorchEngine("cpu", mesh=make_mesh(1, 1, ["cpu"])))


def test_bench_multihost_two_processes_equal_one():
    """Two coordinated CPU processes (exact backend, 2 regions of 150 b)
    write shards whose join equals the one-process output, and the
    efficiency is T1 / (2 T2)."""
    res = mh.run(mh.parse(["2", "150", "--backend", "exact", "--device",
                           "cpu", "--processes", "2"]))
    assert res["outputs_equal"] == {2: True}
    assert res["t1_s"] == min(res["t1_runs_s"]) > 0
    assert res["efficiency_1_to_2"] == pytest.approx(
        res["t1_s"] / (2 * res["t2_s"]))
    assert res["card"] is None and res["device"] is None
