"""The reference is the port's arithmetic: its NumPy Smith-Waterman
equals the port's C++ one, and its TwinEngine's float64 scores equal the
port's TorchEngine on the CPU (the same twins) bit for bit, each side
loading the same files through its own loader."""

import sys

import numpy as np
import torch

from psq_benchmark.reference.core.regions import RegionInfo
from psq_benchmark.reference.engine import TwinEngine
from psq_benchmark.reference.engine import sw as ref_sw
from psq_benchmark.reference.engine.driver import find_point_mutations
from psq_benchmark.reference.engine.types import AlignData
from psq_benchmark.reference.io.load import load_aligned_events
from psq_benchmark.simulate import random_seq, rng_for, write_run

PARAMS = dict(realign_width=16, scoring_width=8, point_width=6,
              min_overlap=100, max_coverage=30, end_trim=20, lik_offset=4.5,
              skip_t=0.141, skip_c=0.088, stay_t=0.043, stay_c=0.057,
              extend_t=0.072, extend_c=0.046, insert_t=0.02, insert_c=0.025)


def test_numpy_smith_waterman_equals_the_ports():
    from poreseq_tpu_torch.engine import sw as port_sw

    from psq_benchmark.simulate import mutate_with_map

    rng = rng_for(3, 0)
    for n in (1, 7, 60, 400):
        for k in range(4):
            a = random_seq(rng, n)
            b = mutate_with_map(rng, a, 0.1)[0]
            if k % 2:
                b = random_seq(rng, 13) + b + random_seq(rng, 9)
            r, p = ref_sw.swfull(a, b), port_sw.swfull(a, b)
            assert np.array_equal(r[1], p[1]) and r[2] == p[2]
            assert r[0] == p[0] or (np.isnan(r[0]) and np.isnan(p[0]))


def test_twin_engine_scores_equal_the_ports_twins(tmp_path):
    from poreseq_tpu_torch.core.regions import RegionInfo as PortRegion
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.driver import \
        find_point_mutations as port_points
    from poreseq_tpu_torch.engine.types import AlignData as PortData
    from poreseq_tpu_torch.io import load as port_load
    from poreseq_tpu_torch.io import npz_h5

    run = write_run(str(tmp_path), 2**31 + 5, 0, n_regions=2,
                    region_length=200, read_length=240, reads_per_region=5,
                    draft_error=0.02, basecall_error=0.1)
    saved = sys.modules.get("h5py")
    sys.modules["h5py"] = npz_h5
    try:
        for region in run["regions"]:
            pa = load_aligned_events(run["fasta"], run["bam"], run["reads"],
                                     RegionInfo(region), dict(PARAMS))
            d = AlignData.from_session(pa)
            d.params.scoring_width = PARAMS["point_width"]
            ours = TwinEngine("cpu", torch.float64).score_mutations_multi(
                [d], [find_point_mutations(d)])[0]
            ppa = port_load.load_aligned_events(
                run["fasta"], run["bam"], run["reads"], PortRegion(region),
                dict(PARAMS), engine=TorchEngine("cpu", torch.float64))
            pd = PortData.from_session(ppa)
            pd.params.scoring_width = PARAMS["point_width"]
            theirs = TorchEngine("cpu", torch.float64).score_mutations(
                pd, port_points(pd))
            assert [(m.start, m.orig, m.mut, m.score) for m in ours] == \
                [(m.start, m.orig, m.mut, m.score) for m in theirs]
    finally:
        if saved is None:
            sys.modules.pop("h5py", None)
        else:
            sys.modules["h5py"] = saved
