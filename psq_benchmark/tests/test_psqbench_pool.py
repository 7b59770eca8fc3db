"""The pool is made from the seed, repeats no region, and gives every
seed the same amount of work."""

import numpy as np

from psq_benchmark.reference.core.regions import RegionInfo
from psq_benchmark.simulate import rng_for, write_run

KW = dict(region_length=300, read_length=360, reads_per_region=5,
          draft_error=0.02, basecall_error=0.1)


def _run(tmp, seed, n=4):
    return write_run(str(tmp), seed, 0, n_regions=n, **KW)


def _files(run):
    import os

    out = {}
    for d, _, fs in os.walk(run["dir"]):
        for f in fs:
            out[os.path.relpath(os.path.join(d, f), run["dir"])] = open(
                os.path.join(d, f), "rb").read()
    return out


def test_the_same_seed_gives_the_same_files(tmp_path):
    a = _run(tmp_path / "a", 2**31 + 99)
    b = write_run(str(tmp_path / "b"), 2**31 + 99, 0, n_regions=4,
                  workers=3, **KW)
    assert a["truth"] == b["truth"] and a["regions"] == b["regions"]
    assert _files(a) == _files(b)
    c = _run(tmp_path / "c", 2**31 + 100)
    assert c["truth"] != a["truth"]


def test_regions_are_distinct_contiguous_and_cover_the_pool(tmp_path):
    run = _run(tmp_path, 7, n=6)
    spans = [(RegionInfo(r).start, RegionInfo(r).end) for r in run["regions"]]
    assert len(set(run["regions"])) == 6
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 == b0 and a1 > a0
    assert spans[0][0] >= KW["region_length"] // 2


def test_every_seed_gives_the_same_work(tmp_path):
    shapes = []
    for seed in (1, 2, 3):
        run = _run(tmp_path / str(seed), seed)
        lens = [RegionInfo(r).end - RegionInfo(r).start
                for r in run["regions"]]
        shapes.append((run["n_reads"], len(run["draft"]), tuple(lens)))
    assert shapes[0] == shapes[1] == shapes[2]


def test_the_draft_has_the_stated_errors_per_region(tmp_path):
    from psq_benchmark.check import residual_errors

    run = _run(tmp_path, 11)
    want = round(KW["draft_error"] * KW["region_length"])
    for r, (a, b) in zip(run["regions"], run["truth_spans"]):
        ri = RegionInfo(r)
        got = residual_errors(run["draft"][ri.start : ri.end],
                              run["truth"][a - 50 : b + 50])
        assert want - 3 <= got <= want + 1, (r, got)


def test_large_seeds_are_taken(tmp_path):
    assert rng_for(2**40 + 3, 0).integers(10) == rng_for(2**40 + 3, 0) \
        .integers(10)
    assert np.isfinite(rng_for(-5, 1).random())
