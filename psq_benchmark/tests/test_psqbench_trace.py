"""The trace readers on a small recorded trace: the union of device
intervals, the idle share, attribution of kernels to the span their
launch was made in, and the idle gaps by what the host was doing."""

import json

import pytest

from psq_benchmark import trace
from psq_benchmark.metrics import _common
from psq_benchmark.run import RunView
from psq_benchmark.spans import Recorder, Span, self_time

MAIN, LOADER = 11, 12


def _events():
    X = lambda name, cat, ts, dur, tid=MAIN, **args: dict(
        ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid, pid=1,
        args=args)
    return [
        X(trace.WINDOW, "user_annotation", 0, 1000),
        X("engine.score_alignments_multi", "user_annotation", 100, 200),
        X("engine.flush_ref_likes", "user_annotation", 250, 40),
        X("engine.score_mutations_multi", "user_annotation", 500, 300),
        X("io.load_many", "user_annotation", 100, 600, tid=LOADER),
        X("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=1),
        X("cudaLaunchKernel", "cuda_runtime", 260, 5, correlation=2),
        X("cuLaunchKernel", "cuda_driver", 510, 5, correlation=3),
        X("cudaLaunchKernel", "cuda_runtime", 900, 5, correlation=4),
        X("fill", "kernel", 130, 100, tid=7, correlation=1),
        X("cast", "kernel", 200, 80, tid=7, correlation=2),
        X("group", "kernel", 520, 50, tid=7, correlation=3),
        X("Memcpy DtoH", "gpu_memcpy", 600, 10, tid=7, correlation=9),
        X("late", "kernel", 950, 100, tid=7, correlation=4),
    ]


def test_union_idle_and_attribution(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    events = trace.load(str(path))
    names = {"engine.score_alignments_multi", "engine.flush_ref_likes",
             "engine.score_mutations_multi", "io.load_many", trace.WINDOW}
    tr = trace.Trace(events, names)
    assert tr.window_s() == pytest.approx(1e-3)
    # [130, 280] + [520, 570] + [600, 610] + [950, 1000] (clipped)
    assert tr.busy_s() == pytest.approx(260e-6)
    by = tr.device_s_by_span()
    assert by["engine.score_alignments_multi"] == pytest.approx(100e-6)
    assert by["engine.flush_ref_likes"] == pytest.approx(80e-6)
    assert by["engine.score_mutations_multi"] == pytest.approx(50e-6)
    assert by[trace.WINDOW] == pytest.approx(50e-6)
    gaps = dict(tr.idle_gaps(trace.main_tid(events)))
    # gaps [0, 130], [280, 520], [570, 600], [610, 950], each stretch to
    # the main thread's innermost span over it
    assert gaps["host"] == pytest.approx((100 + 200 + 150) * 1e-6)
    assert gaps["engine.score_alignments_multi"] == pytest.approx(40e-6)
    assert gaps["engine.flush_ref_likes"] == pytest.approx(10e-6)
    assert gaps["engine.score_mutations_multi"] == pytest.approx(
        (20 + 30 + 190) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 260e-6)
    view = RunView(trace=tr)
    assert _common.idle_share(view) == pytest.approx(74.0)
    assert tr.top_ops()[0] == ["fill", pytest.approx(100e-6)]


def test_nested_spans_and_self_time():
    rec = Recorder()
    rec.main = 1
    rec.spans = [Span("multi.find_mutations_multi", 1, 0.0, 10.0, None),
                 Span("engine.score_alignments_multi", 1, 1.0, 3.0, 1e-3),
                 Span("engine.flush_ref_likes", 1, 2.0, 2.5, None),
                 Span("engine.score_alignments_multi", 1, 5.0, 6.0, 2e-3),
                 Span("io.load_many", 2, 0.0, 4.0, 8)]
    view = RunView(rec=rec, t0=0.0, t1=10.0, kb=2.0, kb_region=1.0,
                   trace=None)
    assert _common.host_search_s_per_kb(view) == pytest.approx(7.0 / 2)
    assert _common.engine_s_per_kb(view) == pytest.approx(3.0 / 2)
    assert _common.load_s_per_kb(view, "io.load_many", None) == \
        pytest.approx(4.0 / 8)
    assert self_time(rec.spans[:1], rec.spans[1:2]) == pytest.approx(8.0)
    assert _common.roofline_share(view, "engine.score_alignments_multi") \
        is None


def test_innermost_walks_up_past_closed_siblings():
    nest = trace._Nest([(0, 100, "a"), (10, 20, "b"), (30, 40, "c"),
                        (35, 38, "d"), (50, 90, "e")])
    assert nest.innermost(45) == "a"
    assert nest.innermost(36) == "d"
    assert nest.innermost(39) == "c"
    assert nest.innermost(60) == "e"
    assert nest.innermost(150) is None
