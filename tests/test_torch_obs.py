"""The port's own spans and counters (``poreseq_tpu_torch/obs.py``): free
without a profiler; in a ``consensus --profile`` run every span of
``PARENTS``, nested as the code nests them, and counts that match what the
rounds return and the regions written; the benchmark's readers of them
on a small synthetic trace; and ``trace_summary``'s idle time by span and
counter totals."""

import json
import sys

import numpy as np
import pytest
import torch

from poreseq_tpu_torch import obs

torch.set_num_threads(1)

CONF = ("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 30\n"
        "max_length = 10000\nlik_offset = 4.5\n")

#: each span of a consensus batch -> the spans it may sit directly inside
#: (None: no psq span, the top of the main thread)
PARENTS = {
    "psq.load_wait": {None},
    "psq.load": {"psq.load_wait"},
    "psq.batch": {None},
    "psq.emit": {None},
    "psq.search": {"psq.batch"},
    "psq.search.remap": {"psq.search"},
    "psq.search.dlikes": {"psq.search"},
    "psq.search.extract": {"psq.search"},
    "psq.align": {"psq.search"},
    "psq.align.wait": {"psq.align"},
    "psq.mutscore": {"psq.batch"},
    "psq.mutscore.wait": {"psq.mutscore"},
    "psq.mutscore.groups": {"psq.mutscore"},
    "psq.mutscore.assign": {"psq.mutscore"},
    "psq.viterbi": {"psq.batch"},
    "psq.viterbi.wait": {"psq.viterbi"},
    "psq.flush": {"psq.batch", "psq.align", "psq.mutscore"},
    "psq.accept": {"psq.batch"},
    "psq.sync": {"psq.batch"},
    "psq.points": {"psq.batch"},
    "psq.final": {"psq.batch"},
}


def test_spans_and_counts_cost_one_check_without_a_profiler(monkeypatch):
    """No profiler: no record_function is entered and nothing is
    recorded.  Under one: the spans are in its events and the counts in
    the records, totalled inside an interval."""
    from torch.profiler import ProfilerActivity, profile

    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    obs.take()
    with monkeypatch.context() as m:
        m.setattr(obs, "record_function", entered)
        with obs.span("psq.batch"):
            obs.count("psq.regions", 3)
        assert obs.spanned("psq.search")(lambda a, b=0: a + b)(1, b=2) == 3
    assert obs.take() == [] and obs.counts() == {}

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("psq.batch"):
            obs.count("psq.regions", 2)
            obs.spanned("psq.search")(obs.count)("psq.regions")
    assert {"psq.batch", "psq.search"} <= {e.name for e in prof.events()}
    (n1, t1, c1), (n2, t2, c2) = obs._records
    assert (n1, c1, n2, c2) == ("psq.regions", 2, "psq.regions", 1)
    assert obs.counts() == {"psq.regions": 3}
    assert obs.counts(t1, t1) == {"psq.regions": 2}
    assert obs.counts(t2 + 1) == {}
    assert len(obs.take()) == 2 and obs.counts() == {}


def _user_spans(path):
    """(name, tid, start, end) of the trace's psq.* user annotations, each
    event decoded alone (the CPU twins' trace runs to hundreds of MB)."""
    text = open(path).read()
    dec = json.JSONDecoder()
    out, at = [], 0
    while True:
        at = text.find('"user_annotation"', at)
        if at < 0:
            return out
        e, end = dec.raw_decode(text, text.rfind("{", 0, at))
        if e.get("ph") == "X" and e["name"].startswith("psq."):
            ts = float(e["ts"])
            out.append((e["name"], e["tid"], ts, ts + float(e["dur"])))
        at = end


def _parent(spans, i):
    """The innermost other span of the same thread containing span i."""
    name, tid, s, t = spans[i]
    best = None
    for j, (n, d, a, b) in enumerate(spans):
        if j != i and d == tid and a <= s and t <= b and (
                best is None or a >= spans[best][2]):
            best = j
    return None if best is None else spans[best][0]


def test_consensus_profile_nests_spans_and_counts_the_rounds(
        tmp_path, monkeypatch):
    """A CPU ``consensus --profile`` run (one 48 b region, -i 1): every
    span of ``PARENTS`` is in the Chrome trace on the main thread, each
    inside the span its caller opens (psq.search.remap inside psq.search
    inside psq.batch), and the counts file beside it holds the bases the
    rounds accepted (``mutate_datas``, ``refine_datas``), the regions
    written and every scored mutation on the scorer's array path."""
    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.engine import multi
    from poreseq_tpu_torch.io.fasta import read_fasta
    from poreseq_tpu_torch.sim import write_run

    _, _, reads, bam, fasta = write_run(
        str(tmp_path), np.random.default_rng(11), ref_len=48, n_reads=4,
        draft_error=0.03)
    conf = tmp_path / "params.conf"
    conf.write_text(CONF)
    accepted = []
    for name in ("mutate_datas", "refine_datas"):
        def rounds(*args, _real=getattr(multi, name), **kwargs):
            out = _real(*args, **kwargs)
            accepted.append(sum(out))
            return out

        monkeypatch.setattr(multi, name, rounds)
    out = tmp_path / "out.fasta"
    prof = tmp_path / "prof"
    obs.take()
    cli.main(["consensus", fasta, bam, reads, "-r", "synthref:0:48", "-p",
              str(conf), "-i", "1", "--device", "cpu", "-o", str(out),
              "--profile", str(prof)])
    [trace] = prof.glob("*.trace.json")
    spans = _user_spans(trace)
    main = {tid for name, tid, _, _ in spans if name == "psq.batch"}
    assert len(main) == 1
    assert {name for name, tid, _, _ in spans if tid in main} == set(PARENTS)
    for i, (name, _, _, _) in enumerate(spans):
        assert _parent(spans, i) in PARENTS[name], name

    counts = json.loads(trace.with_name(
        trace.name.replace(".trace.", ".counts.")).read_text())
    written = list(read_fasta(str(out)))
    assert written == ["synthref:0:48"] and len(accepted) == 3
    assert counts["totals"]["psq.bases_accepted"] == sum(accepted) > 0
    assert counts["totals"]["psq.regions"] == len(written)
    assert {name for name, _, _ in counts["records"]} == {
        "psq.regions", "psq.rounds", "psq.candidates",
        "psq.candidates_fresh", "psq.mutations_scored",
        "psq.bases_accepted", "psq.mutations_columnar"}
    # a pure-ACGT run: every scored mutation takes the scorer's array path
    assert (counts["totals"]["psq.mutations_columnar"]
            == counts["totals"]["psq.mutations_scored"] > 0)
    for name, total in counts["totals"].items():
        assert total == sum(n for k, _, n in counts["records"] if k == name)
    assert counts["totals"]["psq.rounds"] == 3      # Mutate, Mutate, Refine
    assert 0 < counts["totals"]["psq.candidates_fresh"] <= \
        counts["totals"]["psq.candidates"]
    assert obs.take() == []              # written, then cleared


def _view(events, kb=2.0, records=None, monkeypatch=None):
    from psq_benchmark import trace
    from psq_benchmark.run import RunView

    if records is not None:
        monkeypatch.setattr(obs, "_records", records)
    return RunView(trace=trace.Trace(events, set()) if events else None,
                   kb=kb, t0=0.0, t1=5.0)


def _events(spans=True):
    """A window [0, 1000] us on thread 1 and, with ``spans``, the port's
    spans of one batch there (some past the window's edges) and on a
    second thread."""
    from psq_benchmark import trace

    X = lambda name, ts, end, tid=1: dict(
        ph="X", cat="user_annotation", name=name, ts=ts, dur=end - ts,
        tid=tid, pid=1)
    ev = [X(trace.WINDOW, 0, 1000), X("psq.batch", 0, 1000)]
    if spans:
        ev += [X("psq.load_wait", -50, 30),
               X("psq.search", 100, 500), X("psq.search.remap", 110, 150),
               X("psq.align", 160, 260), X("psq.align.wait", 200, 240),
               X("psq.flush", 245, 255), X("psq.search.dlikes", 300, 320),
               X("psq.search.extract", 330, 345),
               X("psq.mutscore", 550, 750), X("psq.mutscore.groups", 560, 580),
               X("psq.mutscore.wait", 600, 650), X("psq.flush", 660, 670),
               X("psq.mutscore.assign", 700, 720),
               X("psq.viterbi", 760, 800), X("psq.viterbi.wait", 790, 800),
               X("psq.accept", 810, 830), X("psq.sync", 840, 850),
               X("psq.points", 860, 880), X("psq.final", 990, 1100),
               X("psq.load", 0, 900, tid=2),
               X("psq.search.remap", 0, 999, tid=2)]
    return ev


#: each reader on _events() at 2 kb: hand-computed seconds per kb
READINGS = {
    "load_wait_s_per_kb": 30e-6 / 2,               # clipped at 0
    "search_remap_s_per_kb": 40e-6 / 2,            # not thread 2's
    "search_dlikes_s_per_kb": 20e-6 / 2,
    "search_extract_s_per_kb": 15e-6 / 2,
    "engine_wait_s_per_kb": (40 + 10 + 50 + 10 + 10) * 1e-6 / 2,
    "mutscore_host_s_per_kb": (200 - 50 - 10) * 1e-6 / 2,
    "rounds_host_s_per_kb": (20 + 10 + 20 + 10) * 1e-6 / 2,   # final clipped
}


@pytest.mark.parametrize("name", sorted(READINGS) + ["accepted_per_kscored"])
def test_program_metric_readers(name, monkeypatch):
    """Each new per-layer metric on a synthetic trace and counter records
    gives the hand-computed value, and None with no span or record to
    read (a program older than its spans)."""
    from psq_benchmark import spec

    read = spec.reader(name)
    records = [("psq.mutations_scored", 1.0, 300),
               ("psq.bases_accepted", 2.0, 6),
               ("psq.mutations_scored", 4.0, 100),
               ("psq.bases_accepted", 9.0, 100)]       # past the window
    got = read(_view(_events(), records=records, monkeypatch=monkeypatch))
    assert got == pytest.approx(READINGS.get(name, 1000.0 * 6 / 400))
    for events in (_events(spans=False), None):
        assert read(_view(events, records=[],
                          monkeypatch=monkeypatch)) is None
    # a program without obs.py (its parent): nothing to read, no error
    import poreseq_tpu_torch

    monkeypatch.delattr(poreseq_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "poreseq_tpu_torch.obs", None)
    assert read(_view(None)) is None


def test_trace_summary_idle_by_span_and_counts(tmp_path, capsys):
    """trace_summary gives each idle stretch of the device to the main
    thread's innermost psq span over it ("-" outside every one) and reads
    the counts file beside the trace."""
    from poreseq_tpu_torch import trace_summary

    X = lambda cat, name, ts, end, tid=1: dict(ph="X", cat=cat, name=name,
                                               ts=ts, dur=end - ts, tid=tid)
    ann = lambda *a, **k: X("user_annotation", *a, **k)
    path = tmp_path / "poreseq_torch.7.trace.json"
    path.write_text(json.dumps({"traceEvents": [
        ann("psq.batch", 0, 1000), ann("psq.search", 100, 400),
        ann("psq.search.remap", 150, 250), ann("psq.emit", 1000, 1100),
        ann("psq.load", 0, 1200, tid=2),           # not the main thread
        X("cpu_op", "aten::add", 1100, 1200),
        X("kernel", "fill_kernel", 300, 350, tid=7)]}))
    totals = {"psq.regions": 8, "psq.bases_accepted": 152}
    (tmp_path / "poreseq_torch.7.counts.json").write_text(json.dumps(
        {"totals": totals, "records": []}))
    out = trace_summary.summarize(str(path))
    assert out["idle_ms_by_span"] == pytest.approx(
        {"psq.batch": 0.7, "psq.search": 0.15, "psq.search.remap": 0.1,
         "psq.emit": 0.1, "-": 0.1})
    assert out["counts"] == totals and out["busy_ms"] == 0.05
    trace_summary.main([str(path)])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == out
    assert "         152  psq.bases_accepted" in lines
