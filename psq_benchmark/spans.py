"""Spans that the benchmark puts around the port's calls into each layer.

``Recorder.wrap(owner, attr, name)`` replaces a module function or a class
method by a wrapper that records (name, thread, start, end, info) on the
host clock and, while a torch.profiler runs, a ``record_function`` range
of the same name, so that the profiler's trace can attribute the kernels
launched inside it.  ``info(args, kwargs, result)`` (optional) keeps what
a metric needs of the call.  An engine method whose ``defer`` argument is
true returns a closure that does the call's reads; the wrapper wraps that
closure in a span of the same name (without ``info``: the work is
counted once, at the call), so the reads count to the call.

The wrappers are installed only in a traced run (``--trace 1``); the
window's own hook (``run.Window``) is installed in every run.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import NamedTuple

from torch.profiler import record_function


class Span(NamedTuple):
    name: str
    thread: int
    t0: float
    t1: float
    info: object


class Recorder:
    def __init__(self):
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._undo: list = []
        self.main = threading.get_ident()

    def wrap(self, owner, attr: str, name: str, info=None):
        real = getattr(owner, attr)
        rec = self

        def span(fn, args, kwargs, keep=True):
            t0 = time.perf_counter()
            with record_function(name):
                result = fn(*args, **kwargs)
            t1 = time.perf_counter()
            meta = (info(args, kwargs, result)
                    if keep and info is not None else None)
            with rec._lock:
                rec.spans.append(Span(name, threading.get_ident(), t0, t1,
                                      meta))
            return result

        @functools.wraps(real)
        def wrapped(*args, **kwargs):
            if kwargs.get("defer"):
                fin = span(real, args, kwargs)
                return lambda: span(fin, (), {}, keep=False)
            return span(real, args, kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, real))
        return real

    def restore(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()

    def within(self, t0: float, t1: float, name: str | None = None,
               main: bool | None = None) -> list[Span]:
        """The spans that ended inside [t0, t1], optionally of one name and
        on (main=True) or off (main=False) the main thread."""
        return [s for s in self.spans
                if t0 <= s.t1 <= t1 and (name is None or s.name == name)
                and (main is None or (s.thread == self.main) == main)]


def self_time(outer: list[Span], inner: list[Span]) -> float:
    """Seconds of the outer spans not covered by inner spans of the same
    thread that lie inside them (inner spans do not overlap each other on
    one thread)."""
    total = 0.0
    for o in outer:
        covered = sum(min(i.t1, o.t1) - max(i.t0, o.t0) for i in inner
                      if i.thread == o.thread and i.t0 < o.t1 and i.t1 > o.t0)
        total += (o.t1 - o.t0) - covered
    return total


def install(rec: Recorder, dtype: str):
    """Wrap the port's layer boundaries that the per-layer metrics read:
    the loader (``io/``), the host search (``engine/multi.py``) and the
    TorchEngine methods the drivers call."""
    from poreseq_tpu_torch import pipeline
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine import multi

    rec.wrap(pipeline, "load_many", "io.load_many",
             info=lambda a, k, r: len(a[3]))
    rec.wrap(pipeline, "load_aligned_events", "io.load_aligned_events",
             info=lambda a, k, r: 1)
    rec.wrap(multi, "find_mutations_multi", "multi.find_mutations_multi")
    rec.wrap(TorchEngine, "score_alignments_multi",
             "engine.score_alignments_multi", info=_align_problem(dtype))
    rec.wrap(TorchEngine, "score_mutations_multi",
             "engine.score_mutations_multi", info=_mutscore_problem(dtype))
    rec.wrap(TorchEngine, "viterbi_mutate_multi",
             "engine.viterbi_mutate_multi")
    rec.wrap(TorchEngine, "flush_ref_likes", "engine.flush_ref_likes")


ENGINE_SPANS = ("engine.score_alignments_multi", "engine.score_mutations_multi",
                "engine.viterbi_mutate_multi", "engine.flush_ref_likes")
SPAN_NAMES = ("io.load_many", "io.load_aligned_events",
              "multi.find_mutations_multi") + ENGINE_SPANS


def _rows(data, S: int) -> list:
    """(levels, columns) of each event row of a region with a seed
    alignment: the columns between its first and last anchor."""
    out = []
    for ev in data.events:
        ral = ev.ref_align
        anchors = ral[ral > 0]
        if len(anchors) == 0:
            continue
        cols = int(min(anchors.max(), S) - max(anchors.min(), 1) + 1)
        out.append((len(ev.mean), max(cols, 0)))
    return out


def _align_problem(dtype: str):
    from . import roofline

    def info(args, kwargs, result):
        datas = args[1]
        part = kwargs.get("participate") or [True] * len(datas)
        rows = []
        for d, p in zip(datas, part):
            if p:
                rows += _rows(d, len(d.sequence) - 4)
        w = datas[0].params.realign_width if datas else 0
        return roofline.least_s(*roofline.realign_work(rows, w, dtype), dtype)

    return info


def _mutscore_problem(dtype: str):
    from . import roofline

    def info(args, kwargs, result):
        datas, muts_list = args[1], args[2]
        regions = []
        for d, muts in zip(datas, muts_list):
            if not muts or not d.events:
                continue
            S = len(d.sequence) - 4
            regions.append((_rows(d, S),
                            [(len(m.orig), len(m.mut), max(S - m.start, 0))
                             for m in muts]))
        if not regions:
            return 0.0
        p = datas[0].params
        return roofline.least_s(*roofline.mutscore_work(
            regions, p.realign_width, p.scoring_width, dtype), dtype)

    return info
