"""Helpers of the per-layer metrics' readers (each metric is its own file,
``metrics/<name>.py``, with ``read(run) -> float | None``; ``run`` is the
harness's ``RunView``).  A reader that finds nothing to read returns
None and the harness leaves the metric out."""

from __future__ import annotations

from psq_benchmark.spans import ENGINE_SPANS, self_time


def merged_s(spans) -> float:
    """Seconds covered by the spans, nested or overlapping ones counted
    once, per thread."""
    total = 0.0
    by = {}
    for s in spans:
        by.setdefault(s.thread, []).append((s.t0, s.t1))
    for iv in by.values():
        end = None
        for a, b in sorted(iv):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
    return total


def load_s_per_kb(run, name: str, main: bool | None):
    spans = run.rec.within(run.t0, run.t1, name, main=main)
    regions = sum(s.info or 0 for s in spans)
    if not regions:
        return None
    return merged_s(spans) / (regions * run.kb_region)


def engine_s_per_kb(run):
    spans = [s for n in ENGINE_SPANS
             for s in run.rec.within(run.t0, run.t1, n, main=True)]
    if not spans or not run.kb:
        return None
    return merged_s(spans) / run.kb


def host_search_s_per_kb(run):
    outer = run.rec.within(run.t0, run.t1, "multi.find_mutations_multi",
                           main=True)
    if not outer or not run.kb:
        return None
    inner = [s for n in ENGINE_SPANS
             for s in run.rec.within(run.t0, run.t1, n, main=True)]
    return self_time(outer, _outermost(inner)) / run.kb


def _outermost(spans):
    """The spans not inside another of the list on the same thread."""
    out = []
    for s in spans:
        if not any(o is not s and o.thread == s.thread and o.t0 <= s.t0
                   and s.t1 <= o.t1 for o in spans):
            out.append(s)
    return out


def roofline_share(run, name: str):
    """100 x the least time of the work reaching the calls (the spans'
    info, ``psq_benchmark/roofline.py``) over the device time of every
    kernel launched inside them."""
    if run.trace is None:
        return None
    spans = run.rec.within(run.t0, run.t1, name, main=True)
    least = sum(s.info for s in spans if isinstance(s.info, float))
    device = run.trace.device_s_by_span().get(name, 0.0)
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device


def idle_share(run):
    if run.trace is None or run.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
