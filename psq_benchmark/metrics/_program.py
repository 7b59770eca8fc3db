"""Helpers of the readers of the port's own spans and counters
(``poreseq_tpu_torch/obs.py``).  A span is a ``psq.*`` ``record_function``
range of the window's trace (category ``user_annotation``), read on the
main thread (``trace.main_tid``) and clipped to the window; a counter is
the total of the port's records inside the window (``obs.counts``).  A
program without them (one older than its spans) gives None, never an
error."""

from __future__ import annotations

from psq_benchmark.trace import _union, main_tid


def spans(run, names) -> list:
    """[start, end] (us) of the main thread's spans of these names in the
    window, clipped to it."""
    tr = run.trace
    if tr is None:
        return []
    tid = main_tid(tr.events)
    out = []
    for e in tr.events:
        if (e.get("cat") == "user_annotation" and e.get("name") in names
                and e.get("tid") == tid):
            s = max(float(e["ts"]), tr.w0)
            t = min(float(e["ts"]) + float(e["dur"]), tr.w1)
            if t > s:
                out.append([s, t])
    return out


def length_s(intervals) -> float:
    """Seconds covered by [start, end] intervals (us), overlaps once."""
    return sum(t - s for s, t in _union(intervals)) / 1e6


def s_per_kb(run, names):
    """Seconds covered by the spans, nested ones counted once, per kb
    polished; None where there is none."""
    found = spans(run, names)
    if not found or not run.kb:
        return None
    return length_s(found) / run.kb


def self_s_per_kb(run, outer, inner):
    """Seconds of the ``outer`` spans that no ``inner`` span covers, per kb
    polished; None where there is no outer span."""
    found = spans(run, outer)
    if not found or not run.kb:
        return None
    out = _union(found)
    covered = [[max(s, a), min(t, b)] for s, t in out
               for a, b in _union(spans(run, inner)) if a < t and b > s]
    return (length_s(out) - length_s(covered)) / run.kb


def counts(run):
    """{name: total} of the port's counter records inside the window, or
    None where the program keeps none."""
    try:
        from poreseq_tpu_torch import obs
    except ImportError:
        return None
    return obs.counts(run.t0, run.t1)
