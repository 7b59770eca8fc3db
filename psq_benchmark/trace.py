"""Reading a torch.profiler Chrome trace of the window.

Device activity is every complete event of category kernel, gpu_memcpy or
gpu_memset (the trace arithmetic of the port's ``trace_summary.py``): busy
time is the union of their intervals inside the window, which is the
``psq_benchmark.window`` range that the harness records around it.

A kernel is attributed to the benchmark span (``spans.py``) its launch was
made in: the kernel's correlation id leads to the runtime or driver call
that launched it, and that call's thread and time to the innermost span
open on that thread.  Kernels are never attributed by their name.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "psq_benchmark.window"


def load(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X" and "dur" in e]


def _union(intervals: list) -> list:
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


class Trace:
    def __init__(self, events: list, span_names: set):
        self.events = events
        win = [e for e in events if e.get("name") == WINDOW]
        if not win:
            raise ValueError("no window range in the trace")
        w = win[0]
        self.w0 = float(w["ts"])
        self.w1 = self.w0 + float(w["dur"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launches[c] = (e.get("tid"), float(e["ts"]))
        self.launches = launches
        spans = defaultdict(list)
        for e in events:
            if e.get("name") in span_names and e.get("cat") in (
                    "user_annotation", "cpu_op", None):
                s = float(e["ts"])
                spans[e.get("tid")].append((s, s + float(e["dur"]),
                                            e["name"]))
        self.spans = {tid: _Nest(v) for tid, v in spans.items()}

    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def clipped(self):
        """Device events' intervals (us) clipped to the window."""
        for e in self.device:
            s = max(float(e["ts"]), self.w0)
            t = min(float(e["ts"]) + float(e["dur"]), self.w1)
            if t > s:
                yield e, s, t

    def busy(self) -> list:
        return _union([[s, t] for _, s, t in self.clipped()])

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) / 1e6

    def innermost(self, tid, ts: float):
        """The innermost span open on thread tid at time ts, or None."""
        nest = self.spans.get(tid)
        return nest.innermost(ts) if nest else None

    def device_s_by_span(self) -> dict:
        """Device seconds of the kernels launched inside each span name
        ("" for launches outside every span or without a launch record)."""
        out = defaultdict(float)
        for e, s, t in self.clipped():
            if e.get("cat") != "kernel":
                continue
            c = (e.get("args") or {}).get("correlation")
            hit = self.launches.get(c)
            name = self.innermost(*hit) if hit else None
            out[name or ""] += (t - s) / 1e6
        return dict(out)

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for e, s, t in self.clipped():
            by[e.get("name", "?")] += (t - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, main_tid, n: int = 10) -> list:
        """Idle seconds of the device inside the window, each stretch of a
        gap given to the innermost span the main thread was in over it
        ("host" where it was in none but the window's)."""
        busy = self.busy()
        gaps, at = [], self.w0
        for s, t in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if at < self.w1:
            gaps.append((at, self.w1))
        nest = self.spans.get(main_tid)
        edges = sorted({x for a, b, _ in nest.spans for x in (a, b)}) \
            if nest else []
        by = defaultdict(float)
        for s, t in gaps:
            cuts = [s] + edges[bisect_right(edges, s) : bisect_right(edges, t)]
            for a, b in zip(cuts, cuts[1:] + [t]):
                if b <= a:
                    continue
                name = nest.innermost((a + b) / 2) if nest else None
                name = "host" if name in (None, WINDOW) else name
                by[name] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def main_tid(events: list):
    """The thread of the window range: the harness's main thread."""
    for e in events:
        if e.get("name") == WINDOW:
            return e.get("tid")
    return None


class _Nest:
    """One thread's spans, which nest: each span's parent is the
    innermost span that contains it.  The innermost span containing a time
    is the last span to start before it or an ancestor of that span."""

    def __init__(self, spans: list):
        spans.sort(key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in spans]
        self.spans = spans
        self.parent, stack = [], []
        for i, (s, t, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, ts: float):
        i = bisect_right(self.starts, ts) - 1
        while i >= 0 and self.spans[i][1] < ts:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else None
