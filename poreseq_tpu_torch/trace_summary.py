"""Summarize a torch.profiler Chrome trace of a port run (what the CLI's
``--profile DIR`` writes): device time and launches per kernel, how much
of the traced wall the device was busy, the device's idle time by what the
main thread was doing, and the run's counters.

    python -m poreseq_tpu_torch.trace_summary DIR/poreseq_torch.PID.trace.json

Device activity is every complete event of category kernel, gpu_memcpy or
gpu_memset; busy time is the union of their intervals, and the wall runs
from the trace's first event to its last.  Each stretch of the wall the
device is idle goes to the innermost of the port's ``psq.*`` spans
(``obs.py``) open on the main thread (the thread of the ``psq.batch``
spans) over it, "-" where none is.  The counter totals come from the
``poreseq_torch.PID.counts.json`` beside the trace, where there is one.
Prints one line per kernel name (most device time first), one per span
and per counter, and a JSON summary as the last line.
"""

from __future__ import annotations

import json
import os
import sys
from bisect import bisect_right
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(path: str) -> dict:
    """{"wall_ms", "busy_ms", "busy_share", "kernels": {name: {"launches",
    "device_ms"}}, "idle_ms_by_span": {span: ms}, "counts": {name: total}
    or None} of one trace."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    device = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                     for e in events if e.get("cat") in DEVICE_CATS),
                    key=lambda x: x[0])
    kernels = defaultdict(lambda: {"launches": 0, "device_ms": 0.0})
    busy, end, stretches = 0.0, None, []
    for s, t, e in device:
        if e["cat"] == "kernel":
            kernels[e["name"]]["launches"] += 1
            kernels[e["name"]]["device_ms"] += (t - s) / 1e3
        if end is None or s > end:            # a new busy stretch
            busy += t - s
            end = t
            stretches.append([s, t])
        elif t > end:
            busy += t - end
            end = t
            stretches[-1][1] = t
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    wall = (t1 - t0) / 1e3
    counts = None
    base = path[: -len(".trace.json")] if path.endswith(".trace.json") \
        else None
    if base and os.path.exists(base + ".counts.json"):
        with open(base + ".counts.json") as f:
            counts = json.load(f)["totals"]
    return {"wall_ms": wall, "busy_ms": busy / 1e3,
            "busy_share": busy / 1e3 / wall if wall > 0 else 0.0,
            "kernels": dict(sorted(kernels.items(),
                                   key=lambda kv: -kv[1]["device_ms"])),
            "idle_ms_by_span": idle_by_span(events, stretches, t0, t1),
            "counts": counts}


def idle_by_span(events: list, busy: list, t0: float, t1: float) -> dict:
    """Idle ms of the device in [t0, t1] (outside the sorted, disjoint
    ``busy`` stretches) by the innermost ``psq.*`` span of the main
    thread over each stretch of it, "-" outside every one."""
    main = next((e.get("tid") for e in events
                 if e.get("name") == "psq.batch"), None)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("tid") == main
                    and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("psq.")),
                   key=lambda x: (x[0], -x[1]))
    # the main thread's time in pieces, each under one innermost span
    pieces, stack, at = [], [], None
    for s, t, name in spans + [(float("inf"), float("inf"), None)]:
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            pieces.append((at, end, top))
            at = end
        if stack and s > at:
            pieces.append((at, s, stack[-1][1]))
        stack.append((t, name))
        at = s
    starts = [a for a, _, _ in pieces]
    out = defaultdict(float)
    edges = [t0] + [x for st in busy for x in st] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):    # the idle gaps
        idle = b - a
        i = max(bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, t, name = pieces[i]
            over = min(t, b) - max(s, a)
            if over > 0:
                out[name] += over / 1e3
                idle -= over
            i += 1
        if idle > 0:
            out["-"] += idle / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m poreseq_tpu_torch.trace_summary "
                         "TRACE")
    out = summarize(argv[0])
    for name, k in out["kernels"].items():
        print(f"{k['device_ms']:12.3f} ms {k['launches']:8d}  {name[:110]}")
    print(f"wall {out['wall_ms']:.3f} ms, device busy {out['busy_ms']:.3f} ms "
          f"({100 * out['busy_share']:.2f} %)")
    for name, ms in out["idle_ms_by_span"].items():
        print(f"{ms:12.3f} ms idle  {name}")
    for name, n in (out["counts"] or {}).items():
        print(f"{n:12d}  {name}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
