"""Summarize a torch.profiler Chrome trace of a port run (what the CLI's
``--profile DIR`` writes): device time and launches per kernel, and how
much of the traced wall the device was busy.

    python -m poreseq_tpu_torch.trace_summary DIR/poreseq_torch.PID.trace.json

Device activity is every complete event of category kernel, gpu_memcpy or
gpu_memset; busy time is the union of their intervals, and the wall runs
from the trace's first event to its last.  Prints one line per kernel name
(most device time first) and a JSON summary as the last line.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(path: str) -> dict:
    """{"wall_ms", "busy_ms", "busy_share", "kernels": {name: {"launches",
    "device_ms"}}} of one trace."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    device = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                     for e in events if e.get("cat") in DEVICE_CATS),
                    key=lambda x: x[0])
    kernels = defaultdict(lambda: {"launches": 0, "device_ms": 0.0})
    busy, end = 0.0, None
    for s, t, e in device:
        if e["cat"] == "kernel":
            kernels[e["name"]]["launches"] += 1
            kernels[e["name"]]["device_ms"] += (t - s) / 1e3
        if end is None or s > end:            # a new busy stretch
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    wall = (t1 - t0) / 1e3
    return {"wall_ms": wall, "busy_ms": busy / 1e3,
            "busy_share": busy / 1e3 / wall if wall > 0 else 0.0,
            "kernels": dict(sorted(kernels.items(),
                                   key=lambda kv: -kv[1]["device_ms"]))}


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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
