#!/usr/bin/env python3
"""Profile chip_smoke.py's phase 3 of one or more checkouts on one card.

    python3 tools/profile_phase3.py DIR [DIR ...] [--seed N]

Each DIR is a checkout of this repository.  In turn, a fresh process in
DIR builds that checkout's kernels (chip_smoke.phase_build) and runs its
phase 3 (the port's `consensus --region-batch 8` on 8 x 1 kb regions at
10X, widths 300/100/20, -i 4, f32) under torch.profiler
(chip_smoke.phase_e2e with a profile directory, which prints the trace's
per-kernel summary).  Give the checkouts in an interleaved order (A B B A)
to compare two on one card.  For each run one line `[profile] {json}`
follows: the checkout, the phase's wall, mean accuracy and peak device
memory (torch.cuda.max_memory_allocated), the traced wall and the device's
busy share, launches and device ms of every kernel, of the port's hand
kernels by name and of the rest (torch's own kernels: the torch-op
stages), the torch kernels whose names show a sort, cummax, cummin or
searchsorted, and the card's name and power limit.  The traces are
deleted.  Needs a CUDA card; exits non-zero when a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# the port's hand kernels, by their names in csrc/
HAND = ("fill_kernel", "group_kernel", "sum_rows_kernel", "backtrace_kernel",
        "sweep_kernel", "sample_kernel", "gumbel_kernel", "obs_kernel",
        "likes_kernel", "geom_kernel", "windows_kernel")
SEARCHED = ("sort", "cummax", "cummin", "searchsorted", "scan")

CHILD = r"""
import glob, json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
from poreseq_tpu_torch import trace_summary
chip_smoke.phase_build()
prof = sys.argv[2]
_, e2e = chip_smoke.phase_e2e(int(sys.argv[1]), prof)
trace = glob.glob(os.path.join(prof, "*.trace.json"))
print("[child] " + json.dumps(dict(
    wall_s=e2e["wall"], acc=e2e["acc"], peak_mib=e2e["peak"] / 2**20,
    trace=trace_summary.summarize(trace[0]) if len(trace) == 1 else None,
    card=chip_smoke.gpu_line())), flush=True)
"""


def hand_name(name: str) -> str | None:
    for h in HAND:
        if f" {h}<" in f" {name}" or f"::{h}<" in name or name.startswith(h):
            return h
    return None


def run(checkout: str, seed: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="psq_prof_") as prof:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(seed), prof],
                              cwd=checkout, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    lines = [l for l in proc.stdout.splitlines() if l.startswith("[child] ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"profile_phase3: the run in {checkout} failed "
                         f"(exit {proc.returncode})")
    child = json.loads(lines[-1][len("[child] "):])
    tr = child.pop("trace")
    if tr is None:
        raise SystemExit(f"profile_phase3: no single trace in {checkout}")
    hand, rest, searched = {}, [0, 0.0], {}
    for name, k in tr["kernels"].items():
        h = hand_name(name)
        if h:
            e = hand.setdefault(h, [0, 0.0])
            e[0] += k["launches"]
            e[1] += k["device_ms"]
            continue
        rest[0] += k["launches"]
        rest[1] += k["device_ms"]
        if any(w in name.lower() for w in SEARCHED):
            searched[name[:120]] = [k["launches"], k["device_ms"]]
    return dict(
        checkout=os.path.abspath(checkout), **child,
        traced_wall_ms=tr["wall_ms"], busy_ms=tr["busy_ms"],
        busy_share=tr["busy_share"],
        all_kernels=[sum(k["launches"] for k in tr["kernels"].values()),
                     sum(k["device_ms"] for k in tr["kernels"].values())],
        hand=hand, torch_ops=rest, torch_sort_scan=searched)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkouts", nargs="+", metavar="DIR")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for d in args.checkouts:
        print("[profile] " + json.dumps(run(d, args.seed)), flush=True)


if __name__ == "__main__":
    main()
