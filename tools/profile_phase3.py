#!/usr/bin/env python3
"""Profile chip_smoke.py's phase 3, or time its phase-2 kernels, of one or
more checkouts on one card.

    python3 tools/profile_phase3.py DIR [DIR ...] [--seed N] [--kernels]

Each DIR is a checkout of this repository.  In turn, a fresh process in
DIR builds that checkout's kernels (chip_smoke.phase_build, which prints
ptxas's registers and spills) and runs one of two things.  Give the
checkouts in an interleaved order (A B B A) to compare two on one card.
Needs a CUDA card; exits non-zero when a run fails.

Without --kernels: its phase 3 (the port's `consensus --region-batch 8` on
8 x 1 kb regions at 10X, widths 300/100/20, -i 4, f32) under
torch.profiler (chip_smoke.phase_e2e with a profile directory, which
prints the trace's per-kernel summary).  For each run one line
`[profile] {json}` follows: the checkout, the phase's wall, mean accuracy
and peak device memory (torch.cuda.max_memory_allocated), the traced wall
and the device's busy share, launches and device ms of every kernel, of
the port's hand kernels by name and of the rest (torch's own kernels: the
torch-op stages), the torch kernels whose names show a sort, cummax,
cummin or searchsorted, and the card's name and power limit.

With --kernels: its phase-2 checks in f32 that time the kernels at the
main path's shapes, chip_smoke.check_viterbi (the observations, sweep,
sampler and Gumbel kernel on phase 2b's 8 regions) and
chip_smoke.check_prologue (the likes, geometry and windows on a Mutate
round's 8-region batch), twice.  The first pass times each kernel by the
checkout's chip_smoke.event_ms (CUDA events around 20 launches: the
kernels line's yardstick, which reads the host's pace where a wrapper's
host time exceeds its kernel's).  The second runs under torch.profiler
with event_ms replaced by this tool's queued_ms (the same 20 launches
queued behind a spin kernel, so they run back to back on the card); the
trace gives each hand kernel's device ms per launch, the mean over every
launch of it in the checks (the sweep's with and without backpointers
alike).  Each check holds its kernels to their twins first and fails the
run if one differs.  For each run one line `[timing] {json}` follows:
the checkout, each kernel's events ms, bound_ms, bound_by, share and
twin's ms from the first pass, its queued ms, its profiler launches and
device ms per launch, and the card's name and power limit.  The traces
are deleted.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# the port's hand kernels, by their names in csrc/
HAND = ("fill_kernel", "group_kernel", "sum_rows_kernel", "backtrace_kernel",
        "sweep_kernel", "sample_kernel", "gumbel_kernel", "obs_kernel",
        "obs_rows_kernel", "likes_kernel", "geom_kernel", "windows_kernel")
SEARCHED = ("sort", "cummax", "cummin", "searchsorted", "scan")

PHASE3_CHILD = r"""
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

KERNELS_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from poreseq_tpu_torch import trace_summary
from poreseq_tpu_torch.engine import TorchEngine
sys.path.insert(0, sys.argv[3])
from profile_phase3 import queued_ms


def checks(seed):
    report = {}
    engine = TorchEngine("cuda", torch.float32)
    regions = chip_smoke._mut_regions(seed)
    chip_smoke.check_viterbi(engine, [d.events for d in regions["refine"][0]],
                             seed, False, report)
    chip_smoke.check_prologue(engine, regions["mutate"][0], False, report)
    return {name: line for (name, _), line in report.items()}


chip_smoke.phase_build()
seed, prof = int(sys.argv[1]), sys.argv[2]
events = checks(seed)
chip_smoke.event_ms = queued_ms
with profile(activities=[ProfilerActivity.CUDA]) as p:
    queued = checks(seed)
path = os.path.join(prof, "kernels.trace.json")
p.export_chrome_trace(path)
print("[child] " + json.dumps(dict(
    events=events, queued=queued,
    trace=trace_summary.summarize(path), card=chip_smoke.gpu_line())),
    flush=True)
"""


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn in ms: CUDA events around reps calls,
    after two warm-up calls, queued behind a spin kernel that keeps the card
    busy for twice the host's time to enqueue them, so that the calls run
    back to back on the card even where fn's host time exceeds its
    kernel's."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # clock cycles of the spin at the H100's 1.98 GHz boost clock
    torch.cuda._sleep(int(2 * host_s * 1.98e9) + 10000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# each timed kernel of the phase-2 checks, by its hand kernels' names
KERNEL_OF = {"viterbi_obs": ("obs_kernel", "obs_rows_kernel"),
             "viterbi_sweep": ("sweep_kernel",),
             "viterbi_sample": ("sample_kernel",),
             "viterbi_gumbel": ("gumbel_kernel",),
             "likes": ("likes_kernel",), "geom": ("geom_kernel",),
             "windows": ("windows_kernel",)}


def hand_name(name: str) -> str | None:
    for h in HAND:
        if f" {h}<" in f" {name}" or f"::{h}<" in name or name.startswith(h):
            return h
    return None


def child(checkout: str, code: str, seed: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="psq_prof_") as prof:
        proc = subprocess.run([sys.executable, "-c", code, str(seed), prof,
                               os.path.dirname(os.path.abspath(__file__))],
                              cwd=checkout, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    lines = [l for l in proc.stdout.splitlines() if l.startswith("[child] ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"profile_phase3: the run in {checkout} failed "
                         f"(exit {proc.returncode})")
    return json.loads(lines[-1][len("[child] "):])


def by_hand(kernels: dict) -> tuple[dict, list, dict]:
    """(launches and device ms of each hand kernel, of the rest, of the
    rest's sort and scan kernels) of a trace's kernels."""
    hand, rest, searched = {}, [0, 0.0], {}
    for name, k in kernels.items():
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
    return hand, rest, searched


def run(checkout: str, seed: int) -> dict:
    got = child(checkout, PHASE3_CHILD, seed)
    tr = got.pop("trace")
    if tr is None:
        raise SystemExit(f"profile_phase3: no single trace in {checkout}")
    hand, rest, searched = by_hand(tr["kernels"])
    return dict(
        checkout=os.path.abspath(checkout), **got,
        traced_wall_ms=tr["wall_ms"], busy_ms=tr["busy_ms"],
        busy_share=tr["busy_share"],
        all_kernels=[sum(k["launches"] for k in tr["kernels"].values()),
                     sum(k["device_ms"] for k in tr["kernels"].values())],
        hand=hand, torch_ops=rest, torch_sort_scan=searched)


def run_kernels(checkout: str, seed: int) -> dict:
    got = child(checkout, KERNELS_CHILD, seed)
    hand, _, _ = by_hand(got["trace"]["kernels"])
    kernels = {}
    for name, line in got["events"].items():
        n, ms = (sum(hand.get(h, [0, 0.0])[i] for h in KERNEL_OF[name])
                 for i in (0, 1))
        queued = got["queued"][name]
        kernels[name] = dict(
            events_ms=line["ms"], bound_ms=line["bound_ms"],
            bound_by=line["bound_by"], share=line["share"],
            plain_ms=line["plain_ms"], queued_ms=queued["ms"],
            profiler_launches=n, profiler_ms=ms / n if n else None)
        if "backpointers" in line:
            kernels[name]["backpointers"] = dict(
                events_ms=line["backpointers"]["ms"],
                queued_ms=queued["backpointers"]["ms"])
    return dict(checkout=os.path.abspath(checkout), kernels=kernels,
                card=got["card"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkouts", nargs="+", metavar="DIR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", action="store_true",
                    help="time the phase-2 kernels instead of profiling "
                         "phase 3")
    args = ap.parse_args()
    for d in args.checkouts:
        if args.kernels:
            print("[timing] " + json.dumps(run_kernels(d, args.seed)),
                  flush=True)
        else:
            print("[profile] " + json.dumps(run(d, args.seed)), flush=True)


if __name__ == "__main__":
    main()
