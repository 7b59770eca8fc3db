#!/usr/bin/env python3
"""Consensus throughput of the port's CLI at one region batch: R regions of
1 kb at 10X through `consensus -i 4 --region-batch N` (the counterpart of
scripts/bench_consensus.py, which measures the JAX package).

    python3 tools/bench_consensus.py [R] [--batch N] [--coverage C]
        [--region-length L] [--draft-error E] [--repeat K]
        [--backend torch|exact] [--device cuda] [--keep]

--batch 1 runs the regions one after the other, --batch R (the default)
as one lockstep batch.  The run is tools/bench.py's build_run (seed 0,
(coverage / 2) x R reads, at least 4, of L + 200 b, widths 300/100/20);
the kernels are built before the first run.  Each of the --repeat runs is
a wall closed by a synchronize on the card; the last is reported as
total_s (the steady state), the first as first_s.  mean_acc holds each
region to the truth over its own coordinates (the script's window, not
bench.py's widened one).

Prints ONE JSON line: regions, batch, coverage, backend, total_s, first_s,
s_per_region, regions_per_hour, vs_ref_2min_per_kb, mean_acc, n_out, with
device, runs_s, peak_device_mib and the card's name and power limit.  Any
failure exits non-zero; `--device cpu` runs the plain twins (tests only).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools import bench as tb  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("regions", type=int, nargs="?", default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="region batch size (default: all regions)")
    ap.add_argument("--coverage", type=int, default=10)
    ap.add_argument("--region-length", type=int, default=1000)
    ap.add_argument("--backend", default="torch", choices=("torch", "exact"))
    ap.add_argument("--device", default="cuda",
                    help="the engine's torch device (cuda, cuda:N; cpu for "
                    "tests only)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--draft-error", type=float, default=0.02)
    ap.add_argument("--repeat", type=int, default=1)
    return ap.parse_args(argv)


def build(args, d: str) -> dict:
    """The script's run in d (tools/bench.py build_run)."""
    R, L = args.regions, args.region_length
    return tb.build_run(d, R, L, n_reads=max((args.coverage // 2) * R, 4),
                        read_len=L + 200, draft_error=args.draft_error)


def run(args, built: dict | None = None) -> dict:
    """--repeat consensus runs on the run ``built`` (default: one built in
    a temporary directory, removed unless --keep); the result line."""
    from poreseq_tpu_torch.api import swalign
    from poreseq_tpu_torch.io.fasta import read_fasta

    card = tb.on_card(args.device, args.backend)
    d = built["dir"] if built else tempfile.mkdtemp(prefix="psq_bench_")
    try:
        t0 = time.perf_counter()
        r = built or build(args, d)
        sys.stderr.write("synth run built in {:.1f}s ({} bp)\n".format(
            time.perf_counter() - t0, args.regions * args.region_length))
        if card:
            tb.build_kernels()
        batch = args.batch or args.regions
        out = os.path.join(d, "out.b{}.fasta".format(batch))
        argv = tb.consensus_argv(r, out, batch, args.backend, args.device)
        times, peaks = [], []
        for rep in range(args.repeat):
            dt, peak = tb.consensus_once(argv, out, card, args.backend)
            times.append(dt)
            peaks.append(peak)
            sys.stderr.write("run {}: {:.1f}s\n".format(rep, dt))
        seqs = read_fasta(out)
        accs = [swalign(s, r["truth"][int(n.split(":")[1])
                                      : int(n.split(":")[2])])[0]
                for n, s in seqs.items()]
    finally:
        if not built and not args.keep:
            shutil.rmtree(d, ignore_errors=True)
    dt = times[-1]        # steady state: the kernels and caches are warm
    n = len(seqs)
    return dict(
        regions=args.regions, batch=batch, coverage=args.coverage,
        backend=args.backend, total_s=round(dt, 2), first_s=round(times[0], 2),
        s_per_region=round(dt / max(n, 1), 2),
        regions_per_hour=round(3600.0 * n / dt, 1),
        vs_ref_2min_per_kb=round(120.0 * n / dt, 1),
        mean_acc=round(float(np.mean(accs)), 3) if accs else None,
        n_out=n, runs_s=times,
        device=args.device if args.backend == "torch" else None,
        peak_device_mib=max(peaks) if card else None,
        **(tb.card() if card else dict(card=None, power_limit=None)),
        **(dict(workdir=d) if args.keep and not built else {}))


def main(argv=None):
    print(json.dumps(run(parse(argv))), flush=True)


if __name__ == "__main__":
    main()
