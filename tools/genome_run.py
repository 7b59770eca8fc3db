#!/usr/bin/env python3
"""Genome-scale polish on the port: split -> consensus -> merge through the
port's own command line, on a simulated genome.

    python3 tools/genome_run.py lambda [--region-length 10000] [--read-len N]
        [--genome 48500] [--coverage 10] [--batch 8] [--iterations 4]
        [--draft-error 0.02] [--backend torch|exact] [--device cuda|cpu]
        [--params FILE] [--keep]
    python3 tools/genome_run.py sharded [--genome 500000] [--shards 2]
        [--limit 24] [--region-length 2000] [--read-len 8000] [...]

``lambda`` is BASELINE config 4 (the arguments and defaults of
scripts/bench_lambda.py): a 48.5 kb genome at 10X, reads of the region
length + 400 b unless --read-len says otherwise, overlapping regions
(`split -R`, 1 kb overlap), `consensus --region-batch 8 -i 4` at widths
300/100/20, `merge`, and the merged contig's accuracy against the truth.
``sharded`` is BASELINE config 5 (scripts/bench_ecoli.py's): a 500 kb
genome, 2 kb regions, 8 kb reads, the first shards x limit regions dealt
round-robin with `--shard-index/--num-shards`, the shards run one after the
other on the one device, and every shard's output merged; accuracy is over
the covered prefix.  Reads longer than their region carry a trim hint
(Event.trim), which bounds the batch's level axis.

The engine runs on the card (`--device cuda`, the default) unless --device
cpu asks for the CPU, where the kernels' plain twins run (keep the widths
narrow there: --params FILE replaces the widths file the tool writes).
`--backend exact` runs the CPU oracle.  The synthetic run is made from seed
0 in a temporary directory, removed unless --keep.

Prints one JSON line: genome_bp, regions, regions_done, regions_skipped,
consensus_s (the summed walls of the consensus calls), kb_per_hour (the
covered kilobases over consensus_s), regions_per_hour, merged_contigs,
merged_accuracy_pct, peak_device_mib (torch.cuda.max_memory_allocated
over the consensus calls; null on the CPU), the card's name and power
limit as nvidia-smi gives them (null on the CPU), and the mode's own
fields (shards, shard_walls_s, covered_bp; workdir under --keep).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WIDTHS = ("realign_width = 300\nscoring_width = 100\npoint_width = 20\n"
          "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 300\n"
          "max_length = {}\nlik_offset = 4.5\n")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    modes = ap.add_subparsers(dest="mode", required=True)
    lam = modes.add_parser("lambda", help="BASELINE config 4 "
                           "(scripts/bench_lambda.py)")
    lam.add_argument("--genome", type=int, default=48500)
    lam.add_argument("--region-length", type=int, default=10000)
    lam.add_argument("--read-len", type=int, default=None,
                     help="read length (default region length + 400)")
    lam.set_defaults(shards=1, limit=0)
    sh = modes.add_parser("sharded", help="BASELINE config 5 "
                          "(scripts/bench_ecoli.py)")
    sh.add_argument("--genome", type=int, default=500000)
    sh.add_argument("--region-length", type=int, default=2000)
    sh.add_argument("--read-len", type=int, default=8000)
    sh.add_argument("--shards", type=int, default=2)
    sh.add_argument("--limit", type=int, default=24,
                    help="regions per shard to run (0 = all)")
    for p in (lam, sh):
        p.add_argument("--coverage", type=int, default=10)
        p.add_argument("--batch", type=int, default=8)
        p.add_argument("--backend", default="torch",
                       choices=("torch", "exact"))
        p.add_argument("--draft-error", type=float, default=0.02)
        p.add_argument("--iterations", type=int, default=4)
        p.add_argument("--device", default="cuda",
                       help="the engine's torch device (cuda, cuda:N, cpu)")
        p.add_argument("--params", default=None,
                       help="params file in place of the 300/100/20 one")
        p.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)
    args.read_len = args.read_len or args.region_length + 400
    return args


def build(args, d: str) -> dict:
    """The simulated run in d (write_run, seed 0, the scripts' read count),
    its params file and the regions to run (the CLI's `split`, the first
    shards x limit of them when limit is set)."""
    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.io import npz_h5
    from poreseq_tpu_torch.sim import write_run

    npz_h5.use_where_missing()
    n_reads = max(args.coverage * args.genome // (2 * args.read_len), 4)
    truth, _, reads, bam, fasta = write_run(
        d, np.random.default_rng(0), ref_len=args.genome, n_reads=n_reads,
        read_len=args.read_len, draft_error=args.draft_error)
    conf = os.path.join(d, "params.conf")
    if args.params:
        shutil.copyfile(args.params, conf)
    else:
        with open(conf, "w") as f:
            f.write(WIDTHS.format(args.region_length))
    cli.main(["split", fasta, "-R", str(args.region_length), "-n", "1"])
    with open(os.path.splitext(fasta)[0] + ".1.region") as f:
        regions = f.read().split()
    n_run = (min(args.shards * args.limit, len(regions)) if args.limit
             else len(regions))
    rf = os.path.join(d, "regions.txt")
    with open(rf, "w") as f:
        f.write("\n".join(regions[:n_run]) + "\n")
    return dict(dir=d, truth=truth, fasta=fasta, bam=bam, reads=reads,
                conf=conf, regions=regions[:n_run], regions_total=len(regions),
                region_file=rf, n_reads=n_reads)


def consensus(args, run: dict) -> tuple[list, list]:
    """`consensus` of each shard in turn on the one device: (output paths,
    walls in s, each closed by a synchronize on the card)."""
    import torch

    from poreseq_tpu_torch import cli

    card = args.backend == "torch" and args.device.startswith("cuda")
    outs, walls = [], []
    for si in range(args.shards):
        out = os.path.join(run["dir"], f"out.s{si}.fasta")
        argv = ["consensus", run["fasta"], run["bam"], run["reads"], "-R",
                run["region_file"], "-p", run["conf"], "-o", out, "-i",
                str(args.iterations), "--backend", args.backend,
                "--region-batch", str(args.batch)]
        if args.backend == "torch":
            argv += ["--device", args.device]
        if args.shards > 1:
            argv += ["--num-shards", str(args.shards), "--shard-index",
                     str(si)]
        t0 = time.perf_counter()
        cli.main(argv)
        if card:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs.append(out)
        sys.stderr.write(f"shard {si}/{args.shards}: {walls[-1]:.1f} s\n")
    return outs, walls


def merge(run: dict, outs: list, name: str = "merged.fasta") -> tuple:
    """The CLI's `merge` of every shard's output into the run's directory:
    (merged path, contigs)."""
    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.io.fasta import read_fasta

    merged = os.path.join(run["dir"], name)
    cli.main(["merge", merged] + list(outs))
    return merged, read_fasta(merged)


def covered_end(regions: list) -> int:
    """The end of the last region run: the covered prefix's end."""
    return max(int(r.split(":")[2]) for r in regions)


def merged_accuracy(contigs: dict, truth: str, end: int) -> float:
    """The longest merged contig's accuracy (%) against the truth's covered
    prefix, widened by 400 b for the draft's indel drift."""
    from poreseq_tpu_torch.api import swalign

    if not contigs:
        return 0.0
    return float(swalign(max(contigs.values(), key=len),
                         truth[: end + 400])[0])


def card() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in line.split(","))
    return dict(card=name, power_limit=power)


def run(args) -> dict:
    """Build, polish and merge; the result line as a dict."""
    import torch

    from poreseq_tpu_torch.io.fasta import read_fasta

    on_card = args.backend == "torch" and args.device.startswith("cuda")
    if on_card and not torch.cuda.is_available():
        raise SystemExit("genome_run: --device cuda but torch sees no CUDA "
                         "card (use --device cpu for the CPU)")
    d = tempfile.mkdtemp(prefix="psq_genome_")
    try:
        t0 = time.perf_counter()
        r = build(args, d)
        sys.stderr.write(
            f"{args.genome} bp, {r['n_reads']} reads of {args.read_len} b, "
            f"{len(r['regions'])} of {r['regions_total']} regions of "
            f"{args.region_length} b, {args.shards} shard(s), built in "
            f"{time.perf_counter() - t0:.1f} s\n")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        outs, walls = consensus(args, r)
        peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
        _, contigs = merge(r, outs)
        end = min(covered_end(r["regions"]), args.genome)
        done = sum(len(read_fasta(o)) for o in outs)
        dt = sum(walls)
        res = dict(
            mode=args.mode, genome_bp=args.genome, coverage=args.coverage,
            batch=args.batch, region_length=args.region_length,
            read_len=args.read_len, regions=len(r["regions"]),
            regions_done=done, regions_skipped=len(r["regions"]) - done,
            consensus_s=dt, kb_per_hour=3600.0 * end / 1000.0 / dt,
            regions_per_hour=3600.0 * done / dt,
            merged_contigs=len(contigs),
            merged_accuracy_pct=merged_accuracy(contigs, r["truth"], end),
            peak_device_mib=peak, shards=args.shards, shard_walls_s=walls,
            regions_total=r["regions_total"], covered_bp=end,
            backend=args.backend,
            device=args.device if args.backend == "torch" else None,
            **(card() if on_card else dict(card=None, power_limit=None)))
        if args.keep:
            res["workdir"] = d
        return res
    finally:
        if not args.keep:
            shutil.rmtree(d, ignore_errors=True)


def main(argv=None):
    print(json.dumps(run(parse(argv))), flush=True)


if __name__ == "__main__":
    main()
