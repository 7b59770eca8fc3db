"""Command line of the PyTorch / CUDA port: ``consensus``.

The ``consensus`` subcommand takes the JAX CLI's positional arguments and
its -r/-R/-i/-p/-v/-o/-T/--resume/--region-batch flags, plus --device, and
runs ``pipeline.mutate_many`` on a registered TorchEngine: regions are
corrected in lockstep batches of --region-batch, the next batch's loads are
prefetched on a thread, and a batch that runs out of memory is retried at
half its width (width 1 skips the region); every other failure raises.

    python -m poreseq_tpu_torch.cli consensus ref.fasta reads.bam fast5/ \
        -R regions.txt -p params.conf -o out.fasta --region-batch 8
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from poreseq_tpu.cli import parse_regions
from poreseq_tpu.core.params import load_params
from poreseq_tpu.io.fasta import read_fasta
from poreseq_tpu.pipeline import load_many, mutate_many

from . import register_engine


def main(argv=None):
    parser = argparse.ArgumentParser(prog="poreseq-torch")
    subparsers = parser.add_subparsers(help="Nanopore sequence consensus "
                                       "(PyTorch / CUDA engine)")
    p = subparsers.add_parser(
        "consensus", help="run consensus algorithm using alignment")
    p.add_argument("ref", help="reference fasta file")
    p.add_argument("bam", help="input BAM file")
    p.add_argument("dir", help="root fast5 directory")
    group = p.add_mutually_exclusive_group(required=False)
    group.add_argument("-r", "--region", default=None,
                       help="region to correct (eg. 1000:3000 or "
                       "header_name:1000:3000)")
    group.add_argument("-R", "--region-file", default=None,
                       help="file containing region strings, one per line")
    p.add_argument("-i", "--iterations", type=int, default=4,
                   help="how many iterations to run")
    p.add_argument("-p", "--params", default=None,
                   help="parameter file to use")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="output verbosity (0-2)")
    p.add_argument("-o", "--output", default=None, help="output fasta file")
    p.add_argument("-T", "--test", action="store_true", default=False,
                   help="test mode: seed with loaded sequence, output score "
                   "as well")
    p.add_argument("--resume", action="store_true", default=False,
                   help="skip regions already present in the output fasta")
    p.add_argument("--region-batch", type=int, default=1,
                   help="process this many regions per lockstep batch")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda, cuda:N or cpu)")
    p.set_defaults(func=consensus)

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return
    args.func(args)


def consensus(args):
    args.params = load_params(args.params)
    args.params["verbose"] = args.verbose
    regions = parse_regions(args)
    device = torch.device(args.device)
    register_engine(device=device)

    # region-granular resume: output is flushed after every region
    done = set()
    if args.resume and args.output is not None and os.path.isfile(
            args.output):
        done = {name.split(" ")[0] for name in read_fasta(args.output)}
        out = open(args.output, "a")
    else:
        out = sys.stdout if args.output is None else open(args.output, "w")
    regions = [r for r in regions if r.split(" ")[0] not in done]
    for r in sorted(done):
        sys.stderr.write("Resuming past {}\n".format(r))

    def emit(region, seq, acc):
        if args.test:
            region += " [" + str(round(acc, 2)) + "]"
        out.write(">{}\n{}\n".format(region, seq))
        out.flush()

    def load_part(part):
        return load_many(args.ref, args.bam, args.dir, part,
                         params=args.params, backend="torch")

    # one loader thread prefetches the NEXT chunk's BAM/fast5 loads while
    # the device computes the current chunk
    loader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="psq-load")

    def run_chunk(chunk, width, prefetch=False):
        """Lockstep-batch a chunk, halving the batch width when it runs out
        of memory (recoverable at smaller widths); width 1 skips the region
        that still does not fit.  Any other failure (a build, a refused
        launch, a device fault) propagates."""
        parts = [chunk[at : at + width] for at in range(0, len(chunk), width)]
        fut = None
        for pi, part in enumerate(parts):
            loaded = None
            if prefetch:
                loaded = fut.result() if fut is not None else load_part(part)
                fut = (loader.submit(load_part, parts[pi + 1])
                       if pi + 1 < len(parts) else None)
            try:
                results = mutate_many(
                    args.ref, args.bam, args.dir, part, params=args.params,
                    test=args.test, verbose=args.verbose,
                    reps=args.iterations, backend="torch", loaded=loaded)
            except (torch.cuda.OutOfMemoryError, MemoryError) as e:
                if width == 1:
                    sys.stderr.write("Skipping {}: {}\n".format(part[0], e))
                    continue
                sys.stderr.write(
                    "Batch of {} failed ({}), retrying at {}\n".format(
                        len(part), e, max(width // 2, 1)))
                # release the failed batch's device buffers before retrying
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                run_chunk(part, max(width // 2, 1))
                continue
            for region, res in zip(part, results):
                if res is not None:   # None = region skipped during load
                    emit(region, res[0], res[1])

    try:
        run_chunk(regions, max(int(args.region_batch or 1), 1),
                  prefetch=True)
    finally:
        loader.shutdown(wait=False, cancel_futures=True)
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    main()
