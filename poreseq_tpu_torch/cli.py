"""Command line of the PyTorch / CUDA port.

Subcommands, with the JAX CLI's flags plus ``--device`` (cuda, cuda:N or
cpu) on those that run the engine:

- ``consensus``: ``pipeline.mutate_many`` on a TorchEngine:
  regions are corrected in lockstep batches of --region-batch, the next
  batch's loads are prefetched on a thread, and a batch that runs out of
  memory is retried at half its width (width 1 skips the region).
  --shard-index/--num-shards deal the regions round-robin by hand,
  --coordinator/--num-processes/--process-id do it for a multi-process run
  (each process writes OUTPUT.pN), --profile DIR writes a torch.profiler
  Chrome trace.
- ``variant``: ``pipeline.variant`` per region (-f variant sequences,
  -m a mutation file, -a every point mutation); scores go to stdout.
- ``train``: hill-climbs the transition parameters: every iteration's 16
  proposals run as one lockstep batch (``pipeline.train_candidates``) and
  the best goes to ./train_best.conf.  -n/--threads is accepted and
  unused: a fork pool cannot share a CUDA context.
- ``split``, ``merge``, ``extract``: copies of the JAX CLI's.

Failure units: a region that fails to load (or, in ``variant``, to realign
to a variant) prints ``Skipping <region>: <error>`` and the run goes on;
running out of memory shrinks the batch, then skips the region; a failure
inside the engine (``EngineError``: a build, a refused launch, a device
fault) ends the run with a non-zero exit.

    python -m poreseq_tpu_torch.cli consensus ref.fasta reads.bam fast5/ \\
        -R regions.txt -p params.conf -o out.fasta --region-batch 8
"""

from __future__ import annotations

import argparse
import gc
import glob
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from . import pipeline
from .core.params import load_params, save_params, vary_params
from .core.regions import MutationInfo, RegionInfo
from .engine import EngineError, TorchEngine
from .io.fasta import read_fasta
from .io.regions_io import (extract_fasta, merge_fasta, split_fasta,
                            split_regions)
from .parallel.distributed import (allgather_round_robin, finish_multihost,
                                   init_multihost, shard_regions)

OUT_OF_MEMORY = (torch.cuda.OutOfMemoryError, MemoryError)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="poreseq-torch")
    subparsers = parser.add_subparsers(help="Nanopore sequence consensus "
                                       "(PyTorch / CUDA engine)")
    p = subparsers.add_parser(
        "consensus", help="run consensus algorithm using alignment")
    _add_inputs(p)
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
    p.add_argument("--shard-index", type=int, default=0,
                   help="this worker's index for manual region sharding")
    p.add_argument("--num-shards", type=int, default=1,
                   help="total workers; regions are dealt round-robin")
    p.add_argument("--region-batch", type=int, default=1,
                   help="process this many regions per lockstep batch")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                   "into DIR")
    _add_multihost(p, "; regions are dealt round-robin across processes "
                   "and each process writes OUTPUT.pN")
    _add_device(p)
    p.set_defaults(func=consensus)

    p = subparsers.add_parser("variant", help="call sequence variants")
    _add_inputs(p)
    group = p.add_mutually_exclusive_group(required=True)
    group.add_argument("-f", "--fasta", default=None,
                       help="fasta of variant sequences to test")
    group.add_argument("-m", "--mut-file", default=None,
                       help="file with mutations to test")
    group.add_argument("-a", "--all", action="store_true", default=False,
                       help="test all single-base mutations")
    group = p.add_mutually_exclusive_group(required=False)
    group.add_argument("-r", "--region", default=None)
    group.add_argument("-R", "--region-file", default=None)
    p.add_argument("-p", "--params", default=None)
    p.add_argument("-v", "--verbose", action="count", default=0)
    _add_multihost(p, "; regions are dealt round-robin across processes")
    _add_device(p)
    p.set_defaults(func=variant)

    p = subparsers.add_parser("train", help="train model parameters on data")
    _add_inputs(p)
    p.add_argument("-i", "--iter", type=int, default=30)
    p.add_argument("-n", "--threads", type=int, default=4,
                   help="accepted and unused: the candidates run as one "
                   "lockstep batch")
    p.add_argument("-p", "--params", default=None)
    p.add_argument("-r", "--region", default=None)
    p.add_argument("-d", "--descend", action="store_true", default=False,
                   help="Run consensus by descending from reference")
    _add_multihost(p, "; each process evaluates a round-robin share of "
                   "the proposals")
    _add_device(p)
    p.set_defaults(func=train)

    p = subparsers.add_parser("split", help="split fasta files into chunks")
    p.add_argument("fasta")
    p.add_argument("-R", "--region-length", type=int, default=None)
    group = p.add_mutually_exclusive_group(required=True)
    group.add_argument("-n", "--num-files", type=int, default=None)
    group.add_argument("-m", "--per-file", type=int, default=None)
    p.set_defaults(func=split)

    p = subparsers.add_parser("merge", help="merge corrected fasta files")
    p.add_argument("fasta_out")
    p.add_argument("fasta_in", nargs="+")
    p.set_defaults(func=merge)

    p = subparsers.add_parser("extract", help="extract fasta from fast5")
    p.add_argument("dirs", nargs="+")
    p.add_argument("fasta")
    p.add_argument("-p", "--path", action="store_true", default=False)
    p.set_defaults(func=extract)

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return
    args.func(args)


def _add_inputs(p):
    p.add_argument("ref", help="reference fasta file")
    p.add_argument("bam", help="input BAM file")
    p.add_argument("dir", help="root fast5 directory")


def _add_multihost(p, what: str):
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="address of the multi-process run's store, hosted "
                   "by process 0 (or set PSQ_COORDINATOR)" + what)
    p.add_argument("--num-processes", type=int, default=None,
                   help="total processes in the multi-process run")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index in the multi-process run")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda, cuda:N or cpu); "
                   "in a multi-process run give each process its own")


def parse_regions(args):
    """Region resolution (cmdline.py:127-165)."""
    regions = []
    if getattr(args, "region_file", None) is not None:
        if os.path.isfile(args.region_file):
            regions += [x.strip() for x in open(args.region_file).readlines()]
    reginfo = RegionInfo(args.region)
    if reginfo.start is not None:
        regions.append(args.region)
    if regions == []:
        if "max_length" in args.params:
            regions = split_regions(args.ref, args.params["max_length"],
                                    userefs=args.region)
        else:
            regions = split_regions(args.ref, 10000, userefs=args.region)
    return regions


def _join(args) -> tuple:
    return init_multihost(args.coordinator, args.num_processes,
                          args.process_id)


def _release(device: torch.device):
    """Drop a failed batch's device buffers before a smaller retry."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def consensus(args):
    if not args.profile:
        _consensus(args)
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            _consensus(args)
    finally:
        path = os.path.join(args.profile,
                            "poreseq_torch.{}.trace.json".format(os.getpid()))
        prof.export_chrome_trace(path)
        sys.stderr.write("Profile written to {}\n".format(path))


def _consensus(args):
    args.params = load_params(args.params)
    args.params["verbose"] = args.verbose
    regions = parse_regions(args)

    pid, nproc, store = _join(args)
    if nproc > 1:
        regions = shard_regions(regions, pid, nproc)
        if args.output is not None:
            args.output = "{}.p{}".format(args.output, pid)
        sys.stderr.write("Process {}/{}: {} regions -> {}\n".format(
            pid, nproc, len(regions), args.output or "stdout"))
    if args.num_shards > 1:
        regions = shard_regions(regions, args.shard_index, args.num_shards)

    device = torch.device(args.device)
    engine = TorchEngine(device=device)

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
        return pipeline.load_many(args.ref, args.bam, args.dir, part,
                                  params=args.params, engine=engine)

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
                # a span per batch in --profile traces (free without one)
                with record_function("poreseq.batch[{}]".format(len(part))):
                    results = pipeline.mutate_many(
                        args.ref, args.bam, args.dir, part,
                        params=args.params, test=args.test,
                        verbose=args.verbose, reps=args.iterations,
                        engine=engine, loaded=loaded)
            except OUT_OF_MEMORY as e:
                if width == 1:
                    sys.stderr.write("Skipping {}: {}\n".format(part[0], e))
                    continue
                sys.stderr.write(
                    "Batch of {} failed ({}), retrying at {}\n".format(
                        len(part), e, max(width // 2, 1)))
                _release(device)
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
    finish_multihost(pid, nproc, store)


def variant(args):
    args.params = load_params(args.params)
    regions = parse_regions(args)

    # multi-process: regions dealt round-robin, scores go to each process's
    # own stdout.  The mutation partitioning below still walks EVERY region
    # in order (it consumes the list sequentially): sharding skips only the
    # execution, not the bookkeeping.
    pid, nproc, store = _join(args)
    if nproc > 1:
        sys.stderr.write("Process {}/{}: {} of {} regions\n".format(
            pid, nproc, len(regions[pid::nproc]), len(regions)))
    device = torch.device(args.device)
    engine = TorchEngine(device=device)

    muts = []
    if args.mut_file is not None:
        for line in open(args.mut_file).readlines():
            mi = MutationInfo(line)
            if mi.start < 0:
                continue
            muts.append(mi)

    if "end_trim" not in args.params:
        args.params["end_trim"] = 0
    for ri, region in enumerate(regions):
        reginfo = RegionInfo(region)
        curmuts = [x for x in muts
                   if x.start < reginfo.end - args.params["end_trim"]]
        muts = [x for x in muts
                if x.start >= reginfo.end - args.params["end_trim"]]
        # -m skips regions without mutations; -f and -a run every region
        # (the JAX CLI's condition, `curmuts == [] and not args.all`, also
        # skips every -f region, since -f reads no mutations)
        if args.mut_file is not None and curmuts == []:
            continue
        if nproc > 1 and ri % nproc != pid:
            continue
        try:
            pipeline.variant(args.ref, args.bam, args.dir, args.fasta,
                             curmuts, region, args.params, args.verbose,
                             engine=engine)
        except OUT_OF_MEMORY as e:
            sys.stderr.write("Skipping {}: {}\n".format(region, e))
            _release(device)
        except EngineError:
            raise
        except Exception as e:
            # the region's own failure unit: its load (io/load.py) or its
            # realignment to a variant sequence (PSAlign.RealignTo)
            sys.stderr.write("Skipping {}: {}\n".format(region, e))
    finish_multihost(pid, nproc, store)


def _train_batch(args, cands, engine):
    """One iteration's candidates as one lockstep batch; a batch that runs
    out of memory is split in halves (a region's results do not depend on
    its batch).  A single candidate that does not fit raises."""
    try:
        return pipeline.train_candidates(args.ref, args.bam, args.dir,
                                         args.region, cands,
                                         descend=args.descend,
                                         engine=engine)
    except OUT_OF_MEMORY as e:
        if len(cands) == 1:
            raise
        half = len(cands) // 2
        sys.stderr.write("Batch of {} failed ({}), retrying at {}\n".format(
            len(cands), e, half))
        _release(engine.device)
        return (_train_batch(args, cands[:half], engine)
                + _train_batch(args, cands[half:], engine))


def train(args):
    """Hill-climb on consensus accuracy (the JAX CLI's tpu path): every
    iteration proposes 16 parameter sets and keeps the most accurate."""
    pid, nproc, store = _join(args)
    engine = TorchEngine(device=args.device)

    params = load_params(args.params)
    for i in range(args.iter):
        if nproc > 1:
            # every process proposes the same list (its rng is seeded from
            # the shared state), evaluates its round-robin share, and the
            # accuracies are allgathered before the replicated argmax
            rng = random.Random("{}|{}".format(i, sorted(params.items())))
            paramlist = vary_params(params, rng=rng)
            mine = paramlist[pid::nproc]
        else:
            paramlist = vary_params(params)
            mine = paramlist
        accs = [s[1] for s in _train_batch(args, mine, engine)]
        if nproc > 1:
            accs = allgather_round_robin(accs, len(paramlist), pid, nproc,
                                         store)
        params = paramlist[int(np.argmax(accs))]
        save_params("train_best.conf", params)
        sys.stderr.write("Best at iter {}: {}\n".format(i + 1, max(accs)))
    finish_multihost(pid, nproc, store)


def extract(args):
    fast5files = []
    for d in args.dirs:
        fast5files += glob.glob(os.path.join(d, "*.fast5"))
    extract_fasta(fast5files, args.fasta, args.path, False)


def split(args):
    if args.region_length is None:
        split_fasta(args.fasta, args.num_files, args.per_file)
    else:
        split_regions(args.fasta, args.region_length, args.num_files,
                      args.per_file)


def merge(args):
    merge_fasta(args.fasta_in, args.fasta_out)


if __name__ == "__main__":
    main()
