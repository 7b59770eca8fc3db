"""Command line of the PyTorch / CUDA port.

Subcommands, with the JAX CLI's flags plus ``--device`` (cuda, cuda:N or
cpu) on those that run the engine.  ``--backend`` picks the engine of
``consensus``, ``variant`` and ``train``: ``torch`` (the default), a
TorchEngine on ``--device``, or ``exact``, the CPU oracle
(``engine/exact``, bit-faithful to the reference; it has no device, so
``--device`` other than the default and ``--mesh`` are errors, exit 2).

- ``consensus``: ``pipeline.mutate_many`` on the run's engine:
  regions are corrected in lockstep batches of --region-batch, the next
  batch's loads are prefetched on a thread, and a batch that runs out of
  memory is retried at half its width (width 1 skips the region).  Under
  ``--backend exact`` the same loop runs at width 1 for any --region-batch,
  each region its own failure unit (the JAX CLI's FASTA).
  --shard-index/--num-shards deal the regions round-robin by hand,
  --coordinator/--num-processes/--process-id do it for a multi-process run
  (each process writes OUTPUT.pN), --profile DIR writes a torch.profiler
  Chrome trace (with the port's ``psq.*`` spans, ``obs.py``) and the run's
  counters beside it, --mesh EVxMUT|auto shards each region's events and
  mutation groups over a device mesh (``parallel/mesh.py``).
- ``variant``: ``pipeline.variant`` per region (-f variant sequences,
  -m a mutation file, -a every point mutation); scores go to stdout.
- ``train``: hill-climbs the transition parameters: every iteration's 16
  proposals run as one lockstep batch (``pipeline.train_candidates``) and
  the best goes to ./train_best.conf.  Under ``--backend exact`` the
  proposals run over a pool of -n/--threads processes, as in the JAX CLI
  (spawned: the workers start from a fresh interpreter).
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
import multiprocessing
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import obs, pipeline
from .api import BACKENDS
from .core.params import load_params, save_params, vary_params
from .core.regions import MutationInfo, RegionInfo
from .engine import EngineError, TorchEngine
from .io.fasta import read_fasta
from .io.regions_io import (extract_fasta, merge_fasta, split_fasta,
                            split_regions)
from .parallel.distributed import (allgather_round_robin, finish_multihost,
                                   init_multihost, shard_regions)

OUT_OF_MEMORY = (torch.cuda.OutOfMemoryError, MemoryError)
DEVICE = "cuda"


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
    p.add_argument("--mesh", default=None, metavar="EVxMUT",
                   help="device mesh of each region's events x mutation "
                   "groups (e.g. '8' or '4x2'; 'auto' = every card on the "
                   "event axis): shard k on cuda:N+k for --device cuda:N, "
                   "every shard on the CPU for --device cpu; with too few "
                   "cards the run is single-device")
    _add_multihost(p, "; regions are dealt round-robin across processes "
                   "and each process writes OUTPUT.pN")
    _add_device(p)
    _add_backend(p)
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
    _add_backend(p)
    p.set_defaults(func=variant)

    p = subparsers.add_parser("train", help="train model parameters on data")
    _add_inputs(p)
    p.add_argument("-i", "--iter", type=int, default=30)
    p.add_argument("-n", "--threads", type=int, default=4,
                   help="processes of --backend exact's pool (the torch "
                   "backend runs the proposals as one lockstep batch)")
    p.add_argument("-p", "--params", default=None)
    p.add_argument("-r", "--region", default=None)
    p.add_argument("-d", "--descend", action="store_true", default=False,
                   help="Run consensus by descending from reference")
    _add_multihost(p, "; each process evaluates a round-robin share of "
                   "the proposals")
    _add_device(p)
    _add_backend(p)
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
    if getattr(args, "backend", None) == "exact":
        given = [flag for flag, on in (
            ("--mesh", getattr(args, "mesh", None) is not None),
            ("--device", args.device != DEVICE)) if on]
        if given:
            sys.stderr.write("poreseq-torch: error: --backend exact runs on "
                             "the CPU oracle, which has no device: drop "
                             "{}\n".format(" and ".join(given)))
            raise SystemExit(2)
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
    p.add_argument("--device", default=DEVICE,
                   help="torch device of the engine (cuda, cuda:N or cpu); "
                   "in a multi-process run give each process its own")


def _add_backend(p):
    p.add_argument("--backend", default="torch", choices=BACKENDS,
                   help="compute engine: torch (a TorchEngine on --device) "
                   "or exact (the CPU oracle, bit-faithful to the "
                   "reference, no device)")


def _engine(args):
    """The run's engine: a TorchEngine on --device, or None under --backend
    exact (the pipeline then runs on the shared ExactEngine)."""
    if args.backend == "exact":
        return None
    return TorchEngine(device=args.device)


def resolve_mesh(spec, device: torch.device):
    """The engine mesh for ``--mesh`` (the JAX CLI's meaning): None, '',
    'none', 'off' or '0' -> single device; 'auto' -> every device on the
    'ev' axis; 'A' or 'AxB' -> (ev=A, mut=B).  On a CUDA device shard k is
    cuda:N+k (N the device's index); on the CPU every shard is the CPU,
    which is one device to 'auto'.  With fewer devices than shards, one
    stderr line and a single-device run (None)."""
    from .parallel.mesh import make_mesh

    spec = (spec or "").strip().lower()
    if spec in ("", "0", "none", "off"):
        return None
    cpu = device.type == "cpu"
    base = device.index or 0
    n = 1 if cpu else max(torch.cuda.device_count() - base, 0)
    if spec == "auto":
        if n < 2:
            return None
        n_ev, n_mut = n, 1
    else:
        a, _, b = spec.partition("x")
        n_ev, n_mut = int(a), int(b or 1)
        if not cpu and n_ev * n_mut > n:
            sys.stderr.write("--mesh {} needs {} devices, have {}; running "
                             "single-device\n".format(spec, n_ev * n_mut, n))
            return None
    devices = ([device] * (n_ev * n_mut) if cpu else
               [torch.device("cuda", base + k) for k in range(n_ev * n_mut)])
    return make_mesh(n_ev, n_mut, devices)


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


def _release(engine):
    """Drop a failed batch's device buffers before a smaller retry."""
    gc.collect()
    if engine is not None and engine.device.type == "cuda":
        torch.cuda.empty_cache()


def consensus(args):
    if not args.profile:
        _consensus(args)
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if args.backend == "torch" and torch.device(args.device).type == "cuda":
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
        obs.write_counts(os.path.join(
            args.profile, "poreseq_torch.{}.counts.json".format(os.getpid())))
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

    engine = None
    if args.backend == "torch":
        device = torch.device(args.device)
        engine = TorchEngine(device=device,
                             mesh=resolve_mesh(args.mesh, device))

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
                                  params=args.params, backend=args.backend,
                                  engine=engine)

    # a TorchEngine's batch recovers from running out of memory only; the
    # exact oracle runs width 1, where any failure skips its region (the
    # JAX CLI's width 1)
    recoverable = OUT_OF_MEMORY if engine is not None else Exception

    # one loader thread prefetches the NEXT chunk's BAM/fast5 loads while
    # the device computes the current chunk
    loader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="psq-load")

    def run_chunk(chunk, width, prefetch=False):
        """Lockstep-batch a chunk, halving the batch width when it runs out
        of memory (recoverable at smaller widths); width 1 skips the region
        that still does not fit.  On a TorchEngine any other failure (a
        build, a refused launch, a device fault) propagates."""
        parts = [chunk[at : at + width] for at in range(0, len(chunk), width)]
        fut = None
        for pi, part in enumerate(parts):
            loaded = None
            if prefetch:
                with obs.span("psq.load_wait"):
                    loaded = (fut.result() if fut is not None
                              else load_part(part))
                fut = (loader.submit(load_part, parts[pi + 1])
                       if pi + 1 < len(parts) else None)
            try:
                # the batch's span: every span of its rounds nests in it
                with obs.span("psq.batch"):
                    results = pipeline.mutate_many(
                        args.ref, args.bam, args.dir, part,
                        params=args.params, test=args.test,
                        verbose=args.verbose, reps=args.iterations,
                        backend=args.backend, engine=engine, loaded=loaded)
            except recoverable as e:
                if width == 1:
                    sys.stderr.write("Skipping {}: {}\n".format(part[0], e))
                    continue
                sys.stderr.write(
                    "Batch of {} failed ({}), retrying at {}\n".format(
                        len(part), e, max(width // 2, 1)))
                _release(engine)
                run_chunk(part, max(width // 2, 1))
                continue
            with obs.span("psq.emit"):
                for region, res in zip(part, results):
                    if res is not None:   # None = region skipped during load
                        emit(region, res[0], res[1])

    # under exact the regions run one by one whatever --region-batch says:
    # the sequential FASTA and the sequential libc rand() draws
    width = max(int(args.region_batch or 1), 1) if engine is not None else 1
    try:
        run_chunk(regions, width, prefetch=True)
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
    engine = _engine(args)

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
        if curmuts == [] and not args.all:
            continue
        if nproc > 1 and ri % nproc != pid:
            continue
        try:
            pipeline.variant(args.ref, args.bam, args.dir, args.fasta,
                             curmuts, region, args.params, args.verbose,
                             backend=args.backend, engine=engine)
        except OUT_OF_MEMORY as e:
            sys.stderr.write("Skipping {}: {}\n".format(region, e))
            _release(engine)
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
        _release(engine)
        return (_train_batch(args, cands[:half], engine)
                + _train_batch(args, cands[half:], engine))


class _TrainCandidate:
    """One proposal's consensus on the exact oracle (the JAX CLI's
    trainhelper, cmdline.py:235-244); picklable, for the process pool."""

    def __init__(self, args):
        self.args = args

    def __call__(self, params):
        a = self.args
        return pipeline.mutate(a.ref, a.bam, a.dir, params=params,
                               region=a.region, test=not a.descend,
                               verbose=1, reps=10, backend="exact")


def _train_exact(args, cands):
    """--backend exact: the proposals over a pool of -n processes, as the
    JAX CLI's exact path.  The workers are spawned, so none inherits a CUDA
    context or a thread of this process."""
    run = _TrainCandidate(args)
    if args.threads <= 1:
        return [run(p) for p in cands]
    with multiprocessing.get_context("spawn").Pool(args.threads) as pool:
        return pool.map(run, cands)


def train(args):
    """Hill-climb on consensus accuracy: every iteration proposes 16
    parameter sets and keeps the most accurate (the torch backend runs
    them as one lockstep batch, the JAX CLI's tpu path; the exact backend
    over a process pool)."""
    pid, nproc, store = _join(args)
    engine = _engine(args)

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
        seqs = (_train_exact(args, mine) if engine is None
                else _train_batch(args, mine, engine))
        accs = [s[1] for s in seqs]
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
