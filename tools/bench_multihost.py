#!/usr/bin/env python3
"""1 -> N process efficiency of the port's `consensus --coordinator` (the
counterpart of scripts/bench_multihost.py, which measures the JAX
package's jax.distributed path on CPU processes).

    python3 tools/bench_multihost.py [n_regions] [region_len]
        [--backend torch|exact] [--device cuda] [--processes 2,4]
        [--fake-work S]

The run is the script's: 8 regions of 250 b (tools/bench.py build_run,
seed 0, 3 reads a region of region_len + 60 b), widths 100/50/12, `-i 2`.
Each count N of --processes starts N processes of the port's CLI
(`consensus ... --coordinator 127.0.0.1:PORT --num-processes N
--process-id i`; process 0 hosts the TCPStore, the regions are dealt
round-robin, process i writes OUTPUT.pi), every process on --device (the
one card by default: nothing maps processes to cards), against the same
run in one process.  T1 is the best of two single-process runs;
efficiency_1_to_N = T1 / (N * TN), walls from the processes' start to
the last one's exit.  The shard outputs joined must equal the
one-process output region by region, or the tool exits non-zero.

The kernels (and the host C++ core) are built in this process before any
child starts, so no child compiles.  Each child runs the port's CLI as
`python -m poreseq_tpu_torch.cli` does, after io/npz_h5's
use_where_missing() (a machine without h5py reads the run's fast5 files
through the stand-in that wrote them).  --fake-work S replaces each
region's compute by an S-second sleep (PSQ_FAKE_MUTATE_S, pipeline.py),
which isolates the distributed path from the card and the host's cores.

Prints ONE JSON line: n_regions, region_len, backend, t1_s, t1_runs_s,
tN_s and efficiency_1_to_N for each N, outputs_equal, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import bench as tb  # noqa: E402

WIDTHS = (100, 50, 12)

# one process of the port's CLI; argv: the CLI's arguments
CHILD = ("import sys\n"
         "from poreseq_tpu_torch.io import npz_h5\n"
         "npz_h5.use_where_missing()\n"
         "from poreseq_tpu_torch import cli\n"
         "cli.main(sys.argv[1:])\n")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_regions", type=int, nargs="?", default=8)
    ap.add_argument("region_len", type=int, nargs="?", default=250)
    ap.add_argument("--backend", default="torch", choices=("torch", "exact"))
    ap.add_argument("--device", default="cuda",
                    help="every process's torch device (cuda, cuda:N; cpu "
                    "for tests only)")
    ap.add_argument("--processes", default="2,4",
                    help="process counts N to run against one process")
    ap.add_argument("--fake-work", type=float, default=None, metavar="S",
                    help="replace each region's compute by an S-second "
                    "sleep (PSQ_FAKE_MUTATE_S)")
    args = ap.parse_args(argv)
    args.processes = [int(n) for n in str(args.processes).split(",") if n]
    return args


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_n(base: list, env: dict, out: str, n: int) -> float:
    """One run of n processes (one process: no coordinator); the wall from
    the first start to the last exit.  Raises if a process fails."""
    cmd = [sys.executable, "-c", CHILD] + base + ["-o", out]
    if n > 1:
        port = free_port()
        cmds = [cmd + ["--coordinator", "127.0.0.1:{}".format(port),
                       "--num-processes", str(n), "--process-id", str(i)]
                for i in range(n)]
    else:
        cmds = [cmd]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        errs = [p.communicate(timeout=3600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise RuntimeError("process {} of {} exited {}:\n{}".format(
                i, n, p.returncode, err[-3000:]))
    return wall


def run(args) -> dict:
    """Build the run, time 1 and each N processes, join and compare the
    outputs; the result line."""
    from poreseq_tpu_torch.io.fasta import read_fasta

    card = tb.on_card(args.device, args.backend)
    n_regions, rl = args.n_regions, args.region_len
    d = tempfile.mkdtemp(prefix="psq_mh_")
    try:
        r = tb.build_run(d, n_regions, rl, n_reads=3 * n_regions,
                         read_len=rl + 60, widths=WIDTHS, min_overlap=50)
        if card:
            tb.build_kernels()
        else:
            from poreseq_tpu_torch.engine import _native

            _native.lib()
        base = ["consensus", r["fasta"], r["bam"], r["reads"], "-R",
                r["region_file"], "-p", r["conf"], "-i", "2", "--backend",
                args.backend]
        if args.backend == "torch":
            base += ["--device", args.device]
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        if args.fake_work is not None:
            env["PSQ_FAKE_MUTATE_S"] = str(args.fake_work)

        one = os.path.join(d, "out1.fasta")
        t1_runs = [run_n(base, env, one, 1) for _ in range(2)]
        t1 = min(t1_runs)
        single = read_fasta(one)
        res = dict(n_regions=n_regions, region_len=rl, backend=args.backend,
                   device=args.device if args.backend == "torch" else None,
                   t1_s=t1, t1_runs_s=t1_runs)
        equal = {}
        for n in args.processes:
            out = os.path.join(d, "out{}.fasta".format(n))
            tn = run_n(base, env, out, n)
            joined = {}
            for i in range(n):
                joined.update(read_fasta("{}.p{}".format(out, i)))
            equal[n] = (sorted(joined) == sorted(single) == sorted(
                r["regions"]) and all(joined[k] == single[k]
                                      for k in single))
            res["t{}_s".format(n)] = tn
            res["efficiency_1_to_{}".format(n)] = t1 / (n * tn)
        res["outputs_equal"] = equal
        res.update(tb.card() if card else dict(card=None, power_limit=None))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not all(equal.values()):
        raise SystemExit("bench_multihost: the shards' outputs joined differ "
                         "from the one-process output: {}".format(
                             json.dumps(res)))
    return res


def main(argv=None):
    print(json.dumps(run(parse(argv))), flush=True)


if __name__ == "__main__":
    main()
