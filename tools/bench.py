#!/usr/bin/env python3
"""The port's benchmark: end-to-end consensus throughput on one card, with
the Refine-scale scoring call and the banded fill as secondary metrics
(the counterpart of bench.py at the repo root, which measures the JAX
package).

    python3 tools/bench.py [--budget-s 2200] [--device cuda]

Headline: 1 kb regions per hour at 10X through the port's whole
`consensus` (8 x 1 kb regions, `-i 4 --region-batch 8`, widths
300/100/20, seed 0): the median of up to 5 steady runs after a first run
(the kernels are built before the first run, so it is a warm-up, not the
compiler), with mean accuracy against the truth in a window widened by
400 b on each side (bench.py:82-85).  vs_baseline is regions/hour / 30,
the reference's 2 CPU minutes per 1 kb region.  extra's
regions_per_hour_summed is every steady run's regions over their summed
wall: the rate a stalled run moves, where the median does not.

"extra" also carries bench_refine (every 9-per-base point mutation of a
1 kb region, 20 events, scoring width 20: one ScoreMutations call on a
TorchEngine, closed by a synchronize) and bench_fill (60 events x 1 kb at
width 300: a forward fill with steps plus a backward fill without, CUDA
events over 20 pairs after 2 warm-ups; cells counted as bench.py:169-171
counts them), each beside engine/roofline.py's least time for the same
launches (`*_bound_ms`), the peak device memory of the e2e runs and the
launches of each kernel in one e2e run.

Prints ONE JSON line: metric, value, unit, vs_baseline, extra, device (the
card's name and power limit, as nvidia-smi gives them).  Any failure
exits non-zero with its error on stderr: nothing is retried on the CPU or
through the kernels' plain twins.  `--device cpu` runs the twins, for the
tests at small sizes only.

bench_consensus.py and bench_multihost.py in this directory share
build_run (the simulated run on disk); bench_consensus.py also runs the
CLI through consensus_argv and consensus_once.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONF = ("realign_width = {}\nscoring_width = {}\npoint_width = {}\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = {}\n"
        "max_length = 10000\nlik_offset = 4.5\n")


def build_run(d: str, R: int = 8, L: int = 1000, n_reads: int = 40,
              read_len: int = 1200, draft_error: float = 0.02,
              widths=(300, 100, 20), min_overlap: int = 300) -> dict:
    """A simulated run in d (sim.write_run, seed 0) over R regions of L
    bases, its params file and its region file (bench.py:37-55 at the
    defaults)."""
    from poreseq_tpu_torch.io import npz_h5
    from poreseq_tpu_torch.sim import write_run

    npz_h5.use_where_missing()
    truth, _, reads, bam, fasta = write_run(
        d, np.random.default_rng(0), ref_len=R * L, n_reads=n_reads,
        read_len=read_len, draft_error=draft_error)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write(CONF.format(*widths, min_overlap))
    regions = ["synthref:{}:{}".format(r * L, (r + 1) * L) for r in range(R)]
    rf = os.path.join(d, "regions.txt")
    with open(rf, "w") as f:
        f.write("\n".join(regions) + "\n")
    return dict(dir=d, truth=truth, fasta=fasta, bam=bam, reads=reads,
                conf=conf, regions=regions, region_file=rf)


def accuracies(seqs: dict, truth: str, widen: int = 400) -> list:
    """Each output region's accuracy (%) against the truth: a region
    `name:a:b` is held to truth[a - widen : b + widen] (draft
    coordinates; the widening keeps draft indel drift inside the window)."""
    from poreseq_tpu_torch.api import swalign

    return [swalign(s, truth[max(int(n.split(":")[1]) - widen, 0)
                             : int(n.split(":")[2]) + widen])[0]
            for n, s in seqs.items()]


def card() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in line.split(","))
    return dict(card=name, power_limit=power)


def on_card(device: str, backend: str = "torch") -> bool:
    """Whether the run launches the kernels; raises where it should and
    torch sees no card."""
    import torch

    if backend != "torch" or not str(device).startswith("cuda"):
        return False
    if not torch.cuda.is_available():
        raise SystemExit(f"--device {device}, but torch sees no CUDA card "
                         "(--device cpu runs the plain twins)")
    return True


def build_kernels() -> dict:
    """Build every kernel library (one nvcc per source, all started
    together) and the host C++ core; {source: build seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    import poreseq_tpu_torch.engine.align  # noqa: F401  (defines kernels)
    import poreseq_tpu_torch.engine.mutscore  # noqa: F401
    import poreseq_tpu_torch.engine.viterbi  # noqa: F401
    from poreseq_tpu_torch._build import KERNELS
    from poreseq_tpu_torch.engine import _native

    _native.lib()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda k: k.lib(), KERNELS))
    return {k.src: round(k.build_seconds, 3) for k in KERNELS}


def reset_launches():
    from poreseq_tpu_torch._build import KERNELS

    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    from poreseq_tpu_torch._build import KERNELS

    return {k.name: k.launches for k in KERNELS}


def event_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn in ms: CUDA events around reps calls,
    after two warm-up calls (chip_smoke.py's event_ms)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


@contextlib.contextmanager
def kernel_bounds():
    """Inside the block, sum engine/roofline.py's least time (ms) of every
    fill, backtrace, geometry, windows and group-scorer launch the engine
    makes; yields {"ms": sum, "launches": count}."""
    from types import SimpleNamespace

    from poreseq_tpu_torch.engine import align, fill, mutscore
    from poreseq_tpu_torch.engine import roofline as rl

    out, last = dict(ms=0.0, launches=0), {}

    def fill_b(a, r):
        last["batch"] = a["batch"]
        return (rl.fill_work(a["batch"], a["states"], a["is_pad"], a["W"],
                             a["need_steps"]), a["batch"].mean.dtype)

    def bt_b(a, r):
        return (rl.backtrace_work(r[0], a["best_i"], last["batch"].n0,
                                  a["M"].dtype), a["M"].dtype)

    def win_b(a, r):
        b = last["batch"]
        return (rl.windows_work(SimpleNamespace(mean=a["mean"], n0=b.n0,
                                                active=b.active),
                                a["i0r"], a["Ws"]), a["mean"].dtype)

    hooks = {
        (fill, "fill_cuda"): fill_b,
        (align, "backtrace_cuda"): bt_b,
        (mutscore, "geom_cuda"): lambda a, r: (
            rl.geom_work(a["ral"], a["n0"], a["C"]), a["ral"].dtype),
        (mutscore, "windows_cuda"): win_b,
        (mutscore, "group_totals_cuda"): lambda a, r: (
            rl.group_work(*(v for k, v in a.items() if k != "instance")),
            a["Mf"].dtype),
    }
    real = {k: getattr(*k) for k in hooks}

    def hooked(fn, work):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            r = fn(*a, **kw)
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            w, dt = work(b.arguments, r)
            out["ms"] += rl.bound_ms(*w, dt)[0]
            out["launches"] += 1
            return r
        return wrapped

    for (mod, name), work in hooks.items():
        setattr(mod, name, hooked(real[mod, name], work))
    try:
        yield out
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def consensus_argv(run: dict, out: str, batch: int, backend: str,
                   device: str) -> list:
    """The port CLI's `consensus -i 4 --region-batch batch` on build_run's
    run, writing out."""
    argv = ["consensus", run["fasta"], run["bam"], run["reads"], "-R",
            run["region_file"], "-p", run["conf"], "-o", out, "-i", "4",
            "--backend", backend, "--region-batch", str(batch)]
    return argv + (["--device", device] if backend == "torch" else [])


def consensus_once(argv: list, out: str, card_run: bool,
                   backend: str) -> tuple:
    """One run of the CLI's argv, the launch counts and the card's peak
    memory reset before it; (wall s closed by a synchronize on the card,
    peak device MiB or None)."""
    import torch

    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.engine import _native

    if os.path.exists(out):
        os.unlink(out)
    reset_launches()
    if card_run:
        torch.cuda.reset_peak_memory_stats()
    if backend == "exact":
        # libc rand() (the exact Viterbi's draws) at glibc's first seed, as
        # in a fresh process: every run gives one FASTA
        _native.srand(1)
    t0 = time.perf_counter()
    cli.main(argv)
    sync("cuda" if card_run else "cpu")
    dt = time.perf_counter() - t0
    return dt, (torch.cuda.max_memory_allocated() / 2**20 if card_run
                else None)


def bench_e2e(deadline: float, device: str = "cuda", R: int = 8,
              L: int = 1000, cov: int = 10, backend: str = "torch",
              widths=(300, 100, 20), steady_runs: int = 5,
              workdir: str | None = None) -> dict:
    """Consensus of R regions of L bases at cov X through the port's CLI
    (`-i 4 --region-batch R`): a first run, then steady runs until
    steady_runs or the deadline (time.monotonic(); at least one).  The
    headline regions_per_hour is bench.py's, from the median steady run;
    regions_per_hour_summed is every steady run's regions over their
    summed wall, which a stalled run moves.  workdir: build the run there
    and keep it (its out.fasta is the last run's output)."""
    from poreseq_tpu_torch.io.fasta import read_fasta

    card_run = on_card(device, backend)
    d = workdir or tempfile.mkdtemp(prefix="psq_bench_")
    try:
        run = build_run(d, R, L, n_reads=(cov // 2) * R, read_len=L + 200,
                        widths=widths)
        built = build_kernels() if card_run else {}
        out = os.path.join(d, "out.fasta")
        argv = consensus_argv(run, out, R, backend, device)
        t1, peak = consensus_once(argv, out, card_run, backend)
        peaks, steady = [peak], []
        while len(steady) < steady_runs and (
                not steady or time.monotonic() + min(steady) * 1.2
                < deadline):
            dt, peak = consensus_once(argv, out, card_run, backend)
            steady.append(dt)
            peaks.append(peak)
        ran = launches()
        seqs = read_fasta(out)
        accs = accuracies(seqs, run["truth"])
    finally:
        if workdir is None:
            shutil.rmtree(d, ignore_errors=True)
    med, best = float(np.median(steady)), float(min(steady))
    n_out = len(seqs)
    if n_out != R:
        raise RuntimeError(f"bench_e2e: {n_out} output regions of {R}")
    return {
        "regions_per_hour": 3600.0 * n_out / med,
        "regions_per_hour_summed": 3600.0 * n_out * len(steady) / sum(steady),
        "s_per_region": med / n_out,
        "first_run_s": t1,
        "steady_run_best_s": best,
        "steady_run_median_s": med,
        "s_per_region_best": best / n_out,
        "steady_runs_s": steady,
        "n_regions": n_out,
        "mean_accuracy_pct": float(np.mean(accs)),
        "min_accuracy_pct": float(min(accs)),
        "peak_device_mib": max(peaks) if card_run else None,
        "launches_per_run": ran,
        "build_s": built,
    }


def refine_case(device: str = "cuda", ref_len: int = 1000,
                coverage: int = 20, dtype: str = "float32"):
    """bench.py:102-124's Refine-scale call: seed 3, every 9-per-base
    point mutation of the region at scoring width 20; (engine, data,
    mutations)."""
    import torch

    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.driver import find_point_mutations
    from poreseq_tpu_torch.engine.types import AlignData
    from poreseq_tpu_torch.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(3), ref_len=ref_len,
                             coverage=coverage)
    engine = TorchEngine(device, getattr(torch, dtype))
    data = AlignData.from_session(pa)
    data.params.scoring_width = 20
    return engine, data, find_point_mutations(data)


def bench_refine(device: str = "cuda", ref_len: int = 1000,
                 coverage: int = 20) -> dict:
    """One warm ScoreMutations call, then one timed call closed by a
    synchronize, beside the least time of its kernel launches."""
    card_run = on_card(device)
    engine, data, muts = refine_case(device, ref_len, coverage)
    engine.score_mutations(data, muts)          # build and warm
    sync(device)
    reset_launches()
    with kernel_bounds() as bound:
        t0 = time.perf_counter()
        engine.score_mutations(data, muts)
        sync(device)
        dt = time.perf_counter() - t0
    return {
        "refine_call_s": dt,
        "refine_mut_event_scores_per_s": len(muts) * len(data.events) / dt,
        "refine_n_muts": len(muts),
        "refine_n_events": len(data.events),
        "refine_bound_ms": bound["ms"] if card_run else None,
        "refine_launches": {k: v for k, v in launches().items() if v},
    }


def fill_case(device: str = "cuda", ref_len: int = 1000, coverage: int = 60,
              width: int = 300) -> dict:
    """bench.py:127-171's fill: seed 0, coverage events over a ref_len
    region, the engine's packed operands and fill_geometry's band at
    realign width ``width``; "cells" is bench.py's count (band rows per
    real column, summed over the batch's event rows, x 2 lattices x 2
    directions)."""
    import torch

    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.pack import fill_geometry
    from poreseq_tpu_torch.engine.types import AlignData
    from poreseq_tpu_torch.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(0), ref_len=ref_len,
                             coverage=coverage)
    data = AlignData.from_session(pa)
    engine = TorchEngine(device)
    ctx = engine._prepare_multi([data])
    S = ctx["S_list"][0]
    fi = fill_geometry(ctx["arrays"], ctx["ref_indexes"], ctx["S_e"],
                       ctx["C"], width)
    cells = int(np.sum(np.maximum(
        fi["i1"][:, 1 : S + 1] - fi["i0"][:, 1 : S + 1] + 1, 0)) * 4)
    t = lambda x: torch.as_tensor(x, device=engine.device)
    return dict(batch=ctx["batch"], states=t(ctx["states2"]),
                i0=t(fi["i0"]), i1=t(fi["i1"]), is_pad=t(fi["is_pad"]),
                lik_offset=float(data.params.lik_offset), width=width,
                cells=cells, E=ctx["E"], C=ctx["C"], S=S,
                n_events=len(data.events))


def bench_fill(device: str = "cuda", ref_len: int = 1000, coverage: int = 60,
               width: int = 300) -> dict:
    """A forward fill with steps plus a backward fill without (the main
    path's pair, engine/fill.py's get_fill): CUDA events over 20 pairs
    after 2 warm-ups on the card (a host wall over 2 pairs elsewhere)."""
    from poreseq_tpu_torch.engine import roofline as rl
    from poreseq_tpu_torch.engine.fill import get_fill

    card_run = on_card(device)
    f = fill_case(device, ref_len, coverage, width)
    fwd, bwd = get_fill(width, need_steps=True), get_fill(width, False)
    ops = (f["batch"], f["states"], f["i0"], f["i1"], f["is_pad"],
           f["lik_offset"])

    def pair():
        fwd(*ops, False)
        bwd(*ops, True)

    if card_run:
        reset_launches()
        ms = event_ms(pair)
        fills = launches()["fill"]
    else:
        pair()
        t0 = time.perf_counter()
        pair()
        pair()
        ms, fills = (time.perf_counter() - t0) * 1e3 / 2, 0
    W = 2 * width + 1
    dt = f["batch"].mean.dtype
    bound = sum(rl.bound_ms(*rl.fill_work(f["batch"], f["states"],
                                          f["is_pad"], W, steps), dt)[0]
                for steps in (True, False)) if card_run else None
    cps = f["cells"] / (ms / 1e3)
    print(f"# fill pair {ms:.3f} ms for {f['cells'] / 1e6:.1f}M cells "
          f"({coverage} events x {ref_len} b region, width {width})",
          file=sys.stderr)
    return {"dp_cells_per_s": cps, "dp_vs_1e7_baseline": cps / 1e7,
            "fill_pair_ms": ms, "fill_pair_bound_ms": bound,
            "fill_cells": f["cells"], "fill_launches": fills}


def _rounded(d: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget-s", type=float, default=2200.0,
                    help="deadline of the e2e steady runs, from the start")
    ap.add_argument("--device", default="cuda",
                    help="the engine's torch device (cuda, cuda:N; cpu for "
                    "tests only)")
    args = ap.parse_args(argv)
    deadline = time.monotonic() + args.budget_s
    e2e = bench_e2e(deadline, args.device)
    extra = dict(e2e)
    extra.update(bench_refine(args.device))
    extra.update(bench_fill(args.device))
    print(json.dumps({
        "metric": "kb_regions_per_hour_10x_e2e",
        "value": round(e2e["regions_per_hour"], 2),
        "unit": "regions/hr",
        # reference: about 2 min per 1 kb region = 30 regions/hr
        "vs_baseline": round(e2e["regions_per_hour"] / 30.0, 2),
        "extra": _rounded(extra),
        "device": card() if on_card(args.device) else None,
    }), flush=True)


if __name__ == "__main__":
    main()
