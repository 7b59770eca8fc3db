#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR] [--f32-regions N]

Phases (each prints one line of what it measured; any failure exits
non-zero, nothing runs on the CPU instead):
  1. build    — nvcc builds the kernels of poreseq_tpu_torch/csrc/ for sm_90a
                (one process per source, together) and ptxas reports each
                kernel instance's registers and spills;
  2. kernels  — each kernel against its plain PyTorch twin on the card at
                main-path shapes (fill width 300, scoring width 100,
                Refine point width 20): the fill (forward with steps,
                backward with and without) at realign widths 300, 400, 100
                and 20 (W = 601, 801, 201, 41: W = 801 runs the fill's
                block without a spare warp) and the backtrace on a
                simulated 1 kb region at 10X, the group scorer on every
                group of an 8-region lockstep batch, the Viterbi sweep
                (with and without backpointers), the sampler (16
                candidates) and its Gumbel kernel on that batch's 8
                regions (the Gumbel kernel also at the edges of its grid
                and row-key passes, GUMBEL_SHAPES), the Viterbi
                observations on those regions' rows,
                the per-base likes, the scoring geometry and its windows on
                the 8-region batch of a Mutate round (scoring width 100), in
                f64 (equal to the twin) and f32 (the production type; every
                kernel but the fill and the group scorer equal too; the
                fill's running best equal to dp.finish_fill on the kernel's
                own column maxima), with each kernel's device time (CUDA
                events), its least time on the card (engine/roofline.py)
                and the twin's time; then the wide instances: the fill at
                realign widths 700 and 2047 (W = 1401 and 4095: two and
                four band rows a thread; forward with steps, backward
                without) within the same tolerances, the group scorer on
                a Mutate call's groups at scoring width 600 (Ws = 1201),
                equal; past the register-held scan, on a 240 b
                region at 8X, the fill at realign widths 2048 and 4096 (W =
                4097 and 8193) on 8 event rows in both of its instances
                there (the cluster instance, 5 and 9 CTAs an event in a
                thread-block cluster, and the wide one, its column in
                shared memory or a device scratch), the group scorer at
                scoring widths 2048 and 4096 (Ws = 4097 and 8193) on 60
                mutations' groups in both of its instances there (the
                cluster instance, 2 and 4 CTAs a pair and an extra row, and
                the wide one; equal to each other bit for bit), and the
                geometry's cluster and memory instances at 256 levels past
                its staged cap and twice it, and the memory one past the
                cluster's capacity, equal; each timed in f32 (event and
                queued ms) under the kernel's "wide" key, the fill's,
                scorer's and geometry's two instances in turns (the fill
                at 8 and at 128 event rows, the 8 repeated; timed only);
                and the
                observations past the tiled instance's cap of 32 events at
                E = 60, 64, 65, 100, 257, 1024 and 8193 (OBS_SHAPES: rows
                of every, some, 2, 1 and 0 valid events, ties, a stdv of
                0, trims past 8 dropped events) on the instance obs_path
                routes each to (tiled64 up to 64, chunked past it), equal
                in f64 and f32 and timed in f32 under the kernel's
                "shapes" key (printed beside the earlier general path's
                time, OBS_GENERAL_MS);
  2b. viterbi — the sampler's threefry2x32 on the card gives JAX's row keys
                and 32- and 64-bit words (PINNED_KEYS, PINNED_WORDS,
                computed with JAX) bit for bit, the twin's uniforms on the
                card equal the CPU's, and in f64 each of the 8 regions of
                phase 2's batch gets the same candidates inside the batch
                as alone (f32: the count that do is printed), through the
                observation, sweep, Gumbel and sampler kernels;
  3. e2e      — the port's CLI `consensus --region-batch 8 --device cuda` on a
                synthetic run (8 x 1 kb regions at 10X, widths 300/100/20,
                -i 4), checking the output count, the mean accuracy against
                the truth and that every kernel of the path was launched,
                with the calls and summed host walls of each TorchEngine
                method the pipeline reaches
                (with --profile DIR, under torch.profiler: the trace goes to
                DIR and its summary, device time and launches per kernel
                and the device-busy share, is printed);
  3c. coverage — phase 3's run at 30X (COVERAGE: 3x the reads, so that the
                loader's max_coverage = 30 reads, two event rows each, caps
                most regions and every Viterbi batch passes 32 event rows),
                the same CLI call, f32: wall, mean and min accuracy (>= 99.0
                %), E_pad of every Viterbi call (the first past 32), the
                observation launches by instance (every call past 32 events
                on tiled64 or chunked), engine host seconds and peak device
                memory; its largest observation launch held to the twin bit
                for bit and timed (event and queued ms) beside its bound,
                the twin's and the earlier general path's time;
  4. variant  — `variant -m/-a/-f` on a 5 kb run with 10 planted
                substitutions: reverting mutations score > 0 and corrupting
                ones < 0, -a prints one line per point mutation of a 1 kb
                region, -f prints nothing (as the JAX CLI: a region with
                no mutations is skipped unless -a is given), and through
                pipeline.variant on the card the truth outscores a 5
                %-mutated copy;
  5. train    — `train -i 1` on a 1 kb region at 10X: 16 candidates of 10
                reps, train_best.conf written, best accuracy >= 98 %;
                phases 4 and 5 also hold the largest forward fill, backward
                fill and group-scorer launch of their own run to the twins
                (phase 2's tolerances), train's fill carrying 16 candidates'
                transition operands;
  6. multihost — two processes on the card run `consensus --coordinator`
                over 4 regions; each OUTPUT.pN equals, byte for byte, a
                single-process run of its regions (--shard-index);
  7. mesh     — phase 3's run through pipeline.mutate_many (the function
                the CLI's consensus calls) on an engine whose ev x mut mesh
                is 2x2 of the one card (cuda:0 four times): every shard
                launches the fill, the backtrace and the group scorer, mean
                accuracy >= 99.0 %, and the count of regions whose sequence
                differs from phase 3's is printed (the mesh takes the host's
                scoring geometry in f32, phase 3 the device's), with the
                wall, launches and peak device memory beside phase 3's;
                then one Refine call (phase 2's 8 regions) on the mesh
                equals the single-device call's totals bit for bit, f64 and
                f32, on the same (host) geometry;
  8. f32_equiv — scripts/f32_equiv.py's protocol at production widths
                (300/100/20) on --f32-regions 1 kb regions (default 6;
                cut from the script's own 10 for time; region i: seed
                1000 + 37 i,
                coverage 8/10/12 and draft error 0.02/0.03/0.05 cycling
                with i): the port's exact engine (on the CPU, a spawned
                pool of a process per region, at most one per core) and
                TorchEngine f32 and f64 on the card each run Mutate(reps=2)
                on the reads, Mutate(reps=2) on the exact engine's Viterbi
                candidates (libc rand() seeded with the region's seed) and
                Refine; per card engine, the regions whose sequence first
                differs from the exact engine's after each step, and the
                degraded ones (accuracy there 0.5 points or more from the
                exact engine's, or below 99 %), which fail the run;
  9. wide     — phase 3's consensus at widths 700/600/20 from its params
                file (W = 1401, Ws = 1201): wall, mean accuracy (>= 99.0 %),
                launches and peak device memory beside phase 3's, every
                kernel of the path launched, and the largest forward and
                backward fill and the largest group-scorer launch of each
                window width (Refine's 41, Mutate's 1201) held to their
                twins (phase 2's tolerances) and timed; then phase 3's
                first polished region alone (its second: the first has 2
                reads, under the pipeline's 5; cut: 1 of 8) at 2048/2048/20
                (W = Ws = 4097), -i 4 --region-batch 1: the fill's cluster
                instance and the scorer's routed one (group_instance: the
                cluster instance) launched (counted and printed by
                instance),
                accuracy no more than 0.5 points below the region's in
                phase 3, its largest fills (8 event rows) and Ws = 4097
                scorer launch (its first 2048 groups) held to the twins and
                timed;
 10. genome   — the genome-scale path through tools/genome_run.py's
                functions (write_run, the CLI's split, consensus per shard,
                merge), widths 300/100/20, -i 4 --region-batch 8: 10a
                lambda-2kb, the JAX README's lambda configuration (48.5 kb
                at 10X, 8 kb reads over 2 kb regions) cut to its first 10
                regions, dealt over 2 shards: one merged contig at >= 99.0 %
                over the covered span, trimmed events (batch T below the
                reads' levels) and every kernel launched; 10b long-10kb, the
                lambda genome split at 10 kb (6 regions, 10.4 kb reads),
                its first 4 (cut for time) in one lockstep batch on
                TorchEngine f32 (the CLI) and its first 2 regions on f64
                (pipeline.mutate_many, in a process
                of its own while the f32 run's launches are held to their
                twins; cut for time): each merged at >= 99.0 %, no region
                degraded in f32
                (0.5 points or more below f64, or below 99 %), the largest forward and backward fill held to the
                twins on 8 event rows and the largest group-scorer launch on
                its first 2048 groups (phase 2's tolerances), and every
                kernel's largest launch timed beside its bound;
 11. bench    — the tools' functions: tools/bench.py's bench_e2e (bench.py's
                run: 8 x 1 kb at 10X, -i 4 --region-batch 8, widths
                300/100/20; a first run and 2 steady runs, cut from 5:
                accuracy >= 99.0 %, every kernel launched in a run),
                bench_refine and bench_fill (each beside its bound),
                tools/bench_multihost.py at 2 processes on the card (cut:
                no 4; the shards joined equal one process's output),
                tools/bench_consensus.py at --batch 1, one repeat, against
                bench_e2e's batch of 8 on the same run (>= 99.0 %; cut:
                bench_e2e stands for --batch 8), and tools/dryrun.py's entry
                and dryrun_multichip(4) at ref_len 1500 on a 2x2 mesh of
                cuda:0 (equal to one device on the host geometry, every
                shard launching the fill, backtrace and scorer); one JSON
                line each.
Phase 2 also holds the fill, backtrace and group scorer on cuda:1 in f64
when torch sees a second card.  Phases 2b-11 reset the kernels' launch
counters before they start and report them after; each must have launched
the kernels of its path (phases 3, 3c and 11's bench_e2e run: every kernel;
phases 7 and 10b's f64 run: all but the geometry, which a mesh and f64
take from the host).  The line
before the last is a JSON object with one entry per kernel (with each
kernel's largest 10b launch timed, "genome_largest"); the last line is
{"ok": true, "device": {...}}.
Kernel times are CUDA-event times of 20 launches after two warm-up
launches, over 20; the twins' and the phases' are host walls closed by a
synchronize.  For the geometry and the Gumbel noise the kernels line also
gives queued_ms: the same 20 launches queued behind a spin kernel, so they
run back to back on the card where the wrapper's host time per call
exceeds the kernel's (event times then read the host's pace).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import io
import json
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from tools.bench import event_ms

P_WIDTHS = dict(realign_width=300, scoring_width=100, point_width=20)
E2E_REGIONS = 8
# the coverage phase's: phase 3's run with 3x the reads, so that the
# loader's cap (max_coverage = 30 reads) holds most regions
COVERAGE = 30


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn in ms: CUDA events around reps calls,
    after two warm-up calls, queued behind a spin kernel that keeps the card
    busy for twice the host's time to enqueue them, so that the calls run
    back to back on the card even where fn's host time exceeds its
    kernel's (a copy of tools/profile_phase3.py:queued_ms)."""
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


def timed(ms: float, work, dtype) -> dict:
    """A kernel's time beside its least time on the card for the same work
    ((bytes, operations[, integer operations]) from engine/roofline.py)."""
    from poreseq_tpu_torch.engine.roofline import bound_ms

    b_ms, by = bound_ms(*work[:2], dtype, *work[2:])
    return dict(ms=ms, bound_ms=b_ms, bound_by=by, share=b_ms / ms)


def _timing(d: dict) -> str:
    return (f"{d['ms']:.3f} ms (bound {d['bound_ms']:.4f} ms by "
            f"{d['bound_by']}, share {d['share']:.4f})")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median wall time of fn() in ms, each run closed by a synchronize,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def ptxas_usage(log: str) -> list[str]:
    """'kernel instance: registers, spill stores' lines from what nvcc
    -Xptxas -v printed while building one csrc/ source (instances by their
    mangled names: I<f|d> then the template flags Lb0/Lb1 in order)."""
    import re

    out, name, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "Used" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill} bytes spilled")
            name, spill = None, "?"
    return out


def phase_build():
    """Build the kernels, one nvcc per source, all started together; print
    each kernel instance's registers and spills as ptxas reports them."""
    from concurrent.futures import ThreadPoolExecutor

    kernels = list(_kernels())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.lib(), kernels))
    secs = {k.src: round(k.build_seconds, 3) for k in kernels}
    print(f"[build] nvcc sm_90a: {secs} wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k in {k.src: k for k in kernels}.values():
        for line in ptxas_usage(k.build_log):
            print(f"[build] ptxas {k.src} {line}", flush=True)
    print(gpu_line(), flush=True)
    return kernels


def _session(seed: int, realign: int = P_WIDTHS["realign_width"],
             ref_len: int = 1000, coverage: int = 10, **widths):
    """A simulated 1 kb region at 10X with a 2% draft error (ref_len,
    coverage and other widths: phase 2's wide holds past the register-held
    scan)."""
    from poreseq_tpu_torch.engine.types import AlignData
    from poreseq_tpu_torch.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=ref_len,
                             coverage=coverage, draft_error=0.02)
    pa.params.update(P_WIDTHS, realign_width=realign, **widths)
    return AlignData.from_session(pa)


def _fill_inputs(engine, data):
    """The fill operands score_alignments_multi builds for one region."""
    import torch

    from poreseq_tpu_torch.engine.pack import fill_geometry

    ctx = engine._prepare_multi([data])
    fi = fill_geometry(ctx["arrays"], ctx["ref_indexes"], ctx["S_e"],
                       ctx["C"], data.params.realign_width)
    t = lambda x: torch.as_tensor(x, device=engine.device)
    return (ctx["batch"], t(ctx["states2"]), t(fi["i0"]), t(fi["i1"]),
            t(fi["is_pad"]), float(data.params.lik_offset))


FILL_OUTPUTS = ("M", "S", "steps_m", "steps_s", "cmax", "carg")


def _tolerance(f64: bool):
    """(rtol, atol): f64 must equal the twin."""
    return (0.0, 0.0) if f64 else (2e-5, 2e-4)


def hold_fill(args, where: str, timing: dict | None = None,
              instance: str | None = None, cache: dict | None = None) -> float:
    """One fill launch (fill_cuda's arguments; instance: the one named, else
    the route's) against its plain twin on the same operands: M, S and
    cmax equal (f64) or within the tolerance (f32), step bytes equal (f64)
    or >= 99.95 % equal (f32), first argmaxes and best coordinates equal;
    the kernel's running best (best_pfx, best, best_i, best_j) equal to
    dp.finish_fill on its own cmax and carg.  Returns the max |diff|;
    timing: gets the twin's wall (ms, one call closed by a synchronize)
    under "plain_ms"; cache: keeps the twin's outputs under "ref", and an
    earlier hold's there stand in for a twin call on the same operands."""
    import torch

    from poreseq_tpu_torch.engine.dp import fill_reference, finish_fill
    from poreseq_tpu_torch.engine.fill import fill_cuda

    args = args[:9]     # a kept launch's bound arguments end in instance
    batch, states, i0, i1, pad, off, backward, W, need_steps = args
    f64 = batch.mean.dtype == torch.float64
    rtol, atol = _tolerance(f64)
    got = fill_cuda(*args, instance=instance)
    torch.cuda.synchronize()
    ref = None if cache is None else cache.get("ref")
    if ref is None:
        t0 = time.perf_counter()
        ref = fill_reference(*args)
        torch.cuda.synchronize()
        if timing is not None:
            timing["plain_ms"] = (time.perf_counter() - t0) * 1e3
        if cache is not None:
            cache["ref"] = ref
    own = finish_fill(*got[:6], i0, i1, backward)
    torch.cuda.synchronize()
    what = (f"{where} fill{f' ({instance})' if instance else ''} "
            f"(f64={f64}, backward={backward})")
    err = 0.0
    for n, a, b in zip(FILL_OUTPUTS, got, ref):
        if a.shape != b.shape:
            fail(f"{what}: {n} shape {tuple(a.shape)} != {tuple(b.shape)}")
        if n.startswith("steps"):
            agree = (a == b).double().mean().item() if a.numel() else 1.0
            if (f64 and agree < 1.0) or agree < 0.9995:
                fail(f"{what}: {n} agreement {agree}")
        elif n == "carg":
            if not torch.equal(a, b):
                fail(f"{what}: carg differs")
        else:
            d = (a - b).abs()
            if not bool((d <= atol + rtol * b.abs()).all()):
                fail(f"{what}: {n} max |diff| {d.max().item()}")
            err = max(err, d.max().item())
    for n, k in zip(("best_pfx", "best", "best_i", "best_j"), got[6:]):
        if not torch.equal(k, getattr(own, n)):
            fail(f"{what}: the kernel's {n} differs from finish_fill on its "
                 "own column maxima")
    rr = finish_fill(*ref, i0, i1, backward)
    if not (torch.equal(own.best_i, rr.best_i)
            and torch.equal(own.best_j, rr.best_j)):
        fail(f"{what}: best_i/best_j differ")
    return err


# realign widths: W = 601 (timed), 801 (the block without a spare warp,
# W > 608), 201, 41
FILL_WIDTHS = (300, 400, 100, 20)


# the fills held at each width: (backward, need_steps)
FILL_RUNS = {"forward": (False, True), "backward": (True, False),
             "backward, steps": (True, True)}
# spawned processes that hold phase 2's fills beside the f64 checks (each
# fill's twin walks its columns on one host core)
FILL_WORKERS = 4


def fill_width_holds(seed: int, width: int, f64: bool) -> dict:
    """Phase 2's fills at one realign width (FILL_RUNS) held to the twin on
    a TorchEngine of their own, for a spawned process: {"err": max |diff|,
    "E", "C"}."""
    import torch

    from poreseq_tpu_torch.engine import TorchEngine

    engine = TorchEngine("cuda", torch.float64 if f64 else torch.float32)
    batch, states, i0, i1, pad, off = _fill_inputs(engine,
                                                   _session(seed, width))
    W = 2 * width + 1
    err = max(hold_fill((batch, states, i0, i1, pad, off, backward, W,
                         steps), f"kernels W={W}")
              for backward, steps in FILL_RUNS.values())
    return dict(err=err, E=batch.mean.shape[0], C=states.shape[0])


def check_fill(engine, seed: int, f64: bool, report: dict,
               held: dict | None = None):
    """The fill at every realign width of FILL_WIDTHS: FILL_RUNS held to
    the twin (held: {(width, f64): fill_width_holds' result} where the
    holds ran in a pool); at width 300 in f32 the forward and the backward
    fill held here and timed (the twin's time: its wall in the hold)."""
    from poreseq_tpu_torch.engine.fill import fill_cuda
    from poreseq_tpu_torch.engine.roofline import fill_work

    rtol, atol = _tolerance(f64)
    err, line = 0.0, {}
    for width in FILL_WIDTHS:
        W = 2 * width + 1
        timed_here = not f64 and width == FILL_WIDTHS[0]
        if held is not None:
            r = held[width, f64]
            err, E, C = max(err, r["err"]), r["E"], r["C"]
        if held is None or timed_here:
            batch, states, i0, i1, pad, off = _fill_inputs(
                engine, _session(seed, width))
            E, C = batch.mean.shape[0], states.shape[0]
        for name, (backward, steps) in FILL_RUNS.items():
            if held is not None and not (timed_here
                                         and name != "backward, steps"):
                continue
            args = (batch, states, i0, i1, pad, off, backward, W, steps)
            twin = {}
            err = max(err, hold_fill(args, f"kernels W={W}", twin))
            if timed_here and name != "backward, steps":
                line[name] = dict(timed(event_ms(lambda: fill_cuda(*args)),
                                        fill_work(batch, states, pad, W,
                                                  steps),
                                        batch.mean.dtype), **twin)
        print(f"[kernels] fill f{'64' if f64 else '32'} E={E} C={C} W={W}: "
              f"forward with steps, backward with "
              f"and without held to the twin, max |diff| so far {err:.3e} "
              f"(rtol {rtol}, atol {atol}); steps/best equal; the kernel's "
              f"best_pfx/best/best_i/best_j equal finish_fill on its own "
              f"cmax/carg", flush=True)
    if not f64:
        print(f"[kernels] fill f32 W={2 * FILL_WIDTHS[0] + 1}: forward "
              f"{_timing(line['forward'])}"
              f", twin {line['forward']['plain_ms']:.1f} ms; backward "
              f"{_timing(line['backward'])}, twin "
              f"{line['backward']['plain_ms']:.1f} ms | {gpu_line()}",
              flush=True)
        line = dict(line["forward"], backward=line["backward"])
    # the wide instances' holds may have come first (phase_kernels)
    err = max(err, report.get(("fill", f64), {}).get("max_abs_err", 0.0))
    report[("fill", f64)] = dict(line, max_abs_err=err)


def check_backtrace(engine, data, f64: bool, report: dict):
    import torch

    from poreseq_tpu_torch.engine.align import (backtrace_cuda,
                                                backtrace_reference)
    from poreseq_tpu_torch.engine.fill import get_fill

    batch, states, i0, i1, pad, off = _fill_inputs(engine, data)
    r = get_fill(data.params.realign_width)(batch, states, i0, i1, pad, off,
                                            False)
    T = batch.mean.shape[1]
    args = (r.M, r.S, r.steps_m, r.steps_s, r.i0, r.i1, r.best_i, r.best_j,
            T, int(states.shape[0] + 2 * T + 8))
    ral_k, rlk_k = backtrace_cuda(*args)
    ral_r, rlk_r = backtrace_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(ral_k, ral_r):
        fail(f"backtrace ref_align differs (f64={f64})")
    d = (rlk_k - rlk_r).abs()
    if not torch.equal(rlk_k, rlk_r):
        fail(f"backtrace ref_like max |diff| {d.max().item()} (f64={f64})")
    line = dict(max_abs_err=d.max().item())
    if not f64:
        from poreseq_tpu_torch.engine.roofline import backtrace_work

        line.update(timed(event_ms(lambda: backtrace_cuda(*args)),
                          backtrace_work(ral_k, r.best_i, batch.n0,
                                         batch.mean.dtype),
                          batch.mean.dtype))
        line["plain_ms"] = cuda_ms(lambda: backtrace_reference(*args),
                                   reps=2)
    report[("backtrace", f64)] = line
    print(f"[kernels] backtrace f{'64' if f64 else '32'} E={r.M.shape[1]} "
          f"(walked {int((r.best_i > 0).sum())}) C={r.M.shape[0]} T={T}: "
          f"ref_align and ref_like equal"
          + (f"; kernel {_timing(line)}, twin {line['plain_ms']:.1f} ms"
             if not f64 else ""), flush=True)


# per-region coverage of the group scorer's 8-region batch: mean 12X, 96
# event rows in all, so the batch fills its event bucket exactly and the
# last region's row slice (fewer rows than the largest region's) overruns
# it and is clamped to E - E_g, as jax.lax.dynamic_slice_in_dim clamps
MUT_COVERAGE = (11, 13, 12, 14, 10, 12, 13, 11)
# the twin's joins hold [G, P, E_g, W] temporaries: 512 groups a call at
# W <= 601, proportionally fewer at wider bands or windows
TWIN_GROUPS = 512


def _mut_regions(seed: int, widths: dict = P_WIDTHS):
    """The group scorer's inputs at main-path shapes: 8 simulated 1 kb
    regions in one lockstep batch, each as a Refine call sees it (point
    width 20, every point mutation) and as a Mutate round sees it (scoring
    width 100, 300 random indels and substitutions); `widths` replaces the
    main path's (phase 2's wide holds: WIDE_WIDTHS)."""
    from poreseq_tpu_torch.engine.driver import find_point_mutations
    from poreseq_tpu_torch.engine.types import AlignData
    from poreseq_tpu_torch.sim import simulate_session

    rng = np.random.default_rng(seed + 1)
    refine, mutate = ([], []), ([], [])
    for r, cov in enumerate(MUT_COVERAGE):
        pa, _ = simulate_session(np.random.default_rng(seed + 100 + r),
                                 ref_len=1000, coverage=cov,
                                 draft_error=0.02)
        pa.params.update(widths)
        data = AlignData.from_session(pa)
        data.params.scoring_width = widths["point_width"]
        refine[0].append(data)
        refine[1].append(find_point_mutations(data))
        data = AlignData.from_session(pa)
        mutate[0].append(data)
        mutate[1].append(_random_mutations(data.sequence, rng, 300))
    return dict(refine=refine, mutate=mutate)


def _random_mutations(seq: str, rng, n: int) -> list:
    """n random substitutions, insertions and deletions of 1-3 bases on
    seq, drawn from rng."""
    from poreseq_tpu_torch.core.regions import MutationInfo

    muts = []
    for _ in range(n):
        st = int(rng.integers(0, len(seq) - 6))
        kind = int(rng.integers(0, 3))
        m = MutationInfo()
        m.start = st
        if kind == 0:
            m.orig, m.mut = seq[st], "ACGT"[int(rng.integers(0, 4))]
        elif kind == 1:
            m.orig, m.mut = "", "ACGT"[int(rng.integers(0, 4))]
        else:
            m.orig, m.mut = seq[st : st + int(rng.integers(1, 4))], ""
        muts.append(m)
    return muts


def _twin_totals(args):
    """The group scorer's plain twin over every group, TWIN_GROUPS at a
    time (fewer past W = 601: groups are independent in the twin, so the
    totals do not depend on the split): totals [G, P]."""
    import torch

    from poreseq_tpu_torch.engine.mutscore import (group_deltas_reference,
                                                   sum_rows_reference)

    gp = args[13]
    G = gp["g_start"].shape[0]
    step = max(1, TWIN_GROUPS * 601 // max(args[15], args[16], 601))
    out = []
    for at in range(0, G, step):
        sub = {k: v[at : at + step] for k, v in gp.items()}
        out.append(sum_rows_reference(group_deltas_reference(
            *args[:13], sub, *args[14:])))
    return torch.cat(out)


def hold_mutscore(args, where: str, timing: dict | None = None,
                  instance: str | None = None,
                  cache: dict | None = None) -> float:
    """One group-scorer launch (group_totals_cuda's arguments; instance: the
    one named, else the route's) against its plain twin on every group:
    totals equal (f64) or within 3e-3 + 2e-4 |x| (f32), and no accept-sign
    flip.  Returns the max |diff|; timing: gets the twin's wall (ms, one
    call closed by a synchronize) under "plain_ms"; cache: keeps the twin's
    totals and the first held instance's deltas, and a later instance's
    deltas and totals must equal those bit for bit."""
    import torch

    from poreseq_tpu_torch.engine.mutscore import group_totals_cuda

    f64 = args[1].dtype == torch.float64
    what = (f"{where} mutscore{f' ({instance})' if instance else ''} "
            f"K={args[18]} D={args[20]} (f64={f64})")
    tot_k, d_k = group_totals_cuda(*args, instance=instance)
    torch.cuda.synchronize()
    cache = {} if cache is None else cache
    if "deltas" in cache:
        if not (torch.equal(d_k, cache["deltas"][1])
                and torch.equal(tot_k, cache["totals"])):
            fail(f"{what}: deltas differ from the {cache['deltas'][0]} "
                 "instance's " + _differs("deltas", d_k, cache["deltas"][1]))
    else:
        cache.update(deltas=(instance, d_k), totals=tot_k)
    tot_r = cache.get("twin")
    if tot_r is None:
        t0 = time.perf_counter()
        tot_r = cache["twin"] = _twin_totals(args)
        torch.cuda.synchronize()
        if timing is not None:
            timing["plain_ms"] = (time.perf_counter() - t0) * 1e3
    d = (tot_k - tot_r).abs()
    bound = 0.0 if f64 else 3e-3 + 2e-4 * tot_r.abs()
    if not bool((d <= bound).all()):
        fail(f"{what}: max |diff| {d.max().item()}")
    valid = args[13]["s_valid"].bool()
    flips = ((tot_k - 1e-6 > 0) != (tot_r - 1e-6 > 0)) & valid
    if bool(flips.any()):
        fail(f"{what}: {int(flips.sum())} accept-sign flips")
    return d.max().item()


def check_mutscore(engine, calls, f64: bool, report: dict):
    """Group scorer (one launch per (K, D) class over all groups of the
    8-region batch, as the main path launches it) against its twin on every
    group; in f32 each call's launches timed (the Refine call is the
    kernel's line, the Mutate call beside it)."""
    from poreseq_tpu_torch.engine.mutscore import (group_launches,
                                                   group_totals_cuda)
    from poreseq_tpu_torch.engine.roofline import group_work

    err, n_groups, clamped, calls_t = 0.0, {}, 0, {}
    for name, (datas, mlists) in calls.items():
        n_groups[name] = 0
        ms = plain_ms = nbytes = ops = 0.0
        for gp, _, args in group_launches(engine, datas, mlists,
                                          [True] * len(datas)):
            E, E_g, G = args[1].shape[1], args[21], gp["G"]
            clamped += int((gp["g_evoff"][:G] > E - E_g).sum())
            n_groups[name] += G
            err = max(err, hold_mutscore(args, f"kernels {name}"))
            if not f64:
                ms += event_ms(lambda: group_totals_cuda(*args))
                plain_ms += cuda_ms(lambda: _twin_totals(args), reps=2)
                b, o = group_work(*args)
                nbytes, ops = nbytes + b, ops + o
        if not f64:
            calls_t[name] = dict(timed(ms, (nbytes, ops), args[1].dtype),
                                 plain_ms=plain_ms)
    if not clamped:
        fail("mutscore: no group's event slice was clamped to E - E_g")
    line = dict(max_abs_err=err)
    if not f64:
        line.update(calls_t["refine"], mutate_call=calls_t["mutate"])
    report[("mutscore", f64)] = line
    print(f"[kernels] mutscore f{'64' if f64 else '32'}: "
          f"{len(MUT_COVERAGE)} regions, groups {n_groups} "
          f"({clamped} with a clamped event slice), every group held to the "
          f"twin: totals max |diff| {err:.3e}, 0 accept-sign flips"
          + (f"; Refine call (Ws={2 * P_WIDTHS['point_width'] + 1}) "
             f"{_timing(line)}, twin {line['plain_ms']:.1f} ms; Mutate call "
             f"(Ws={2 * P_WIDTHS['scoring_width'] + 1}) "
             f"{_timing(calls_t['mutate'])}, twin "
             f"{calls_t['mutate']['plain_ms']:.1f} ms | {gpu_line()}"
             if not f64 else ""), flush=True)


def gumbel_shapes() -> dict:
    """{name: (nk, R)} of the Gumbel kernel's edges, as
    tests/test_torch_kernels_cuda.py's GUMBEL_SHAPES has them: G rows a grid
    pass (132 SM_BLOCKS blocks of NT / 256 rows, constants read from
    csrc/viterbi_gumbel.cu), 32 G rows a pass of row keys (a warp derives
    the keys of its next 32 rows at once)."""
    import re

    from poreseq_tpu_torch import _build

    text = (_build.CSRC / "viterbi_gumbel.cu").read_text()
    nt, sm_blocks = (int(re.search(rf"constexpr int {n} = (\d+);",
                                   text).group(1))
                     for n in ("NT", "SM_BLOCKS"))
    G = 132 * sm_blocks * (nt // 256)
    return {"one row": (1, 1), "one candidate": (1, 700),
            "one row each": (16, 1), "below the grid": (16, 40),
            "the grid": (4, G // 4), "above the grid": (3, G // 2 + 1),
            "a key pass": (16, 2 * G),
            "above a key pass": (5, 32 * G // 5 + 1)}


VITERBI_ARGS = (0.05, 0.01)                    # skip_prob, stay_prob
SAMPLE_ARGS = (16, 0.33, 0.75)                  # nkeep, mut_min, max


def _differs(name: str, a, b) -> str:
    """How two tensors that should be equal differ."""
    line = f"{name}: {int((a != b).sum())} of {a.numel()} differ"
    if a.is_floating_point():
        line += f", max |diff| {(a - b).abs().max().item()}"
    return line


# the one-block designs' times at phase 2b's shape, f32 (PERF.md §6, the
# proof run on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
ONE_BLOCK_MS = {"viterbi_sweep": 2.005, "viterbi_sample": 3.680}
# the earlier designs at this phase's shapes, f32, by event_ms (PERF.md
# §6; NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's: the
# observations (a block a row, the tables read for every row, trimmed rows'
# emissions computed twice), the likes (a warp an event walking its
# levels), the Gumbel noise (PR 10's row layout on a counter hash, before
# JAX's threefry2x32) and the geometry (serial walks over the threads'
# summaries)
EARLIER_MS = {"viterbi_obs": (0.424, "a block a row"),
              "likes": (0.027, "a warp an event"),
              "viterbi_gumbel": (0.0460, "the counter hash"),
              "geom": (0.036, "serial summary walks")}
# the kernels whose line also gives queued_ms: short launches whose
# wrapper's host time may exceed the kernel's, so event_ms reads the host
QUEUED = ("viterbi_gumbel", "geom")


def _earlier(name: str) -> str:
    ms, design = EARLIER_MS[name]
    return f"{design}: {ms} ms"


def check_viterbi(engine, events, seed: int, f64: bool, report: dict):
    """The observations, the sweep (with and without backpointers), the
    sampler (16 candidates, its Gumbel launch included) and the Gumbel
    kernel alone on the 8 regions of the group scorer's batch, as
    viterbi_mutate_multi builds their operands, each equal to its twin; in
    f32 each timed."""
    import torch

    from poreseq_tpu_torch.engine.roofline import (viterbi_gumbel_work,
                                                   viterbi_obs_work,
                                                   viterbi_sample_work,
                                                   viterbi_sweep_work)
    from poreseq_tpu_torch.engine.viterbi import (
        gumbel_cuda, gumbel_reference, obs_inputs, obs_multi_cuda,
        obs_multi_reference, sample_inputs, sample_paths_cuda,
        sample_paths_reference, transition_matrix, viterbi_sweep_cuda,
        viterbi_sweep_reference)

    dt = engine.dtype
    _, ops, n_real = obs_inputs(events, engine.device, dt)
    obs = obs_multi_cuda(*ops)
    obs_ref = obs_multi_reference(*ops)
    torch.cuda.synchronize()
    if not torch.equal(obs, obs_ref):
        fail(f"viterbi_obs (f64={f64}) " + _differs("obs", obs, obs_ref))
    del obs_ref
    obs_line = dict(max_abs_err=0.0)
    if not f64:
        obs_line.update(timed(event_ms(lambda: obs_multi_cuda(*ops)),
                              viterbi_obs_work(ops[0], ops[2], ops[3]), dt))
        obs_line["plain_ms"] = cuda_ms(lambda: obs_multi_reference(*ops),
                                       reps=2)
    report[("viterbi_obs", f64)] = obs_line
    for bp in (False, True):
        got = viterbi_sweep_cuda(obs, n_real, *VITERBI_ARGS, bp)
        ref = viterbi_sweep_reference(obs, n_real, *VITERBI_ARGS, bp)
        torch.cuda.synchronize()
        for name, a, b in zip(("liks", "fwds", "bps"), got, ref):
            if a is not None and not torch.equal(a, b):
                fail(f"viterbi_sweep (f64={f64}, backpointers={bp}) "
                     + _differs(name, a, b))
    liks, fwds, _ = got
    args = sample_inputs(liks, fwds, n_real, *SAMPLE_ARGS)
    T = transition_matrix(*VITERBI_ARGS, dt, engine.device)
    paths = sample_paths_cuda(*args, *VITERBI_ARGS, seed)
    ref = sample_paths_reference(T, *args, seed)
    torch.cuda.synchronize()
    if not torch.equal(paths, ref):
        fail(f"viterbi_sample (f64={f64}) " + _differs("paths", paths, ref))
    # the Gumbel kernel alone, over the call's candidates and rows
    nk, R = args[3].shape[0], obs.shape[1]
    rows = torch.arange(R, device=obs.device)
    gum = gumbel_cuda(seed, nk, R, dt, engine.device)
    gum_ref = gumbel_reference(seed, nk, rows, dt)
    torch.cuda.synchronize()
    if not torch.equal(gum, gum_ref):
        fail(f"viterbi_gumbel (f64={f64}) "
             + _differs("gumbel", gum, gum_ref))
    del gum_ref
    # and at the edges of its grid and of its row-key passes
    for name, (snk, sR) in gumbel_shapes().items():
        got = gumbel_cuda(seed, snk, sR, dt, engine.device)
        ref = gumbel_reference(seed, snk, torch.arange(sR, device=obs.device),
                               dt)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"viterbi_gumbel (f64={f64}, {name}: {snk} x {sR}) "
                 + _differs("gumbel", got, ref))
        del got, ref
    sweep, sample, gumbel = (dict(max_abs_err=0.0) for _ in range(3))
    if not f64:
        sweep.update(timed(
            event_ms(lambda: viterbi_sweep_cuda(obs, n_real, *VITERBI_ARGS)),
            viterbi_sweep_work(obs, n_real, False), dt))
        sweep["plain_ms"] = cuda_ms(
            lambda: viterbi_sweep_reference(obs, n_real, *VITERBI_ARGS),
            reps=2)
        sweep["backpointers"] = timed(event_ms(
            lambda: viterbi_sweep_cuda(obs, n_real, *VITERBI_ARGS, True)),
            viterbi_sweep_work(obs, n_real, True), dt)
        sample.update(timed(
            event_ms(lambda: sample_paths_cuda(*args, *VITERBI_ARGS, seed)),
            viterbi_sample_work(args[0], args[1], args[3]), dt))
        sample["plain_ms"] = cuda_ms(
            lambda: sample_paths_reference(T, *args, seed), reps=2)
        launch = lambda: gumbel_cuda(seed, nk, R, dt, engine.device)
        gumbel.update(timed(event_ms(launch),
                            viterbi_gumbel_work(args[1], nk, dt), dt))
        gumbel["queued_ms"] = queued_ms(launch)
        gumbel["plain_ms"] = cuda_ms(
            lambda: gumbel_reference(seed, nk, rows, dt), reps=2)
    report[("viterbi_sweep", f64)] = sweep
    report[("viterbi_sample", f64)] = sample
    report[("viterbi_gumbel", f64)] = gumbel
    B = obs.shape[0]
    print(f"[kernels] viterbi f{'64' if f64 else '32'}: {len(events)} regions "
          f"(bucket {B}, rows {n_real.tolist()} of {R}), 16 candidates: "
          f"observations [{B}, {R}, 1024] over E_pad={ops[0].shape[2]} "
          f"events equal"
          + (f" ({_timing(obs_line)}, {_earlier('viterbi_obs')}, twin "
             f"{obs_line['plain_ms']:.1f} ms)" if not f64 else "")
          + f"; sweep liks/fwds equal, with backpointers liks/fwds/bps equal, "
          f"sampler paths of {paths.shape[0] * paths.shape[1]} chains equal, "
          f"the Gumbel kernel's [{nk}, {R}, 1024] equal (and at "
          f"{len(gumbel_shapes())} edge shapes)"
          + (f"; sweep {_timing(sweep)} (one-block design: "
             f"{ONE_BLOCK_MS['viterbi_sweep']} ms), twin "
             f"{sweep['plain_ms']:.1f} ms; "
             f"with backpointers {_timing(sweep['backpointers'])}; sampler "
             f"{_timing(sample)} with its Gumbel launch (one-block design: "
             f"{ONE_BLOCK_MS['viterbi_sample']} ms), twin "
             f"{sample['plain_ms']:.1f} ms; Gumbel kernel alone "
             f"{_timing(gumbel)}, queued {gumbel['queued_ms']:.4f} ms "
             f"({_earlier('viterbi_gumbel')}), twin "
             f"{gumbel['plain_ms']:.1f} ms | "
             f"{gpu_line()}"
             if not f64 else ""), flush=True)


def _scoring_operands(engine, datas):
    """The operands of the per-base likes, the scoring geometry and its
    windows in one Mutate round's scoring call on an 8-region lockstep
    batch, as group_launches builds them: (batch, ral, rlk, S_e, C, scoring
    width, Ws)."""
    import torch

    from poreseq_tpu_torch.engine.align import both_dev
    from poreseq_tpu_torch.engine.pack import fill_geometry

    ctx = engine._prepare_multi(datas)
    p = datas[0].params
    fi = fill_geometry(ctx["arrays"], ctx["ref_indexes"], ctx["S_e"],
                       ctx["C"], p.realign_width)
    T = ctx["arrays"]["mean"].shape[1]
    t = lambda x: torch.as_tensor(x, device=engine.device)
    out = both_dev(ctx["batch"], t(ctx["states2"]), t(fi["i0"]), t(fi["i1"]),
                   t(fi["is_pad"]), float(p.lik_offset), p.realign_width, T,
                   int(ctx["C"] + 2 * T + 8))
    Ws = 2 * min(p.scoring_width, p.realign_width) + 1
    return (ctx["batch"], out[6], out[7], t(ctx["S_e"].astype(np.int32)),
            int(ctx["C"]), p.scoring_width, Ws)


def check_prologue(engine, datas, f64: bool, report: dict):
    """The per-base likes, the scoring geometry and its windows on the
    operands of a Mutate round's scoring call (8 regions, scoring width
    100), each equal to its twin; in f32 each timed."""
    import torch

    from poreseq_tpu_torch.engine.align import likes_cuda, likes_reference
    from poreseq_tpu_torch.engine.mutscore import (geom_cuda, geom_reference,
                                                   windows_cuda,
                                                   windows_reference)
    from poreseq_tpu_torch.engine.roofline import (geom_work, likes_work,
                                                   windows_work)

    batch, ral, rlk, S_e, C, sw, Ws = _scoring_operands(engine, datas)
    dt = engine.dtype
    i0r, i1r = geom_cuda(ral, batch.n0, S_e, sw, C)
    win_args = (batch.mean, batch.stdv, batch.lsr, i0r, Ws)
    runs = {
        "likes": ((ral, rlk, C), likes_cuda, likes_reference,
                  likes_work(ral, C)),
        "geom": ((ral, batch.n0, S_e, sw, C), geom_cuda, geom_reference,
                 geom_work(ral, batch.n0, C)),
        "windows": (win_args, windows_cuda, windows_reference,
                    windows_work(batch, i0r, Ws)),
    }
    for name, (args, kern, twin, work) in runs.items():
        got, ref = kern(*args), twin(*args)
        torch.cuda.synchronize()
        got, ref = ((got,), (ref,)) if name == "likes" else (got, ref)
        for a, b in zip(got, ref):
            if not torch.equal(a, b):
                fail(f"{name} (f64={f64}) " + _differs(name, a, b))
        line = dict(max_abs_err=0.0)
        if not f64:
            line.update(timed(event_ms(lambda: kern(*args)), work, dt))
            if name in QUEUED:
                line["queued_ms"] = queued_ms(lambda: kern(*args))
            line["plain_ms"] = cuda_ms(lambda: twin(*args), reps=2)
        report[(name, f64)] = line
    E, T = ral.shape
    print(f"[kernels] prologue f{'64' if f64 else '32'}: {len(datas)} regions "
          f"E={E} ({int(batch.active.sum())} active) T={T} C={C}: likes "
          f"[{E}, {C}], geometry i0/i1 [{E}, {C + 1}] (scoring width {sw}) "
          f"and windows 3 x [{C + 1}, {E}, {Ws}] equal their twins"
          + "".join(f"; {n} {_timing(report[(n, f64)])}"
                    + (f", queued {report[(n, f64)]['queued_ms']:.4f} ms"
                       if n in QUEUED else "")
                    + (f" ({_earlier(n)})" if n in EARLIER_MS else "")
                    + f", twin {report[(n, f64)]['plain_ms']:.1f} ms"
                    for n in runs if not f64)
          + (f" | {gpu_line()}" if not f64 else ""), flush=True)


# phase 2's holds past one band row a thread and past the geometry's staged
# level cap: the fill at realign widths 700 and 2047 (W = 1401, two rows a
# thread; W = 4095, four), the group scorer at scoring width 600 (Ws =
# 1201, two) and the geometry at GEOM_MAX_LEVELS + 256 and twice it (the
# instance that reads the row from device memory)
WIDE_FILL = (700, 2047)
WIDE_WIDTHS = dict(realign_width=700, scoring_width=600, point_width=20)
# ... and the wide instances past the register-held scan: the fill at
# realign widths 2048 and 4096 (W = 4097, 8193), the group scorer at scoring
# width 2048 (Ws = 4097), on a 240 b region at 8X (its first 8 event rows,
# C = 256; 60 random mutations), small so that the twins stay cheap; the
# observations at 8193 events on 8 rows are OBS_SHAPES' last
SCAN_WIDE_FILL = (2048, 4096)
SCAN_WIDE_WIDTHS = dict(realign_width=2048, scoring_width=2048,
                        point_width=20)
SCAN_WIDE_REGION = dict(ref_len=240, coverage=8)
SCAN_WIDE_ROWS, SCAN_WIDE_MUTS = 8, 60
# the fill past the register-held scan runs two instances, both held to the
# twin and timed at each SCAN_WIDE_FILL width: the cluster instance and the
# wide (memory) one; timed also on SCAN_TIMED_ROWS event rows (the held 8
# rows 16 times: every SM busy for either instance), not held there
FILL_PAST_REGISTERS = SCORER_PAST_REGISTERS = ("cluster", "wide")
SCAN_TIMED_ROWS = 128
# ... and so does the group scorer, at scoring widths SCAN_WIDE_SCORING (Ws =
# 4097 and 8193, each on the small region's groups at realign width = the
# scoring width): both instances held to the twin (and to each other bit for
# bit), then timed in turns
SCAN_WIDE_SCORING = (2048, 4096)
# ... and the geometry past its staged cap: at GEOM_MAX_LEVELS + 256 and
# twice it the cluster instance (the route's) and the memory one, held and
# timed in turns; past the cluster's capacity (GEOM_CLUSTER_MAX slices + 256
# levels) the memory instance, the route's there
GEOM_PAST_CAP = (("cluster", "memory"), ("cluster", "memory"), ("memory",))
# the launches a turn of those (each instance timed twice, in turns; 10
# where the other timings take 20, for the smoke's time limit)
TURN_REPS = 10
OBS_WIDE_EVENTS, OBS_WIDE_ROWS = 8193, 8
# the observations past the tiled instance's cap of 32 events: E_pad: (B, R)
# of phase 2's holds and timings (the cap 64's edges, the chunked
# instance's 100-8193; each region's rows at OBS_ROW_FRACS, then 2, 1 and 0
# valid events)
OBS_SHAPES = {60: (8, 256), 64: (8, 256), 65: (8, 256), 100: (8, 256),
              257: (2, 256), 1024: (1, 128),
              OBS_WIDE_EVENTS: (1, OBS_WIDE_ROWS)}
OBS_ROW_FRACS = (1.0, 0.9, 0.6, 0.25, 0.05)
# the earlier general path's events ms at OBS_SHAPES and at the coverage
# phase's largest launch (coverage_obs_operands), f32 (a block a row, the
# tables read from device memory for every row, a trim past 8 dropped
# events bisecting the order keys; tools/obs_instances.py --parent, PERF.md
# §6; NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
OBS_GENERAL_MS = {60: 10.023, 64: 11.241, 65: 11.511, 100: 18.639,
                  257: 15.836, 1024: 23.052, OBS_WIDE_EVENTS: 335.597,
                  "coverage": 19.127}


def _long_rows(rng, E: int, T: int):
    """Geometry operands of reads T levels long on a region of about T
    bases (C = T columns): ral [E, T] (a level's reference index rises by
    0-2, one level in ten unanchored), n0 and S_e [E]; row 0 has no anchor,
    row 1 one anchor, row 2 an anchor at level 0 then a gap (the level-0
    quirk) and row 3 ends at T / 3 levels."""
    ral = np.cumsum(rng.integers(0, 3, (E, T)), axis=1) + 1.0
    ral[rng.random((E, T)) < 0.1] = -1.0
    n0 = np.full(E, T, dtype=np.int32)
    ral[0] = 0.0
    ral[1] = 0.0
    ral[1, T // 2] = T // 2
    ral[2, 1:9] = 0.0
    n0[3] = T // 3
    S_e = np.minimum(ral.max(axis=1) + 1, T).clip(0).astype(np.int32)
    return ral, n0, S_e


def obs_shape_inputs(seed: int, B: int, R: int, E: int, dtype,
                     device="cuda"):
    """Observation operands at [B, R, E] (on the card): row r of a region
    with each event valid at OBS_ROW_FRACS[r] (cycling; 1.0: every event),
    its last three rows with 2, 1 and 0 valid events, a stdv of 0 now and
    then (the clamp) and event 1 a copy of event 0 (ties)."""
    import torch

    rng = np.random.default_rng(seed + E)
    lvl = rng.normal(60, 8, (B, R, E))
    sd = np.where(rng.random((B, R, E)) < 0.02, 0.0,
                  rng.uniform(0.5, 3, (B, R, E)))
    fr = np.resize(OBS_ROW_FRACS, R)
    valid = rng.random((B, R, E)) < fr[None, :, None]
    valid[:, -3:] = False
    for b in range(B):
        valid[b, -3, rng.choice(E, min(2, E), replace=False)] = True
        valid[b, -2, rng.integers(E)] = True
    tabs = np.empty((B, 6, E, 1024))
    tabs[:, 0] = rng.normal(60, 8, (B, E, 1024))
    tabs[:, 1] = rng.uniform(1, 3, (B, E, 1024))
    tabs[:, 2] = np.log(tabs[:, 1])
    tabs[:, 3] = rng.uniform(0.8, 2, (B, E, 1024))
    tabs[:, 4] = rng.uniform(1, 4, (B, E, 1024))
    tabs[:, 5] = np.log(tabs[:, 4])
    if E > 1:
        lvl[:, :, 1], sd[:, :, 1] = lvl[:, :, 0], sd[:, :, 0]
        tabs[:, :, 1] = tabs[:, :, 0]
    t = lambda x, d=dtype: torch.as_tensor(x, dtype=d, device=device)
    return t(lvl), t(sd), t(valid, torch.bool), t(tabs)


def check_wide(engine, seed: int, f64: bool, report: dict):
    """The wide instances held to their twins: the fill at WIDE_FILL and
    SCAN_WIDE_FILL (forward with steps, backward without: the main path's;
    at SCAN_WIDE_FILL both FILL_PAST_REGISTERS instances) with phase 2's
    tolerances, the group scorer on a Mutate call's groups at WIDE_WIDTHS
    (8 regions) and SCAN_WIDE_WIDTHS (one small region), the geometry past
    its staged cap and the observations past the staged path bit-equal; in
    f32 each wide launch timed (event and queued ms) beside its bound,
    under the kernel's "wide" key (the fill's two instances past the
    register-held scan in turns, at SCAN_WIDE_ROWS and SCAN_TIMED_ROWS
    event rows).  Each instance's launches are counted (Kernel.instances)
    and every new one must have run."""
    import torch

    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda
    from poreseq_tpu_torch.engine.mutscore import (GEOM, GEOM_CLUSTER_MAX,
                                                   GEOM_MAX_LEVELS, MUTSCORE,
                                                   geom_cuda, geom_instance,
                                                   geom_reference,
                                                   group_launches,
                                                   group_totals_cuda)
    from poreseq_tpu_torch.engine.roofline import (fill_work, geom_work,
                                                   group_work)

    t0 = time.perf_counter()
    dt = engine.dtype
    wide = {"fill": {}, "mutscore": {}, "geom": {}}
    errs = {k: 0.0 for k in wide}
    n0 = {k: k.instances.copy() for k in (FILL, MUTSCORE)}

    def time_it(fn, work, reps=20, **shape):
        return dict(shape, queued_ms=queued_ms(fn, reps),
                    **timed(event_ms(fn, reps), work, dt))

    small = SCAN_WIDE_REGION
    for width in WIDE_FILL + SCAN_WIDE_FILL:
        W = 2 * width + 1
        if width in SCAN_WIDE_FILL:
            batch, states, i0, i1, pad, off = _rows(_fill_inputs(
                engine, _session(seed, width, **small)),
                slice(0, SCAN_WIDE_ROWS))
        else:
            batch, states, i0, i1, pad, off = _fill_inputs(
                engine, _session(seed, width))
        shape = dict(E=batch.mean.shape[0], C=states.shape[0])
        insts = FILL_PAST_REGISTERS if width in SCAN_WIDE_FILL else (None,)
        for name, backward, steps in (("forward", False, True),
                                      ("backward", True, False)):
            args = (batch, states, i0, i1, pad, off, backward, W, steps)
            twin, cache = {}, {}
            for inst in insts:          # the twin called once
                errs["fill"] = max(errs["fill"], hold_fill(
                    args, f"kernels wide W={W}", twin, inst, cache))
            del cache
            if f64:
                continue
            if insts == (None,):
                wide["fill"].setdefault(f"W={W}", {})[name] = time_it(
                    lambda: fill_cuda(*args),
                    fill_work(batch, states, pad, W, steps), **shape,
                    **twin)
                continue
            rows = torch.arange(SCAN_TIMED_ROWS, device=states.device)
            many = _rows(args, rows % shape["E"])
            for a, held in ((args, twin), (many, {})):
                E = a[1].shape[1]
                # the two instances in turns, each twice
                for inst in insts + insts[::-1]:
                    d = time_it(lambda: fill_cuda(*a, instance=inst),
                                fill_work(*a[:2], a[4], W, steps), E=E,
                                C=shape["C"], **held)
                    runs = wide["fill"].setdefault(
                        f"W={W} E={E} {inst}", {})
                    runs[name if name not in runs else f"{name} (2)"] = d

    datas, mlists = _mut_regions(seed, WIDE_WIDTHS)["mutate"]
    calls = [(WIDE_WIDTHS, datas, mlists, (None,))]
    for sw in SCAN_WIDE_SCORING:
        data = _session(seed, sw, scoring_width=sw, **small)
        calls.append((dict(SCAN_WIDE_WIDTHS, realign_width=sw,
                           scoring_width=sw), [data], [_random_mutations(
                               data.sequence, np.random.default_rng(seed + 2),
                               SCAN_WIDE_MUTS)], SCORER_PAST_REGISTERS))
    n_groups = {}
    for widths, ds, ms, insts in calls:
        Ws = 2 * widths["scoring_width"] + 1
        n_groups[Ws] = 0
        for gp, _, args in group_launches(engine, ds, ms, [True] * len(ds)):
            if args[16] != Ws:
                fail(f"kernels wide: a Mutate launch at Ws={args[16]}")
            if insts != (None,):            # the real groups only
                args = _groups(args, gp["G"])
            n_groups[Ws] += gp["G"]
            twin, cache = {}, {}
            for inst in insts:              # the twin called once
                errs["mutscore"] = max(errs["mutscore"], hold_mutscore(
                    args, "kernels wide", twin, inst, cache))
            del cache
            if f64:
                continue
            shape = dict(G=gp["G"], C=args[1].shape[0], E=args[1].shape[1])
            # past the register-held scan the two instances in turns
            for inst in insts + insts[::-1] if insts != (None,) else insts:
                wide["mutscore"].setdefault(
                    f"Ws={Ws}" + (f" {inst}" if inst else ""), []).append(
                    time_it(lambda: group_totals_cuda(*args, instance=inst),
                            group_work(*args),
                            reps=20 if inst is None else TURN_REPS, **shape,
                            **twin))

    ran = {k.name: dict(k.instances - n0[k]) for k in n0}
    if not (ran["fill"].get("wide") and ran["fill"].get("cluster")
            and ran["mutscore"].get("wide") and ran["mutscore"].get("cluster")):
        fail(f"kernels wide: the new instances did not all run: {ran}")

    cap = GEOM_MAX_LEVELS[dt]
    g0 = GEOM.instances.copy()
    geom_T = (cap + 256, 2 * cap, GEOM_CLUSTER_MAX * cap + 256)
    for T, insts in zip(geom_T, GEOM_PAST_CAP):
        ral, n0, S_e = _long_rows(np.random.default_rng(seed + T), 8, T)
        t = lambda x: torch.as_tensor(x, device="cuda")
        args = (t(ral).to(dt), t(n0), t(S_e), WIDE_WIDTHS["scoring_width"],
                T)
        route = geom_instance(T, int((n0 > 0).sum()), dt)
        if route[0] != insts[0]:
            fail(f"kernels wide geom T={T}: the route gives {route}")
        t0g = time.perf_counter()
        ref = geom_reference(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0g) * 1e3
        named = {n: route if n == route[0] else (n, 0) for n in insts}
        for n, inst in named.items():
            for a, b in zip(geom_cuda(*args, instance=inst), ref):
                if not torch.equal(a, b):
                    fail(f"kernels wide geom {inst} T={T} (f64={f64}) "
                         + _differs("geom", a, b))
        if f64:
            continue
        for n in insts + insts[::-1] if len(insts) > 1 else insts:
            wide["geom"].setdefault(f"T={T} {n}", []).append(time_it(
                lambda: geom_cuda(*args, instance=named[n]),
                geom_work(args[0], args[1], T), reps=TURN_REPS,
                E=ral.shape[0], C=T, ctas=named[n][1], plain_ms=plain_ms))
    ran["geom"] = dict(GEOM.instances - g0)
    if set(ran["geom"]) != {"cluster", "memory"}:
        fail(f"kernels wide geom: launches by instance {ran['geom']}")
    for k, err in errs.items():
        # in f64 the fill's line comes after the pool's holds (phase_kernels)
        line = report.setdefault((k, f64), dict(max_abs_err=0.0))
        line["max_abs_err"] = max(line["max_abs_err"], err)
        if not f64:
            line["wide"] = wide[k]
    fmt = lambda d: f"E={d['E']} C={d['C']} " + _timing(d) + \
        f", queued {d['queued_ms']:.4f} ms" + (
            f", twin {d['plain_ms']:.1f} ms" if "plain_ms" in d else "")
    print(f"[kernels] wide f{'64' if f64 else '32'}: fill W="
          f"{[2 * w + 1 for w in WIDE_FILL + SCAN_WIDE_FILL]} forward with "
          f"steps and backward held to the twin (past 4095 rows the "
          f"{' and '.join(FILL_PAST_REGISTERS)} instances; max |diff| "
          f"{errs['fill']:.3e}); mutscore on {n_groups} groups (by Ws) of "
          f"{len(datas)} regions and one region a width held (past 4095 "
          f"rows the {' and '.join(SCORER_PAST_REGISTERS)} instances, equal "
          f"bit for bit; max |diff| {errs['mutscore']:.3e}); geom T="
          f"{list(geom_T)} equal the twin ({GEOM_PAST_CAP} there); launches "
          f"by instance {ran}; {time.perf_counter() - t0:.1f} s"
          + ("".join(f"; fill {w} {n} {fmt(d)}"
                     for w, runs in wide["fill"].items()
                     for n, d in runs.items())
             + "".join(f"; mutscore {w} G={d['G']} {fmt(d)}"
                       for w, runs in wide["mutscore"].items() for d in runs)
             + "".join(f"; geom {w} ctas {d['ctas']} {fmt(d)}"
                       for w, runs in wide["geom"].items() for d in runs)
             + f" | {gpu_line()}" if not f64 else ""), flush=True)


def check_obs_shapes(engine, seed: int, f64: bool, report: dict):
    """The observations past the tiled instance's cap: at each E of
    OBS_SHAPES, the launch (the instance obs_path routes E to) equal to the
    twin; in f32 each timed (event and queued ms) beside its bound, the
    twin's ms, under the kernel's "shapes" key (the earlier general path's
    ms, OBS_GENERAL_MS, a constant from an earlier call, in the printed
    line only)."""
    import torch

    from poreseq_tpu_torch.engine.roofline import viterbi_obs_work
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_OBS, obs_multi_cuda,
                                                  obs_multi_reference,
                                                  obs_path)

    t0, dt, shapes = time.perf_counter(), engine.dtype, {}
    n0 = VITERBI_OBS.instances.copy()
    for E, (B, R) in OBS_SHAPES.items():
        ops = obs_shape_inputs(seed, B, R, E, dt)
        got = obs_multi_cuda(*ops)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = obs_multi_reference(*ops)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        if not torch.equal(got, ref):
            fail(f"kernels viterbi_obs E={E} [{B}, {R}] (f64={f64}) "
                 + _differs("obs", got, ref))
        del got, ref
        if not f64:
            fn = lambda: obs_multi_cuda(*ops)
            shapes[f"E={E}"] = dict(
                E=E, B=B, R=R, instance=obs_path(E)[1], plain_ms=plain_ms,
                queued_ms=queued_ms(fn),
                **timed(event_ms(fn), viterbi_obs_work(ops[0], ops[2],
                                                       ops[3]), dt))
        del ops
    ran = dict(VITERBI_OBS.instances - n0)
    want = {obs_path(E)[1] for E in OBS_SHAPES}
    if set(ran) != want:
        fail(f"kernels viterbi_obs: launches by instance {ran}, the route "
             f"gives {want}")
    if not f64:
        report[("viterbi_obs", f64)]["shapes"] = shapes
    print(f"[kernels] viterbi_obs f{'64' if f64 else '32'} past the tiled "
          f"cap: E = {list(OBS_SHAPES)} ([B, R] "
          f"{list(OBS_SHAPES.values())}, rows of every, some, 2, 1 and 0 "
          f"valid events) equal the twin; launches by instance {ran}; "
          f"{time.perf_counter() - t0:.1f} s"
          + ("".join(f"; {k} {d['instance']} {_timing(d)}, queued "
                     f"{d['queued_ms']:.4f} ms, twin {d['plain_ms']:.1f} ms,"
                     f" general path (earlier, OBS_GENERAL_MS) "
                     f"{OBS_GENERAL_MS[d['E']]} ms"
                     for k, d in shapes.items())
             + f" | {gpu_line()}" if not f64 else ""), flush=True)


def phase_kernels(seed: int):
    """2: every kernel held to its twin in f64 and f32, and timed in f32.
    The fill holds of FILL_WIDTHS run in a pool of FILL_WORKERS spawned
    processes beside the f64 checks (which time nothing); the f32 checks,
    and with them every timing, start once the pool has ended."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from poreseq_tpu_torch.engine import TorchEngine

    report = {}
    regions = _mut_regions(seed)
    # the Viterbi kernels' regions as phase 2b has them: the group scorer's
    # check realigns its regions' events in place
    events = [d.events for d in _mut_regions(seed)["refine"][0]]
    with ProcessPoolExecutor(
            FILL_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = {(w, f64): pool.submit(fill_width_holds, seed, w, f64)
                   for f64 in (True, False) for w in FILL_WIDTHS}
        engine = TorchEngine("cuda", torch.float64)
        check_backtrace(engine, _session(seed), True, report)
        check_mutscore(engine, regions, True, report)
        check_viterbi(engine, events, seed, True, report)
        check_prologue(engine, _mut_regions(seed)["mutate"][0], True, report)
        check_wide(engine, seed, True, report)
        check_obs_shapes(engine, seed, True, report)
        held = {k: f.result(timeout=900) for k, f in pending.items()}
    check_fill(engine, seed, True, report, held)
    engine = TorchEngine("cuda", torch.float32)
    check_fill(engine, seed, False, report, held)
    check_backtrace(engine, _session(seed), False, report)
    check_mutscore(engine, regions, False, report)
    check_viterbi(engine, events, seed, False, report)
    check_prologue(engine, _mut_regions(seed)["mutate"][0], False, report)
    check_wide(engine, seed, False, report)
    check_obs_shapes(engine, seed, False, report)
    if torch.cuda.device_count() < 2:
        print(f"[kernels] cuda:1: skipped, torch sees "
              f"{torch.cuda.device_count()} card", flush=True)
        return report
    # the wrappers launch on their operands' card: the same holds on cuda:1
    engine, second = TorchEngine("cuda:1", torch.float64), {}
    check_fill(engine, seed, True, second)
    check_backtrace(engine, _session(seed), True, second)
    check_mutscore(engine, _mut_regions(seed), True, second)
    print(f"[kernels] cuda:1: fill, backtrace and group scorer equal their "
          f"twins in f64", flush=True)
    return report


def _kernels():
    from poreseq_tpu_torch.engine.align import BACKTRACE, LIKES
    from poreseq_tpu_torch.engine.fill import FILL
    from poreseq_tpu_torch.engine.mutscore import GEOM, MUTSCORE, WINDOWS
    from poreseq_tpu_torch.engine.viterbi import (VITERBI_GUMBEL,
                                                  VITERBI_OBS,
                                                  VITERBI_SAMPLE,
                                                  VITERBI_SWEEP)

    return (FILL, MUTSCORE, BACKTRACE, VITERBI_SWEEP, VITERBI_SAMPLE,
            VITERBI_GUMBEL, VITERBI_OBS, LIKES, GEOM, WINDOWS)


# the kernels every engine path launches (and every shard of a mesh)
ALIGN_KERNELS = ("fill", "mutscore", "backtrace")
# ... a scoring call, with the device geometry (f32 on one device)
SCORE_KERNELS = ALIGN_KERNELS + ("windows", "geom")
VITERBI_KERNELS = ("viterbi_obs", "viterbi_sweep", "viterbi_sample",
                   "viterbi_gumbel")


# each kernel's launches by instance over the whole run (the kernels line),
# kept before a phase's counts are reset
INSTANCES_RUN: dict = {}


def _reset_launches():
    import torch

    torch.cuda.synchronize()
    for k in _kernels():
        INSTANCES_RUN.setdefault(k.name, collections.Counter()).update(
            k.instances)
        k.launches = 0
        k.instances.clear()


def _launches() -> dict:
    return {k.name: k.launches for k in _kernels()}


def _need_launches(phase: str, launches: dict, names=None):
    for name in names or launches:
        if launches[name] <= 0:
            fail(f"{phase}: kernel {name} was never launched")


def _copied(x, device=None):
    """x with every tensor in it cloned, or copied to device (tuples, named
    tuples, lists and dicts rebuilt around the copies)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone() if device is None else x.to(device)
    if isinstance(x, dict):
        return {k: _copied(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copied(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(v, device) for v in x)
    return x


def _launch_keys(by_width: bool):
    """{(module, wrapper name): key and size of a launch from its bound
    arguments} for every kernel wrapper a path calls (the Gumbel kernel is
    launched by the sampler's wrapper, and kept with it)."""
    from poreseq_tpu_torch.engine import align, fill, mutscore, viterbi

    return {
        (fill, "fill_cuda"): lambda a: (
            "fill bwd" if a["backward"] else "fill fwd", a["states"].numel()),
        (mutscore, "group_totals_cuda"): lambda a: (
            f"mutscore Ws={a['Ws']}" if by_width else "mutscore",
            a["gp"]["g_start"].shape[0] * a["Mf"].shape[0]
            * a["Mf"].shape[1]),
        (align, "backtrace_cuda"): lambda a: ("backtrace",
                                              a["M"][..., 0].numel()),
        (align, "likes_cuda"): lambda a: ("likes", a["ral"].numel()),
        (mutscore, "geom_cuda"): lambda a: ("geom", a["ral"].numel()),
        (mutscore, "windows_cuda"): lambda a: ("windows",
                                               a["i0r"].numel() * a["Ws"]),
        (viterbi, "obs_multi_cuda"): lambda a: ("viterbi_obs",
                                                a["lvl"].numel()),
        (viterbi, "viterbi_sweep_cuda"): lambda a: ("viterbi_sweep",
                                                    a["obs"].numel()),
        (viterbi, "sample_paths_cuda"): lambda a: (
            "viterbi_sample", a["fwds"].numel() * a["attens"].numel()),
    }


@contextlib.contextmanager
def largest_launches(by_width: bool = False, every: bool = False):
    """Inside the block, keep a copy of the operands of the largest forward
    fill, the largest backward fill (C x E cells) and the largest group-scorer
    launch (G x C x E) that the path makes, the first of equals, under the
    keys "fill fwd", "fill bwd" and "mutscore" (by_width: the largest of
    each window width, "mutscore Ws=N"); every: also the largest launch of
    every other kernel wrapper (_launch_keys), under the kernel's name, with
    the batch's n0 and active of the fill before it (a backtrace's or a
    windows launch's work needs them) under "<name> batch", and every copy
    in the host's memory, so that the copies (tens of GB at 10 kb) do not
    count in the path's peak device memory; their seconds, part of the
    path's wall, go under "host copy s".  They are held to their twins or
    timed after the path's launch counts are read."""
    import inspect

    kept, sizes, last = ({"host copy s": 0.0} if every else {}), {}, {}
    keys = _launch_keys(by_width)
    if not every:
        keys = {k: v for k, v in keys.items()
                if k[1] in ("fill_cuda", "group_totals_cuda")}
    real = {k: getattr(*k) for k in keys}
    to = "cpu" if every else None

    def keeper(fn, key_size):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            key, size = key_size(b.arguments)
            if key.startswith("fill"):
                last["batch"] = b.arguments["batch"]
            if size > sizes.get(key, 0):
                t0 = time.perf_counter()
                # the scorer's operands without its instance (the route's
                # at any replay): group_deltas_reference's arguments
                kept[key] = _copied(tuple(
                    v for k, v in b.arguments.items()
                    if not (k == "instance" and key.startswith("mutscore"))),
                    to)
                sizes[key] = size
                if key in ("backtrace", "windows"):
                    kept[f"{key} batch"] = _copied(
                        (last["batch"].n0, last["batch"].active), to)
                if every:
                    kept["host copy s"] += time.perf_counter() - t0
            return fn(*a, **kw)
        return wrapped

    for (mod, name), key_size in keys.items():
        setattr(mod, name, keeper(real[mod, name], key_size))
    try:
        yield kept
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def hold_path_launches(kept: dict, phase: str):
    """Hold the launches kept by largest_launches to their twins and time
    each on the card; returns (a line of what was held, {key: timing})."""
    from poreseq_tpu_torch.engine.fill import fill_cuda
    from poreseq_tpu_torch.engine.mutscore import group_totals_cuda
    from poreseq_tpu_torch.engine.roofline import fill_work, group_work

    scorer = sorted((k for k in kept if k.startswith("mutscore")),
                    key=lambda k: kept[k][16]) or ["mutscore"]
    for key in ("fill fwd", "fill bwd", *scorer):
        if key not in kept:
            fail(f"{phase}: no {key} launch was kept to hold to its twin")
    t0 = time.perf_counter()
    errs = {k: hold_fill(kept[k], phase) for k in ("fill fwd", "fill bwd")}
    for k in scorer:
        errs[k] = hold_mutscore(kept[k], phase)
    secs = time.perf_counter() - t0
    times = {}
    for k in ("fill fwd", "fill bwd"):
        a = kept[k]
        times[k] = timed(event_ms(lambda: fill_cuda(*a)),
                         fill_work(a[0], a[1], a[4], a[7], a[8]),
                         a[0].mean.dtype)
    for k in scorer:
        a = kept[k]
        times[k] = timed(event_ms(lambda: group_totals_cuda(*a)),
                         group_work(*a), a[1].dtype)
    batch, states = kept["fill fwd"][:2]
    line = (f"held to the twins: fill fwd/bwd C={states.shape[0]} "
            f"E={states.shape[1]} max |diff| {errs['fill fwd']:.3e}/"
            f"{errs['fill bwd']:.3e}, "
            + ", ".join(f"{k} G={kept[k][13]['g_start'].shape[0]} "
                        f"C={kept[k][1].shape[0]} E={kept[k][1].shape[1]} "
                        f"max |diff| {errs[k]:.3e}" for k in scorer)
            + f", {secs:.2f} s; timed: "
            + "; ".join(f"{k} {_timing(v)}" for k, v in times.items()))
    return line, times


def _transition_sets(batch) -> int:
    """Distinct per-event transition operands among a batch's active rows."""
    import torch

    lik = torch.stack([batch.lik_skip, batch.lik_stay, batch.lik_extend,
                       batch.lik_insert], 1)[batch.active.bool()]
    return int(torch.unique(lik, dim=0).shape[0])


def _fast5_io() -> str:
    """Let the package's fast5 reader and writer run where h5py is missing
    (the card's machine): its npz stand-in takes its place."""
    from poreseq_tpu_torch.io import npz_h5

    return npz_h5.use_where_missing()


CONF_WIDTHS = ("realign_width = 300\nscoring_width = 100\npoint_width = 20\n"
               "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 300\n"
               "max_length = 10000\nlik_offset = 4.5\n")


def _e2e_run(d: str, seed: int, conf_text: str = CONF_WIDTHS,
             cov: int = 10):
    """Phase 3's synthetic run: 8 x 1 kb regions at cov X (phase 3: 10),
    2 % draft error (conf_text: the params file's text, phase 9's
    WIDE_CONF)."""
    from poreseq_tpu_torch.sim import write_run

    R, L = E2E_REGIONS, 1000
    truth, _, reads_dir, bam, fasta = write_run(
        d, np.random.default_rng(seed), ref_len=R * L,
        n_reads=(cov // 2) * R, read_len=L + 200, draft_error=0.02)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write(conf_text)
    regions = ["synthref:{}:{}".format(r * L, (r + 1) * L) for r in range(R)]
    return truth, fasta, bam, reads_dir, conf, regions


def coverage_events(seed: int, which=None) -> list:
    """The events of phase 3's run at COVERAGE X as the loader gives them
    (max_coverage = 30 reads, two event rows a read), of each of its 8
    regions (which: those indexes only)."""
    from poreseq_tpu_torch.core.params import load_params
    from poreseq_tpu_torch.core.regions import RegionInfo
    from poreseq_tpu_torch.io.load import events_from_bam

    _fast5_io()
    d = tempfile.mkdtemp(prefix="psq_cov_")
    try:
        _, _, bam, reads_dir, conf, regions = _e2e_run(d, seed,
                                                       cov=COVERAGE)
        params = load_params(conf)
        return [events_from_bam(reads_dir, bam, RegionInfo(r), params)
                for i, r in enumerate(regions)
                if which is None or i in which]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def loader_obs_operands(seed: int, dtype, device="cuda"):
    """The observation kernel's operands (lvl, sd, valid, tabs) of the
    coverage run's 8 regions in one batch as the loader gives them
    (coverage_events), before any refinement: a stand-in beside the
    engine's own launch (coverage_obs_operands)."""
    from poreseq_tpu_torch.engine.viterbi import obs_inputs

    return obs_inputs(coverage_events(seed), device, dtype)[1]


_COVERAGE_LAUNCH = {}


def coverage_obs_operands(seed: int, dtype):
    """The operands (lvl, sd, valid, tabs) of the largest observation
    launch the engine makes in the coverage phase's run (coverage_consensus,
    f32; once a seed in a process), in dtype (f64: the f32 values
    widened)."""
    if seed not in _COVERAGE_LAUNCH:
        _COVERAGE_LAUNCH[seed] = coverage_consensus(seed)["calls"]["largest"]
    lvl, sd, valid, tabs = _COVERAGE_LAUNCH[seed]
    return lvl.to(dtype), sd.to(dtype), valid, tabs.to(dtype)


def _write_lines(path: str, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_viterbi(seed: int):
    """2b: threefry2x32 on the card, and each region's Viterbi candidates
    inside an 8-region batch against its solo call."""
    import torch

    from poreseq_tpu_torch.engine import TorchEngine, prng

    _reset_launches()
    t0 = time.perf_counter()
    t = lambda v: torch.tensor([v], dtype=torch.int64, device="cuda")
    for (sd, k, i), words in PINNED_KEYS:
        k0, k1 = prng.split(prng.prng_key(sd), 16, "cuda")
        got = tuple(int(w[0]) for w in prng.fold_in(
            (k0[k:k + 1], k1[k:k + 1]), t(i)))
        if got != words:
            fail(f"viterbi: row key {(sd, k, i)} = {got} on the card, "
                 f"pinned {words}")
    for words, s, w32, w64 in PINNED_WORDS:
        y0, y1 = (int(y[0]) for y in prng.threefry2x32(
            *(t(w) for w in words), t(0), t(s)))
        if (y0 ^ y1, y0 << 32 | y1) != (w32, w64):
            fail(f"viterbi: threefry2x32({words}, (0, {s})) = {(y0, y1)} on "
                 f"the card, pinned words {(w32, w64)}")
    rows = torch.arange(0, 4096, 7, dtype=torch.int64)

    def uniforms(device, dt):
        k0, k1 = prng.split(prng.prng_key(seed), 16, device)
        a, b = prng.fold_in((k0[:, None], k1[:, None]),
                            rows.to(device)[None, :])
        return prng.uniform((a[..., None], b[..., None]), 1024, dt).cpu()

    for dt in (torch.float32, torch.float64):
        if not torch.equal(uniforms("cuda", dt), uniforms("cpu", dt)):
            fail(f"viterbi: {dt} uniforms differ between the card and the "
                 "CPU")
    events = [d.events for d in _mut_regions(seed)["refine"][0]]
    matches, walls = {}, {}
    for dt in (torch.float64, torch.float32):
        eng = TorchEngine("cuda", dt, seed=seed)
        run = lambda evs: eng.viterbi_mutate_multi(evs, 16, 0.05, 0.01,
                                                   0.33, 0.75)
        tb = time.perf_counter()
        batch = run(events)
        walls[dt] = time.perf_counter() - tb
        solo = [run([evs])[0] for evs in events]
        matches[dt] = sum(b == s for b, s in zip(batch, solo))
        if any(len(s) != 16 for s in solo):
            fail("viterbi: a region got fewer than 16 candidates")
    wall = time.perf_counter() - t0
    launches = _launches()
    print(f"[viterbi] threefry2x32 on the card = JAX's pinned keys and "
          f"words, uniforms bit-equal to the CPU's; {len(events)} regions "
          f"(10-14X, 1 kb) "
          f"batched vs solo, 16 candidates each: f64 "
          f"{matches[torch.float64]}/{len(events)} equal, f32 "
          f"{matches[torch.float32]}/{len(events)} equal; batched call f64 "
          f"{walls[torch.float64]:.2f} s, f32 {walls[torch.float32]:.2f} s; "
          f"phase wall {wall:.2f} s, launches {launches} | {gpu_line()}",
          flush=True)
    if matches[torch.float64] != len(events):
        fail(f"viterbi: only {matches[torch.float64]} of {len(events)} "
             "regions got their solo candidates inside the f64 batch")
    _need_launches("viterbi", launches, VITERBI_KERNELS)
    return launches


ENGINE_METHODS = ("score_alignments_multi", "score_mutations_multi",
                  "viterbi_mutate_multi", "map_alignments", "flush_ref_likes")


@contextlib.contextmanager
def engine_seconds():
    """Inside the block, count the calls of TorchEngine's methods the
    pipeline reaches and sum their host walls (a call nested in another is
    counted in both; map_alignments runs on several threads at once, so its
    sum can exceed the wall).  Yields {method: [calls, seconds]}."""
    import threading

    from poreseq_tpu_torch.engine import TorchEngine

    out, lock = {m: [0, 0.0] for m in ENGINE_METHODS}, threading.Lock()
    real = {m: getattr(TorchEngine, m) for m in ENGINE_METHODS}

    def timed_method(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    out[name][0] += 1
                    out[name][1] += time.perf_counter() - t0
        return wrapped

    for m, fn in real.items():
        setattr(TorchEngine, m, timed_method(m, fn))
    try:
        yield out
    finally:
        for m, fn in real.items():
            setattr(TorchEngine, m, fn)


def _accuracies(seqs: dict, truth: str) -> list:
    """Each region's accuracy against the truth: regions are draft
    coordinates, so the truth window is widened by 400 b on each side that
    draft indel drift does not push a region out of it (bench.py's)."""
    from poreseq_tpu_torch.api import swalign

    return [swalign(s, truth[max(int(n.split(":")[1]) - 400, 0)
                             : int(n.split(":")[2]) + 400])[0]
            for n, s in seqs.items()]


def phase_e2e(seed: int, profile: str | None = None):
    import glob

    import torch

    from poreseq_tpu_torch.io.fasta import read_fasta
    from poreseq_tpu_torch import cli

    fast5_io = _fast5_io()
    R, cov = E2E_REGIONS, 10
    d = tempfile.mkdtemp(prefix="psq_smoke_")
    try:
        truth, fasta, bam, reads_dir, conf, regions = _e2e_run(d, seed)
        rf = _write_lines(os.path.join(d, "regions.txt"), regions)
        out = os.path.join(d, "out.fasta")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with engine_seconds() as secs:
            cli.main(["consensus", fasta, bam, reads_dir, "-R", rf, "-p",
                      conf, "-o", out, "-i", "4", "--region-batch", "8",
                      "--device", "cuda"]
                     + (["--profile", profile] if profile else []))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if profile:
            from poreseq_tpu_torch import trace_summary

            for path in glob.glob(os.path.join(profile, "*.trace.json")):
                print(f"[e2e] profile {path}:", flush=True)
                trace_summary.main([path])
        launches = _launches()
        seqs = read_fasta(out)
        accs = _accuracies(seqs, truth)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if len(seqs) != R:
        fail(f"e2e: {len(seqs)} output records, expected {R}")
    acc = float(np.mean(accs))
    print(f"[e2e] consensus {R} x 1 kb at {cov}X, widths 300/100/20, "
          f"-i 4 --region-batch 8: wall {wall:.2f} s, "
          f"{wall / R:.2f} s/region, mean accuracy {acc:.3f}% "
          f"(min {min(accs):.3f}%), launches {launches}, engine host "
          f"seconds (calls, s) "
          f"{ {m: (n, round(t, 3)) for m, (n, t) in secs.items()} }, "
          f"peak device memory {peak / 2**20:.1f} MiB, "
          f"fast5 via {fast5_io} | {gpu_line()}", flush=True)
    if acc < 99.0:
        fail(f"e2e mean accuracy {acc:.3f}% < 99.0%")
    _need_launches("e2e", launches)
    return launches, dict(seqs=seqs, wall=wall, peak=peak, acc=acc,
                          secs=secs)


@contextlib.contextmanager
def obs_calls():
    """Inside the block, record every observation launch the path makes
    (viterbi.obs_multi_cuda): (E_pad, [B, R], the instance it ran), and keep
    a copy of the operands of the largest ([B, R, E_pad] elements, the
    first of equals) under "largest"."""
    from poreseq_tpu_torch.engine import viterbi

    real, out = viterbi.obs_multi_cuda, {"calls": [], "largest": None}

    def wrapped(lvl, sd, valid, tabs, instance=None):
        n0 = viterbi.VITERBI_OBS.instances.copy()
        obs = real(lvl, sd, valid, tabs, instance)
        ran, = viterbi.VITERBI_OBS.instances - n0
        B, R, E = lvl.shape
        out["calls"].append((E, [B, R], ran))
        if out["largest"] is None or lvl.numel() > out["largest"][0].numel():
            out["largest"] = _copied((lvl, sd, valid, tabs))
        return obs

    viterbi.obs_multi_cuda = wrapped
    try:
        yield out
    finally:
        viterbi.obs_multi_cuda = real


def coverage_consensus(seed: int) -> dict:
    """Phase 3's run at COVERAGE X through the port's CLI `consensus -i 4
    --region-batch 8 --device cuda`, f32: dict(truth, seqs, wall, peak
    device bytes, launches, observation launches by instance, engine host
    seconds by method, calls: obs_calls' record)."""
    import torch

    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.engine.viterbi import VITERBI_OBS
    from poreseq_tpu_torch.io.fasta import read_fasta

    _fast5_io()
    d = tempfile.mkdtemp(prefix="psq_smoke_cov_")
    try:
        truth, fasta, bam, reads_dir, conf, regions = _e2e_run(
            d, seed, cov=COVERAGE)
        rf = _write_lines(os.path.join(d, "regions.txt"), regions)
        out = os.path.join(d, "out.fasta")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with engine_seconds() as secs, obs_calls() as calls:
            cli.main(["consensus", fasta, bam, reads_dir, "-R", rf, "-p",
                      conf, "-o", out, "-i", "4", "--region-batch", "8",
                      "--device", "cuda"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _launches()
        instances = dict(VITERBI_OBS.instances)
        seqs = read_fasta(out)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dict(truth=truth, seqs=seqs, wall=wall, peak=peak,
                launches=launches, instances=instances, secs=secs,
                calls=calls)


def phase_coverage(seed: int):
    """3c: phase 3's run at COVERAGE X (3x the reads: the loader's cap,
    max_coverage = 30 reads, two event rows each, holds most regions),
    coverage_consensus: wall, accuracy (>= 99.0 %), E_pad of every Viterbi
    call (the first past the tiled instance's 32 events), observation
    launches by instance (every call past 32 events on a redesigned
    instance: tiled64 or chunked), engine host seconds, peak device memory;
    the largest observation launch held to the twin bit for bit and timed
    (event and queued ms) beside its bound and the twin's ms (printed
    beside the earlier general path's on the same launch)."""
    import torch

    from poreseq_tpu_torch.engine.roofline import viterbi_obs_work
    from poreseq_tpu_torch.engine.viterbi import (obs_multi_cuda,
                                                  obs_multi_reference)

    R = E2E_REGIONS
    run = coverage_consensus(seed)
    seqs, wall, peak, launches, instances, secs, calls = (
        run[k] for k in ("seqs", "wall", "peak", "launches", "instances",
                         "secs", "calls"))
    accs = _accuracies(seqs, run["truth"])
    if len(seqs) != R:
        fail(f"coverage: {len(seqs)} output records, expected {R}")
    ops = calls["largest"]
    got = obs_multi_cuda(*ops)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = obs_multi_reference(*ops)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    if not torch.equal(got, ref):
        fail("coverage: the largest observation launch "
             + _differs("obs", got, ref))
    del got, ref
    fn = lambda: obs_multi_cuda(*ops)
    held = dict(queued_ms=queued_ms(fn), plain_ms=plain_ms,
                **timed(event_ms(fn), viterbi_obs_work(ops[0], ops[2],
                                                       ops[3]), ops[0].dtype))
    acc = float(np.mean(accs))
    print(f"[coverage] consensus {R} x 1 kb at {COVERAGE}X (max_coverage "
          f"30 reads a region), widths 300/100/20, -i 4 --region-batch 8, "
          f"f32: wall {wall:.2f} s, mean accuracy {acc:.3f}% (min "
          f"{min(accs):.3f}%), Viterbi calls (E_pad, [B, R], instance) "
          f"{calls['calls']}, observation launches by instance {instances}, "
          f"launches {launches}, engine host seconds (calls, s) "
          f"{ {m: (n, round(t, 3)) for m, (n, t) in secs.items()} }, peak "
          f"device memory {peak / 2**20:.1f} MiB; the largest observation "
          f"launch {list(ops[0].shape)} equal to the twin, "
          f"{_timing(held)}, queued {held['queued_ms']:.4f} ms, twin "
          f"{plain_ms:.1f} ms (the earlier general path on this launch: "
          f"{OBS_GENERAL_MS['coverage']} ms, OBS_GENERAL_MS) | "
          f"{gpu_line()}", flush=True)
    if acc < 99.0:
        fail(f"coverage mean accuracy {acc:.3f}% < 99.0%")
    if not calls["calls"] or calls["calls"][0][0] <= 32:
        fail(f"coverage: the first Viterbi call's E_pad is not past 32: "
             f"{calls['calls'][:1]}")
    wrong = [c for c in calls["calls"] if c[0] > 32 and c[2] == "tiled"]
    if wrong:
        fail(f"coverage: Viterbi calls past 32 events on the tiled "
             f"instance: {wrong}")
    _need_launches("coverage", launches)
    return launches, held


def _captured(argv):
    """Run the port's CLI in this process; returns (wall s, stdout)."""
    import torch

    from poreseq_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, buf.getvalue()


def phase_variant(seed: int):
    """4: variant -m / -a / -f on a 5 kb run (BASELINE.json config 2:
    about 10 point mutations, 5 kb, 10X) at widths 300/100/20."""
    import torch

    from poreseq_tpu_torch import pipeline
    from poreseq_tpu_torch.core.params import load_params
    from poreseq_tpu_torch.core.regions import RegionInfo
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.driver import find_point_mutations
    from poreseq_tpu_torch.engine.types import AlignData
    from poreseq_tpu_torch.io.fasta import write_fasta
    from poreseq_tpu_torch.io.load import load_aligned_events
    from poreseq_tpu_torch.sim import mutate_seq, write_run

    _fast5_io()
    rng = np.random.default_rng(seed + 4)
    d = tempfile.mkdtemp(prefix="psq_smoke_var_")
    try:
        truth, _, reads, bam, fasta = write_run(
            d, np.random.default_rng(seed + 40), ref_len=5000, n_reads=25,
            read_len=1200, draft_error=0.0)
        conf = _write_lines(os.path.join(d, "params.conf"),
                            [CONF_WIDTHS.strip()])
        # 10 planted substitutions and 10 corrupting positions, 300 b or
        # more from either end and 40 b or more from each other
        pos = rng.choice(np.arange(300, 4700, 40), 20, replace=False)
        pos = pos + rng.integers(0, 10, 20)
        planted_pos, corrupt_pos = sorted(pos[:10]), sorted(pos[10:])
        other = lambda b: "ACGT"[("ACGT".index(b) + 1 + int(rng.integers(
            0, 3))) % 4]
        planted = list(truth)
        for p in planted_pos:
            planted[p] = other(truth[p])
        planted = "".join(planted)
        ref2 = os.path.join(d, "planted.fasta")
        write_fasta(ref2, {"synthref": planted})
        muts = sorted([(int(p), planted[p], truth[p]) for p in planted_pos]
                      + [(int(p), planted[p], other(planted[p]))
                         for p in corrupt_pos])
        mf = _write_lines(os.path.join(d, "muts.txt"),
                          ["{} {} {}".format(*m) for m in muts])
        vf = os.path.join(d, "variants.fasta")
        write_fasta(vf, {"truth": truth,
                         "mutated5": mutate_seq(rng, truth, 0.05)})
        dev = ["-p", conf, "--device", "cuda"]

        _reset_launches()
        region_a = "synthref:2000:3000"
        with largest_launches() as kept:
            wall_m, out_m = _captured(["variant", ref2, bam, reads, "-m",
                                       mf, "-r", "synthref:0:5000", *dev])
            wall_a, out_a = _captured(["variant", fasta, bam, reads, "-a",
                                       "-r", region_a, *dev])
            wall_f, out_f = _captured(["variant", ref2, bam, reads, "-f",
                                       vf, "-r", "synthref:0:5000", *dev])
            # -f scored through pipeline.variant (the CLI, as the JAX
            # CLI, skips every region of a -f run)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                fscores = pipeline.variant(
                    ref2, bam, reads, vf, [], "synthref:0:5000",
                    dict(load_params(conf), end_trim=0), 0,
                    engine=TorchEngine("cuda"))
            torch.cuda.synchronize()
            wall_fp = time.perf_counter() - t0
        launches = _launches()
        held, times = hold_path_launches(kept, "variant")

        params = load_params(conf)
        pa = load_aligned_events(fasta, bam, reads, RegionInfo(region_a),
                                 dict(params, verbose=0))
        data = AlignData.from_session(pa)
        data.params.scoring_width = int(params["point_width"])
        n_points = len(find_point_mutations(data))
    finally:
        shutil.rmtree(d, ignore_errors=True)

    scores = {}
    for line in out_m.splitlines():
        start, orig, mut, score = line.split("\t")
        scores[(int(start), orig, mut)] = float(score)
    if sorted(scores) != muts:
        fail(f"variant -m: {len(scores)} score lines for {len(muts)} "
             "mutations")
    revert = [scores[k] for k in scores if k[0] in planted_pos]
    corrupt = [scores[k] for k in scores if k[0] in corrupt_pos]
    lines_a = [l for l in out_a.splitlines() if l.strip()]
    print(f"[variant] 5 kb, 25 reads of 1.2 kb, widths 300/100/20: -m "
          f"{len(muts)} "
          f"mutations {wall_m:.2f} s (reverting min {min(revert):.3f}, "
          f"corrupting max {max(corrupt):.3f}); -a {region_a} "
          f"{len(lines_a)} lines for {n_points} point mutations "
          f"{wall_a:.2f} s; -f (the CLI) {len(out_f)} bytes of output "
          f"{wall_f:.2f} s; -f (pipeline.variant) truth "
          f"{fscores.get('truth')} vs 5 %-mutated {fscores.get('mutated5')} "
          f"{wall_fp:.2f} s; launches {launches}; "
          f"{held} | {gpu_line()}", flush=True)
    if min(revert) <= 0 or max(corrupt) >= 0:
        fail("variant -m: a reverting mutation scored <= 0 or a corrupting "
             "one >= 0")
    if len(lines_a) != n_points:
        fail(f"variant -a: {len(lines_a)} lines, {n_points} point mutations")
    if out_f:
        fail(f"variant -f: the CLI printed {out_f[:200]!r}; the JAX CLI "
             "prints nothing for -f")
    if not fscores.get("truth", -np.inf) > fscores.get("mutated5", np.inf):
        fail(f"variant -f (pipeline.variant): scores {fscores}")
    _need_launches("variant", launches, SCORE_KERNELS)
    return launches, times


def phase_train(seed: int):
    """5: `train -i 1` on one 1 kb region at 10X: 16 candidates of 10
    reps in one lockstep batch."""
    import inspect

    from poreseq_tpu_torch import pipeline
    from poreseq_tpu_torch.core.params import PACKAGED_DEFAULTS, load_params
    from poreseq_tpu_torch.sim import write_run
    from poreseq_tpu_torch import cli

    _fast5_io()
    d = tempfile.mkdtemp(prefix="psq_smoke_train_")
    cwd = os.getcwd()
    real = pipeline.train_candidates
    default_reps = inspect.signature(real).parameters["reps"].default
    batches = []

    def recorded(*a, **kw):
        batches.append((len(a[4]), kw.get("reps", default_reps)))
        return real(*a, **kw)

    try:
        _, _, reads, bam, fasta = write_run(
            d, np.random.default_rng(seed + 5), ref_len=1000, n_reads=5,
            draft_error=0.0)
        conf = _write_lines(os.path.join(d, "train.conf"), [
            CONF_WIDTHS.strip()] + ["{} = {}".format(k, v) for k, v in
                                    PACKAGED_DEFAULTS.items()
                                    if k[-2:] in ("_t", "_c")])
        random.seed(seed)
        pipeline.train_candidates = recorded
        os.chdir(d)
        err = io.StringIO()
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), largest_launches() as kept:
            cli.main(["train", fasta, bam, reads, "-i", "1", "-p", conf,
                      "-r", "synthref:0:1000", "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = _launches()
        held, times = hold_path_launches(kept, "train")
        n_trans = _transition_sets(kept["fill fwd"][0])
        best = (load_params("train_best.conf")
                if os.path.isfile("train_best.conf") else {})
    finally:
        pipeline.train_candidates = real
        os.chdir(cwd)
        shutil.rmtree(d, ignore_errors=True)
    acc = [float(l.split(":")[1]) for l in err.getvalue().splitlines()
           if l.startswith("Best at iter 1:")]
    print(f"[train] train -i 1, 1 kb at 10X, widths 300/100/20: candidate "
          f"batches (count, reps) {batches}, best accuracy "
          f"{acc[0] if acc else None}%, wall {wall:.2f} s, launches "
          f"{launches}; {held}, the fill's rows carry {n_trans} transition "
          f"sets | {gpu_line()}", flush=True)
    if n_trans < 16:
        fail(f"train: the held fill carries {n_trans} transition sets, "
             "not the 16 candidates'")
    if batches != [(16, 10)]:
        fail(f"train: candidate batches {batches}, expected [(16, 10)]")
    tc = {k: v for k, v in best.items() if k[-2:] in ("_t", "_c")}
    if len(tc) != 8 or min(tc.values()) <= 0:
        fail(f"train: train_best.conf holds {best}")
    if not acc or acc[0] < 98.0:
        fail(f"train: best accuracy {acc} < 98.0%")
    _need_launches("train", launches)
    return launches, times


_CHILD = """
import json, sys
import chip_smoke
chip_smoke._fast5_io()
from poreseq_tpu_torch import cli
cli.main(sys.argv[1:])
print(json.dumps(chip_smoke._launches()))
"""


def phase_multihost(seed: int):
    """6: two processes on the one card deal 4 regions through
    `consensus --coordinator`; each shard equals a single-process run of
    its regions."""
    import torch

    from poreseq_tpu_torch import cli

    _fast5_io()
    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix="psq_smoke_mh_")
    procs = []
    try:
        _, fasta, bam, reads, conf, regions = _e2e_run(d, seed)
        rf = _write_lines(os.path.join(d, "regions.txt"), regions[:4])
        args = ["consensus", fasta, bam, reads, "-R", rf, "-p", conf, "-i",
                "4", "--region-batch", "2", "--device", "cuda"]
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        multi = os.path.join(d, "multi.fasta")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, *args, "-o", multi,
             "--coordinator", "127.0.0.1:{}".format(port),
             "--num-processes", "2", "--process-id", str(p)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for p in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
        wall_mh = time.perf_counter() - t0
        for p, (out, err) in zip(procs, outs):
            if p.returncode != 0:
                fail(f"multihost: a process exited {p.returncode}:\n"
                     f"{err[-3000:]}")
        child = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        launches = {k: sum(c[k] for c in child) for k in child[0]}
        walls, same = [], []
        for p in range(2):
            single = os.path.join(d, "single{}.fasta".format(p))
            t0 = time.perf_counter()
            cli.main([*args, "-o", single, "--shard-index", str(p),
                      "--num-shards", "2"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            with open(single, "rb") as a, open(f"{multi}.p{p}", "rb") as b:
                sa, sb = a.read(), b.read()
            same.append(sa == sb and sa.count(b">") == 2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(d, ignore_errors=True)
    print(f"[multihost] consensus --coordinator, 2 processes on one card, "
          f"4 x 1 kb at 10X, --region-batch 2 -i 4: wall {wall_mh:.2f} s "
          f"(processes started to both done); single-process shard runs "
          f"{walls[0]:.2f} s, {walls[1]:.2f} s; OUTPUT.pN byte-equal to "
          f"its shard run: {same}; launches in the two processes "
          f"{[c for c in child]} | {gpu_line()}", flush=True)
    if not all(same):
        fail(f"multihost: OUTPUT.pN equal to the single-process runs: {same}")
    for c in child:
        _need_launches("multihost", c)
    return launches


def _refine_totals(engine, regions):
    """The Refine call of phase 2's 8 regions (a copy, realigned in place)
    on ``engine``, on the host's scoring geometry: totals [G, P] per class,
    and the call's wall (closed by a synchronize)."""
    import copy

    import torch

    from poreseq_tpu_torch.engine.mutscore import (group_launches,
                                                   group_totals,
                                                   group_totals_sharded)

    datas, mlists = copy.deepcopy(regions)
    run = group_totals if engine.mesh is None else group_totals_sharded
    t0 = time.perf_counter()
    out = [run(*args) for _, _, args in group_launches(
        engine, datas, mlists, [True] * len(datas), host_geometry=True)]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_mesh(seed: int, e2e: dict, e2e_launches: dict):
    """7: phase 3's consensus on a 2x2 ev x mut mesh of the one card, then
    one sharded Refine call against the single-device call."""
    import torch

    from poreseq_tpu_torch import pipeline
    from poreseq_tpu_torch.core.params import load_params
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.parallel.mesh import make_mesh

    _fast5_io()
    card = [torch.device("cuda:0")] * 4
    mesh = make_mesh(2, 2, card)
    engine = TorchEngine("cuda", torch.float32, mesh=mesh)
    d = tempfile.mkdtemp(prefix="psq_smoke_mesh_")
    try:
        truth, fasta, bam, reads, conf, regions = _e2e_run(d, seed)
        params = dict(load_params(conf), verbose=0)
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with engine_seconds() as secs:
            results = pipeline.mutate_many(fasta, bam, reads, regions,
                                           params=params, verbose=0, reps=4,
                                           engine=engine)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _launches()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if any(r is None for r in results):
        fail(f"mesh: {sum(r is None for r in results)} regions skipped")
    seqs = dict(zip(regions, (r[0] for r in results)))
    accs = _accuracies(seqs, truth)
    acc = float(np.mean(accs))
    differ = sum(seqs[n] != e2e["seqs"].get(n) for n in regions)
    shards = mesh.shard_launches()
    missing = [(sh, k) for sh, n in shards.items() for k in ALIGN_KERNELS
               if n.get(k, 0) <= 0]

    # one Refine call, sharded vs single device, on the same operands
    refine = _mut_regions(seed)["refine"]
    held, walls = {}, {}
    for dt in (torch.float64, torch.float32):
        single, w1 = _refine_totals(TorchEngine("cuda", dt), refine)
        sharded, w2 = _refine_totals(
            TorchEngine("cuda", dt, mesh=make_mesh(2, 2, card)), refine)
        if len(single) != len(sharded) or not all(
                torch.equal(a, b) for a, b in zip(single, sharded)):
            fail(f"mesh: the sharded Refine call's totals differ from the "
                 f"single device's ({dt})")
        held[dt] = sum(a.shape[0] for a in single)
        walls[dt] = (w1, w2)
    print(f"[mesh] consensus {E2E_REGIONS} x 1 kb at 10X on a 2x2 mesh of "
          f"cuda:0, widths 300/100/20, -i 4, 8 regions a batch: wall "
          f"{wall:.2f} s (phase 3 {e2e['wall']:.2f} s), mean accuracy "
          f"{acc:.3f}% (min {min(accs):.3f}%; phase 3 {e2e['acc']:.3f}%), "
          f"{differ} of {len(regions)} regions differ from phase 3's FASTA, "
          f"launches {launches} (phase 3 {e2e_launches}), engine host "
          f"seconds (calls, s) "
          f"{ {m: (n, round(t, 3)) for m, (n, t) in secs.items()} } (phase 3 "
          f"{ {m: (n, round(t, 3)) for m, (n, t) in e2e['secs'].items()} }), "
          f"per shard "
          f"{ {f'{i}x{j}': n for (i, j), n in shards.items()} }, peak "
          f"device memory {peak / 2**20:.1f} MiB (phase 3 "
          f"{e2e['peak'] / 2**20:.1f} MiB); Refine call of phase 2's 8 "
          f"regions: sharded totals equal the single device's over "
          f"{held[torch.float64]} / {held[torch.float32]} groups (f64 / "
          f"f32), walls single / mesh f64 "
          f"{walls[torch.float64][0]:.2f} / {walls[torch.float64][1]:.2f} s, "
          f"f32 {walls[torch.float32][0]:.2f} / "
          f"{walls[torch.float32][1]:.2f} s | {gpu_line()}", flush=True)
    if missing:
        fail(f"mesh: shards that never launched a kernel: {missing}")
    if acc < 99.0:
        fail(f"mesh mean accuracy {acc:.3f}% < 99.0%")
    # a mesh takes the scoring geometry from the host
    _need_launches("mesh", launches, [k for k in launches if k != "geom"])
    return launches


# ---------------------------------------------------------------------------
# phase 8: f32_equiv, the card engines' decisions against the exact oracle
# ---------------------------------------------------------------------------

EQUIV_STEPS = ("phase1", "viterbi", "refine")
EQUIV_REF_LEN = 1000


def _equiv_case(i: int) -> tuple:
    """Region i of scripts/f32_equiv.py: (seed, coverage, draft error)."""
    return 1000 + 37 * i, 8 + (i % 3) * 2, (0.02, 0.03, 0.05)[i % 3]


def _equiv_session(i: int, **engine):
    from poreseq_tpu_torch.sim import simulate_session

    seed, cov, derr = _equiv_case(i)
    return simulate_session(np.random.default_rng(seed),
                            ref_len=EQUIV_REF_LEN, coverage=cov,
                            draft_error=derr,
                            params=dict(P_WIDTHS, verbose=0), **engine)


def _equiv_exact(i: int) -> dict:
    """Region i on the exact engine, in a spawned worker: its sequence and
    accuracy after each step, the Viterbi candidates (libc rand() seeded
    with the region's seed, so the phase repeats) and its wall."""
    from poreseq_tpu_torch.api import swalign
    from poreseq_tpu_torch.engine import _native
    from poreseq_tpu_torch.engine.types import AlignData

    t0 = time.perf_counter()
    pa, truth = _equiv_session(i, backend="exact")
    seqs = []
    pa.Mutate(reps=2)
    seqs.append(pa.sequence)
    _native.srand(_equiv_case(i)[0])
    cands = pa.engine.viterbi_mutate(AlignData.from_session(pa).events, 16,
                                     0.05, 0.01, 0.33, 0.75)
    pa.Mutate(seqs=list(cands), reps=2)
    seqs.append(pa.sequence)
    pa.Refine()
    seqs.append(pa.sequence)
    return dict(seqs=seqs, cands=list(cands),
                accs=[swalign(s, truth)[0] for s in seqs],
                wall=time.perf_counter() - t0)


def phase_f32_equiv(n: int):
    """8: scripts/f32_equiv.py's protocol on the card at production widths:
    n regions, each through Mutate(reps=2) on its reads, Mutate(reps=2) on
    the exact engine's 16 Viterbi candidates and Refine, on the exact
    engine and on TorchEngine f32 and f64.  A card engine's comparison of a
    region ends at its first step whose sequence differs from the exact
    engine's; the region is degraded when its accuracy there is 0.5 points
    or more from the exact engine's, or below 99 %.  The exact side of
    every region runs in a spawned process pool while the card engines run
    their first step."""
    import multiprocessing

    import torch

    from poreseq_tpu_torch.api import swalign
    from poreseq_tpu_torch.engine import TorchEngine

    engines = {"f32": TorchEngine("cuda", torch.float32),
               "f64": TorchEngine("cuda", torch.float64)}
    walls = dict.fromkeys(engines, 0.0)

    def step(name, pa, method, *args):
        t0 = time.perf_counter()
        getattr(pa, method)(*args)
        torch.cuda.synchronize()
        walls[name] += time.perf_counter() - t0
        return pa.sequence

    _reset_launches()
    t_phase = time.perf_counter()
    runs = {}
    with multiprocessing.get_context("spawn").Pool(
            min(n, os.cpu_count() or 1)) as pool:
        pending = pool.map_async(_equiv_exact, range(n))
        for name, eng in engines.items():
            for i in range(n):
                pa, truth = _equiv_session(i, engine=eng)
                runs[name, i] = (pa, truth, [step(name, pa, "Mutate", "self",
                                                  2)])
        exact = pending.get(timeout=900)
    stats = {name: dict.fromkeys(
        [f"{s}_div" for s in EQUIV_STEPS] + ["degraded"], 0)
        for name in engines}
    regions = []
    for i, ex in enumerate(exact):
        row = dict(case=_equiv_case(i), acc_exact=ex["accs"][-1])
        for name in engines:
            pa, truth, seqs = runs[name, i]
            for k, s in enumerate(EQUIV_STEPS):
                if k == 1:
                    seqs.append(step(name, pa, "Mutate", list(ex["cands"]),
                                     2))
                elif k == 2:
                    seqs.append(step(name, pa, "Refine"))
                if seqs[k] != ex["seqs"][k]:
                    break
            else:
                row[name] = dict(diverged=None, acc=ex["accs"][-1])
                continue
            acc = swalign(seqs[k], truth)[0]
            bad = abs(acc - ex["accs"][k]) >= 0.5 or acc < 99.0
            stats[name][f"{s}_div"] += 1
            stats[name]["degraded"] += int(bad)
            row[name] = dict(diverged=s, acc=acc,
                             acc_exact_there=ex["accs"][k], degraded=bad)
        regions.append(row)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    launches = _launches()
    print("[f32_equiv] " + json.dumps(dict(
        regions_n=n, ref_len=EQUIV_REF_LEN, widths=P_WIDTHS, stats=stats,
        regions=regions, engine_wall_s=dict(
            walls, exact=sum(ex["wall"] for ex in exact)),
        phase_wall_s=wall, launches=launches, card=gpu_line())), flush=True)
    for name, st in stats.items():
        if st["degraded"]:
            fail(f"f32_equiv: {st['degraded']} of {n} regions degraded on "
                 f"TorchEngine {name}")
    _need_launches("f32_equiv", launches, SCORE_KERNELS + ("likes",))
    return launches


# why each kernel's library_ms is null
LIBRARY_NOTE = {
    "fill": "no single PyTorch call computes a banded max-plus pair-HMM fill",
    "mutscore": "no single PyTorch call computes a group refill and join",
    "backtrace": "no single PyTorch call computes a best-path walk",
    "viterbi_sweep": "no single PyTorch call computes a recursion over "
                     "positions (a max-plus and a sum-product step per row)",
    "viterbi_sample": "no single PyTorch call computes a chain of "
                      "categorical draws, each conditioned on the last",
    "viterbi_gumbel": "no single PyTorch call draws JAX's threefry2x32 "
                      "Gumbel noise (torch.rand draws Philox bits)",
    "viterbi_obs": "no single PyTorch call computes a trimmed mean over "
                   "events (torch.sort then a masked sum is several calls)",
    "likes": "no single PyTorch call computes the last anchored value at "
             "each reference index (two cummax, a searchsorted, gathers)",
    "geom": "no single PyTorch call computes update_refs' interpolation, "
            "a band placement and its rate limit",
    "windows": "no single PyTorch call gathers windows with pad values "
               "outside the event (a gather, a clamp and a where)",
}

# (seed, k, i) -> the row key fold_in(split(PRNGKey(seed), nk)[k], i), and
# (row key, s) -> state s's 32-bit word y0 ^ y1 and 64-bit word y0 << 32 |
# y1 of threefry2x32(row key, (0, s)), computed with JAX as
# tests/test_torch_prng.py pins them on the CPU
PINNED_KEYS = [((0, 0, 0), (4165894930, 804218099)),
               ((0, 15, 959), (1113189882, 2059144140)),
               ((7, 3, 99999), (4078193910, 4255733508)),
               ((2 ** 32 + 7, 5, 2 ** 31 - 1), (2330131653, 608189605))]
PINNED_WORDS = [((4165894930, 804218099), 0, 1214273199,
                 2933590336990503537),
                ((4165894930, 804218099), 511, 2782833415,
                 2631028836633797070),
                ((1113189882, 2059144140), 0, 168515629,
                 3676334643026570956),
                ((1113189882, 2059144140), 1023, 937218459,
                 11934964057838015240),
                ((4078193910, 4255733508), 0, 2224344565,
                 14285235530272315378),
                ((4078193910, 4255733508), 1023, 4001996215,
                 17772188034002510700)]


# phase 9's params file: phase 3's with realign width 700 and scoring width
# 600 (W = 1401, Ws = 1201: the fill and the group scorer two rows a thread)
WIDE_CONF = (CONF_WIDTHS
             .replace("realign_width = 300", "realign_width = 700")
             .replace("scoring_width = 100", "scoring_width = 600"))
# phase 9's second run: phase 3's first polished region alone at widths
# 2048/2048/20 (W = Ws = 4097: the fill's cluster instance, the group
# scorer's wide one), -i 4 --region-batch 1, f32 (cut: one region of phase
# 3's 8);
# its largest fills held on their first SCAN_HOLD_ROWS active rows, its
# largest Ws = 4097 scorer launch on its first HOLD_GROUPS groups.  Phase
# 3's first region (synthref:0:1000) has 2 reads, under the pipeline's
# minimum of 5 events, so it is returned unpolished and launches nothing:
# the run takes the second (14 reads)
SCAN_WIDE_CONF = (CONF_WIDTHS
                  .replace("realign_width = 300", "realign_width = 2048")
                  .replace("scoring_width = 100", "scoring_width = 2048"))
SCAN_WIDE_REGION_INDEX = 1
SCAN_HOLD_ROWS = 8


def phase_wide(seed: int, e2e: dict):
    """9: phase 3's consensus (the same run, -i 4 --region-batch 8, f32)
    at widths 700/600/20 from its params file: accuracy, launches, peak
    memory, and its largest forward and backward fill and each window
    width's largest group-scorer launch held to the twins."""
    import torch

    from poreseq_tpu_torch.io.fasta import read_fasta
    from poreseq_tpu_torch import cli

    _fast5_io()
    t_phase = time.perf_counter()
    W = 2 * WIDE_WIDTHS["realign_width"] + 1
    Ws = 2 * WIDE_WIDTHS["scoring_width"] + 1
    d = tempfile.mkdtemp(prefix="psq_smoke_wide_")
    try:
        truth, fasta, bam, reads_dir, conf, regions = _e2e_run(d, seed,
                                                               WIDE_CONF)
        rf = _write_lines(os.path.join(d, "regions.txt"), regions)
        out = os.path.join(d, "out.fasta")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with largest_launches(by_width=True) as kept:
            cli.main(["consensus", fasta, bam, reads_dir, "-R", rf, "-p",
                      conf, "-o", out, "-i", "4", "--region-batch", "8",
                      "--device", "cuda"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _launches()
        seqs = read_fasta(out)
        accs = _accuracies(seqs, truth)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if len(seqs) != E2E_REGIONS:
        fail(f"wide: {len(seqs)} output records, expected {E2E_REGIONS}")
    widths = {k: kept[k][7] for k in ("fill fwd", "fill bwd") if k in kept}
    if set(widths.values()) != {W} or f"mutscore Ws={Ws}" not in kept:
        fail(f"wide: the path's largest launches are at fill widths "
             f"{widths} and window widths "
             f"{sorted(k for k in kept if k.startswith('mutscore'))}, not "
             f"W={W} and Ws={Ws}")
    held, times = hold_path_launches(kept, "wide")
    acc = float(np.mean(accs))
    print(f"[wide] consensus {E2E_REGIONS} x 1 kb (phase 3's run), widths "
          f"700/600/20 (W={W}, Ws={Ws}) from the params file, -i 4 "
          f"--region-batch 8: wall {wall:.2f} s (phase 3 {e2e['wall']:.2f} "
          f"s), mean accuracy {acc:.3f}% (min {min(accs):.3f}%; phase 3 "
          f"{e2e['acc']:.3f}%), launches {launches}, peak device memory "
          f"{peak / 2**20:.1f} MiB (phase 3 {e2e['peak'] / 2**20:.1f} MiB); "
          f"{held}; phase wall {time.perf_counter() - t_phase:.1f} s | "
          f"{gpu_line()}", flush=True)
    if acc < 99.0:
        fail(f"wide mean accuracy {acc:.3f}% < 99.0%")
    _need_launches("wide", launches)
    launches2, times2 = _scan_wide_run(seed, e2e)
    return ({k: launches[k] + launches2[k] for k in launches},
            {**times, **times2})


def _scan_wide_run(seed: int, e2e: dict):
    """Phase 9's second run (SCAN_WIDE_CONF): phase 3's first polished
    region alone through the CLI at W = Ws = 4097; it must launch the
    fill's instance there (fill_instance: the cluster instance) and the
    group scorer's (group_instance at its largest launch) and come within
    0.5 points of that region's accuracy in phase 3; its launches by
    instance are printed.  Its largest forward and backward fill
    (the first SCAN_HOLD_ROWS active rows) and its largest Ws = 4097 scorer
    launch (the first HOLD_GROUPS groups) are held to the twins and timed.
    Returns (launches, {held key: timing})."""
    import torch

    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.engine.fill import FILL, fill_cuda, fill_instance
    from poreseq_tpu_torch.engine.mutscore import (MUTSCORE, group_instance,
                                                   group_totals_cuda)
    from poreseq_tpu_torch.engine.roofline import fill_work, group_work
    from poreseq_tpu_torch.io.fasta import read_fasta

    t_run = time.perf_counter()
    W = 2 * 2048 + 1
    d = tempfile.mkdtemp(prefix="psq_smoke_scan_wide_")
    try:
        truth, fasta, bam, reads_dir, conf, regions = _e2e_run(
            d, seed, SCAN_WIDE_CONF)
        region = regions[SCAN_WIDE_REGION_INDEX]
        out = os.path.join(d, "out.fasta")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with largest_launches(by_width=True) as kept:
            cli.main(["consensus", fasta, bam, reads_dir, "-r", region, "-p",
                      conf, "-o", out, "-i", "4", "--region-batch", "1",
                      "--device", "cuda"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _launches()
        instances = {k.name: dict(k.instances) for k in (FILL, MUTSCORE)}
        seqs = read_fasta(out)
        acc = _accuracies(seqs, truth)[0] if region in seqs else 0.0
        acc3 = _accuracies({region: e2e["seqs"][region]}, truth)[0]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if list(seqs) != [region]:
        fail(f"wide W={W}: output records {list(seqs)}, expected {region}")
    key = f"mutscore Ws={W}"
    if {kept[k][7] for k in ("fill fwd", "fill bwd") if k in kept} != {W} \
            or key not in kept:
        fail(f"wide W={W}: no fill at W={W} or scorer launch at Ws={W} "
             f"was kept: {sorted(kept)}")
    t0 = time.perf_counter()
    errs, held, times = {}, {}, {}
    for k in ("fill fwd", "fill bwd"):
        x = kept[k]
        rows = torch.nonzero(x[0].active).flatten()[:SCAN_HOLD_ROWS]
        a = _rows(x, rows)
        errs[k] = hold_fill(a, f"wide W={W}")
        held[k] = f"{k} C={x[1].shape[0]} E={x[1].shape[1]}: rows " \
                  f"{rows.tolist()}"
        times[f"{k} W={W}"] = dict(
            timed(event_ms(lambda: fill_cuda(*a)),
                  fill_work(a[0], a[1], a[4], a[7], a[8]), a[0].mean.dtype),
            E=len(rows), C=x[1].shape[0])
    x = kept[key]
    G = x[13]["g_start"].shape[0]
    a = _groups(x, HOLD_GROUPS)
    errs[key] = hold_mutscore(a, f"wide W={W}")
    held[key] = (f"{key} C={x[1].shape[0]} E={x[1].shape[1]}: the first "
                 f"{min(G, HOLD_GROUPS)} of {G} groups")
    times[f"{key} (W={W})"] = dict(
        timed(event_ms(lambda: group_totals_cuda(*a)), group_work(*a),
              a[1].dtype), G=min(G, HOLD_GROUPS), C=x[1].shape[0],
        E=x[1].shape[1])
    hold_s = time.perf_counter() - t0
    print(f"[wide] consensus of phase 3's {region} alone (its first "
          f"polished region; cut: 1 of {E2E_REGIONS} regions), widths "
          f"2048/2048/20 (W = Ws = {W}) from "
          f"the params file, -i 4 --region-batch 1, f32: wall {wall:.2f} s, "
          f"accuracy {acc:.3f}% (phase 3 {acc3:.3f}%), launches {launches}, "
          f"by instance {instances}, peak device memory "
          f"{peak / 2**20:.1f} MiB; held to the twins ({hold_s:.1f} s): "
          + "; ".join(f"{held[k]} max |diff| {errs[k]:.3e}" for k in held)
          + "; timed: " + "; ".join(f"{k} {_timing(v)}"
                                    for k, v in times.items())
          + f"; run wall {time.perf_counter() - t_run:.1f} s | "
          f"{gpu_line()}", flush=True)
    routed = {fill_instance(W, kept[k][1].shape[1], torch.float32)
              for k in ("fill fwd", "fill bwd")}
    scorer = group_instance(W, G * x[21], torch.float32)
    if not (all(instances["fill"].get(r) for r in routed)
            and instances["mutscore"].get(scorer)):
        fail(f"wide W={W}: the fill's instances past the register-held scan "
             f"({routed}) or the scorer's ({scorer}, its largest launch's "
             f"route) were not launched: {instances}")
    if acc < acc3 - 0.5:
        fail(f"wide W={W}: accuracy {acc:.3f}% more than 0.5 points below "
             f"phase 3's {acc3:.3f}%")
    _need_launches(f"wide W={W}", launches)
    return launches, times


# ---------------------------------------------------------------------------
# phase 10: genome, tools/genome_run.py's split -> consensus -> merge
# ---------------------------------------------------------------------------

# 10a: the JAX README's lambda configuration (48.5 kb at 10X, 8 kb reads
# over 2 kb regions, widths 300/100/20, -i 4 --region-batch 8), cut to its
# first 10 regions dealt over 2 shards: one lockstep batch of 5 a shard
# (cut from 16 for the smoke's time limit when the coverage phase came)
GENOME_2KB = ["sharded", "--genome", "48500", "--region-length", "2000",
              "--read-len", "8000", "--shards", "2", "--limit", "5"]
# 10b: the lambda genome split at the defaults' region length (10 kb: 6
# regions, reads of 10.4 kb), one lockstep batch
GENOME_10KB = ["lambda", "--region-length", "10000"]
# the rows of 10b's held fill launches and the groups of its held scorer
# launch (rows and groups are independent in the fill and the scorer; the
# twins at full size ran the card out of memory at phase 9's widths)
HOLD_ROWS, HOLD_GROUPS = 8, 2048
# 10b's f64 run takes the batch's first 2 regions (cut: the phase ran 541 s
# with all 6 on an H100 at 700 W, against a budget of about 240 s; 3 until
# the coverage phase came, when the holds waited 31.6 s for it); it runs in
# a process of its own while the f32 run's launches are held to their twins
F64_REGIONS = 2
# and its f32 run the first 4 of the 6 (cut for time when the coverage
# phase came: the 6 ran 206.2 s of the smoke's 967.7 s on an H100 at 700 W)
F32_REGIONS = 4


@contextlib.contextmanager
def path_shapes():
    """Inside the block, record what the path's engine calls see: the
    events loaded (how many carry a trim hint, the most levels of one), the
    largest C, E and T of a packed batch, the band widths of the fill's and
    the group scorer's launches with the rows a thread of their instance,
    the geometry's instance with its most levels, and the candidate-scoring
    chunks (score_alignments_multi calls with likes_only).  Yields the
    dict it fills."""
    import inspect
    import threading

    from poreseq_tpu_torch.engine import TorchEngine, fill, mutscore
    from poreseq_tpu_torch.engine.fill import fill_instance
    from poreseq_tpu_torch.io import load

    out = dict(loaded=0, trimmed=0, levels=0, C=0, E=0, T=0, fill=set(),
               scorer=set(), geom=set(), chunks=0)
    lock = threading.Lock()
    real = dict(hint=load._set_trim_hint, prep=TorchEngine._prepare_multi,
                score=TorchEngine.score_alignments_multi,
                fill=fill.fill_cuda, scorer=mutscore.group_totals_cuda,
                geom=mutscore.geom_cuda)

    def hint(ev, *a, **kw):
        real["hint"](ev, *a, **kw)
        with lock:
            out["loaded"] += 1
            out["trimmed"] += ev.trim is not None
            out["levels"] = max(out["levels"], len(ev.mean))

    def prep(self, *a, **kw):
        ctx = real["prep"](self, *a, **kw)
        for k, v in (("C", ctx["C"]), ("E", ctx["E"]),
                     ("T", ctx["arrays"]["mean"].shape[1])):
            out[k] = max(out[k], int(v))
        return ctx

    def score(self, *a, **kw):
        out["chunks"] += bool(kw.get("likes_only"))
        return real["score"](self, *a, **kw)

    def instance(fn, what, width):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            b = sig.bind(*a, **kw)
            out[what].add(width(b.arguments))
            return fn(*a, **kw)
        return wrapped

    def geom_instance(a):
        T = a["ral"].shape[1]
        name, ctas = a.get("instance") or mutscore.geom_instance(
            T, int((a["n0"] > 0).sum()), a["ral"].dtype)
        return (f"{name}{f' of {ctas} CTAs' if ctas else ''} (T {T}, cap "
                f"{mutscore.GEOM_MAX_LEVELS[a['ral'].dtype]})")

    load._set_trim_hint = hint
    TorchEngine._prepare_multi, TorchEngine.score_alignments_multi = (prep,
                                                                     score)
    def fill_name(a):
        return a.get("instance") or fill_instance(
            a["W"], a["states"].shape[1], a["batch"].mean.dtype)

    fill.fill_cuda = instance(real["fill"], "fill", lambda a: (
        f"W={a['W']} ({fill_name(a)})"))
    mutscore.group_totals_cuda = instance(real["scorer"], "scorer", lambda a: (
        f"Ws={a['Ws']} ({a.get('instance') or mutscore.group_instance(
            a['Ws'], a['gp']['g_start'].shape[0] * a['E_g'],
            a['Mf'].dtype)})"))
    mutscore.geom_cuda = instance(real["geom"], "geom", geom_instance)
    try:
        yield out
    finally:
        load._set_trim_hint = real["hint"]
        TorchEngine._prepare_multi = real["prep"]
        TorchEngine.score_alignments_multi = real["score"]
        fill.fill_cuda, mutscore.group_totals_cuda, mutscore.geom_cuda = (
            real["fill"], real["scorer"], real["geom"])


def _shapes(sh: dict) -> str:
    return (f"largest C {sh['C']}, E {sh['E']}, T {sh['T']}; fill "
            f"{sorted(sh['fill'])}, scorer {sorted(sh['scorer'])}, geometry "
            f"{sorted(sh['geom'])}; {sh['chunks']} candidate-scoring chunks")


def _rows(args, rows):
    """A fill launch's operands (fill_cuda's arguments) cut to the event
    rows `rows`."""
    from poreseq_tpu_torch.engine.dp import EventBatch

    batch, states, i0, i1, pad, *rest = args
    return (EventBatch(*(x[rows] for x in batch)), states[:, rows].contiguous(),
            i0[rows].contiguous(), i1[rows].contiguous(),
            pad[:, rows].contiguous(), *rest)


def _groups(args, n: int):
    """A group-scorer launch's operands cut to its first n groups."""
    return (*args[:13], {k: v[:n] for k, v in args[13].items()}, *args[14:])


def time_largest(kept: dict, seed: int) -> dict:
    """Each kernel's largest launch of a path (largest_launches(every=True))
    timed on the card in f32 beside its least time: {name:
    timing}; the Gumbel kernel at the largest sampler call's shape."""
    from types import SimpleNamespace

    from poreseq_tpu_torch.engine import align, fill, mutscore, viterbi
    from poreseq_tpu_torch.engine import roofline as rl

    a = {k: _copied(v, "cuda") for k, v in kept.items()}
    launch = {
        "fill fwd": (fill.fill_cuda, lambda x: rl.fill_work(
            x[0], x[1], x[4], x[7], x[8])),
        "fill bwd": (fill.fill_cuda, lambda x: rl.fill_work(
            x[0], x[1], x[4], x[7], x[8])),
        "mutscore": (mutscore.group_totals_cuda, lambda x: rl.group_work(*x)),
        "backtrace": (align.backtrace_cuda, lambda x: rl.backtrace_work(
            align.backtrace_cuda(*x)[0], x[6], a["backtrace batch"][0],
            x[0].dtype)),
        "likes": (align.likes_cuda, lambda x: rl.likes_work(x[0], x[2])),
        "geom": (mutscore.geom_cuda, lambda x: rl.geom_work(x[0], x[1],
                                                            x[4])),
        "windows": (mutscore.windows_cuda, lambda x: rl.windows_work(
            SimpleNamespace(mean=x[0], n0=a["windows batch"][0],
                            active=a["windows batch"][1]), x[3], x[4])),
        "viterbi_obs": (viterbi.obs_multi_cuda, lambda x: rl.viterbi_obs_work(
            x[0], x[2], x[3])),
        "viterbi_sweep": (viterbi.viterbi_sweep_cuda,
                          lambda x: rl.viterbi_sweep_work(x[0], x[1], x[4])),
        "viterbi_sample": (viterbi.sample_paths_cuda,
                           lambda x: rl.viterbi_sample_work(x[0], x[1],
                                                            x[3])),
    }
    out = {}
    for key, (fn, work) in launch.items():
        if key not in a:
            fail(f"genome: no {key} launch was kept to time")
        x = a[key]
        dt = (x[0].mean.dtype if key.startswith("fill")
              else x[1].dtype if key == "mutscore" else x[0].dtype)
        out[key] = timed(event_ms(lambda: fn(*x)), work(x), dt)
        if key in QUEUED + ("likes",):
            out[key]["queued_ms"] = queued_ms(lambda: fn(*x))
    fwds, valid, _, attens = a["viterbi_sample"][:4]
    nk, R, dt = attens.shape[0], fwds.shape[1], fwds.dtype
    gum = lambda: viterbi.gumbel_cuda(seed, nk, R, dt, fwds.device)
    out["viterbi_gumbel"] = dict(
        timed(event_ms(gum), rl.viterbi_gumbel_work(valid, nk, dt), dt),
        queued_ms=queued_ms(gum))
    return out


def _polish(tool, args, run, **keep) -> dict:
    """The tool's consensus calls (one a shard) with their walls, launches,
    shapes (path_shapes), engine host seconds and peak device memory; keep:
    largest_launches' options (what it kept under "kept")."""
    import torch

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with largest_launches(**keep) as kept, path_shapes() as sh, \
            engine_seconds() as secs:
        outs, walls = tool.consensus(args, run)
    return dict(outs=outs, walls=walls, kept=kept, shapes=sh, secs=secs,
                peak=torch.cuda.max_memory_allocated(), launches=_launches())


def _host_secs(secs: dict) -> dict:
    return {m: (n, round(t, 3)) for m, (n, t) in secs.items()}


def genome_2kb(tool) -> dict:
    """10a: the lambda genome's first 10 of 49 regions of 2 kb with 8 kb
    reads, dealt over 2 shards: one merged contig at >= 99.0 %, trimmed
    events, every kernel launched.  Returns the launches."""
    from poreseq_tpu_torch.io.fasta import read_fasta

    d = tempfile.mkdtemp(prefix="psq_smoke_genome_")
    try:
        args = tool.parse(GENOME_2KB)
        run = tool.build(args, d)
        a = _polish(tool, args, run)
        _, contigs = tool.merge(run, a["outs"])
        end = tool.covered_end(run["regions"])
        acc = tool.merged_accuracy(contigs, run["truth"], end)
        done = sum(len(read_fasta(o)) for o in a["outs"])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    sh = a["shapes"]
    print(f"[genome] 10a lambda-2kb: {args.genome} b at {args.coverage}X, "
          f"{run['n_reads']} reads of {args.read_len} b, the first "
          f"{len(run['regions'])} of {run['regions_total']} regions of "
          f"{args.region_length} b (cut: the region count) over "
          f"{args.shards} shards (--shard-index/--num-shards), widths "
          f"300/100/20, -i 4 --region-batch 8, f32: {done} regions done, "
          f"shard walls {[round(w, 2) for w in a['walls']]} s, merged "
          f"{len(contigs)} contig(s), accuracy {acc:.3f}% over the covered "
          f"{end} b; {sh['trimmed']} of {sh['loaded']} loaded events "
          f"trimmed, batch T {sh['T']} below the reads' {sh['levels']} "
          f"levels; {_shapes(sh)}; launches {a['launches']}, engine host "
          f"seconds (calls, s) {_host_secs(a['secs'])}, peak device memory "
          f"{a['peak'] / 2**20:.1f} MiB | {gpu_line()}", flush=True)
    if len(contigs) != 1:
        fail(f"genome 10a: the merge gave {len(contigs)} contigs, not one")
    if acc < 99.0:
        fail(f"genome 10a: merged accuracy {acc:.3f}% < 99.0%")
    if not sh["trimmed"] or sh["T"] >= sh["levels"]:
        fail(f"genome 10a: {sh['trimmed']} trimmed events, batch T "
             f"{sh['T']} against the reads' {sh['levels']} levels")
    _need_launches("genome 10a", a["launches"])
    return a["launches"]


def _f64_batch(run: dict, regions: list, reps: int) -> dict:
    """10b's f64 run in a spawned process of its own: the regions of the
    run in one lockstep batch through pipeline.mutate_many (the function
    the CLI's consensus calls) on TorchEngine f64, with its wall, shapes
    (path_shapes), engine host seconds, peak device memory, launches
    (counted from 0 in this process) and sequences."""
    import torch

    from poreseq_tpu_torch import pipeline
    from poreseq_tpu_torch.core.params import load_params
    from poreseq_tpu_torch.engine import TorchEngine

    _fast5_io()
    engine = TorchEngine("cuda", torch.float64)
    params = dict(load_params(run["conf"]), verbose=0)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with path_shapes() as sh, engine_seconds() as secs:
        results = pipeline.mutate_many(
            run["fasta"], run["bam"], run["reads"], regions, params=params,
            verbose=0, reps=reps, engine=engine)
        torch.cuda.synchronize()
    return dict(walls=[time.perf_counter() - t0], shapes=sh, secs=secs,
                peak=torch.cuda.max_memory_allocated(), launches=_launches(),
                seqs={r: res[0] for r, res in zip(regions, results)
                      if res is not None})


def genome_10kb(tool, seed: int) -> tuple:
    """10b: the lambda genome's first F32_REGIONS regions of 10 kb in one
    lockstep batch on TorchEngine f32 (the CLI), and its first F64_REGIONS
    of them on f64
    (pipeline.mutate_many, in a spawned process while the f32 run's
    largest fills and scorer launch are held to the twins on a slice):
    each merged at >= 99.0 %, no region degraded in f32, and every
    kernel's largest launch of the f32 run timed once the f64 process has
    ended.  Returns (the f32 and the f64 run's launches, {kernel:
    timing})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from poreseq_tpu_torch.io.fasta import read_fasta, write_fasta

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="psq_smoke_genome_")
    try:
        args = tool.parse(GENOME_10KB)
        run = tool.build(args, d)
        run["regions"] = run["regions"][:F32_REGIONS]
        _write_lines(run["region_file"], run["regions"])
        regions, truth = run["regions"], run["truth"]
        b32 = _polish(tool, args, run, every=True)
        seqs32 = read_fasta(b32["outs"][0])
        _, contigs32 = tool.merge(run, b32["outs"])
        regions64 = regions[:F64_REGIONS]
        # the f32 run's cached blocks go back to the card for the f64
        # process
        torch.cuda.empty_cache()
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            pending = pool.submit(
                _f64_batch, {k: run[k] for k in ("fasta", "bam", "reads",
                                                 "conf")},
                regions64, args.iterations)
            # the held launches: a slice of rows of each fill, a chunk of
            # groups of the scorer (the first HOLD_ROWS active rows; the
            # first HOLD_GROUPS)
            kept = b32["kept"]
            t0 = time.perf_counter()
            errs, held = {}, {}
            for k in ("fill fwd", "fill bwd"):
                x = _copied(kept[k], "cuda")
                rows = torch.nonzero(x[0].active).flatten()[:HOLD_ROWS]
                errs[k] = hold_fill(_rows(x, rows), "genome 10b")
                held[k] = (f"{k} C={x[1].shape[0]} E={x[1].shape[1]} "
                           f"W={x[7]}: rows {rows.tolist()}")
            x = _copied(kept["mutscore"], "cuda")
            G = x[13]["g_start"].shape[0]
            errs["mutscore"] = hold_mutscore(_groups(x, HOLD_GROUPS),
                                             "genome 10b")
            held["mutscore"] = (f"mutscore Ws={x[16]} C={x[1].shape[0]} "
                                f"E={x[1].shape[1]}: the first "
                                f"{min(G, HOLD_GROUPS)} of {G} groups")
            del x
            hold_s = time.perf_counter() - t0
            b64 = pending.result(timeout=900)
        wait_s = time.perf_counter() - t0 - hold_s
        seqs64 = b64["seqs"]
        f64_out = os.path.join(d, "out.f64.fasta")
        write_fasta(f64_out, seqs64)
        _, contigs64 = tool.merge(run, [f64_out], "merged.f64.fasta")
        merged = {n: tool.merged_accuracy(c, truth, tool.covered_end(r))
                  for n, c, r in (("f32", contigs32, regions),
                                  ("f64", contigs64, regions64))}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    accs32 = dict(zip(seqs32, _accuracies(seqs32, truth)))
    accs64 = dict(zip(seqs64, _accuracies(seqs64, truth)))
    both = [r for r in regions if r in seqs32 and r in seqs64]
    differ = sum(seqs32[r] != seqs64[r] for r in both)
    degraded = [r for r in both
                if accs32[r] <= accs64[r] - 0.5 or accs32[r] < 99.0]
    times = time_largest(kept, seed)
    for name, run_, todo in (("f32", b32, regions), ("f64", b64, regions64)):
        accs = accs32 if name == "f32" else accs64
        print(f"[genome] 10b long-10kb {name}"
              + (" (the CLI)" if name == "f32" else
                 " (pipeline.mutate_many, a process of its own beside the "
                 "holds)")
              + f": {len(todo)} regions of {args.region_length} b"
              + f" (cut: the first {len(todo)} of {run['regions_total']})"
              + f", reads "
              f"of {args.read_len} b, one lockstep batch, widths "
              f"300/100/20, -i 4: wall {sum(run_['walls']):.2f} s"
              + (f" (of which {run_['kept']['host copy s']:.2f} s copying "
                 "the largest launches' operands to the host)"
                 if name == "f32" else "")
              + f", {len(accs)} regions done, mean accuracy "
              f"{float(np.mean(list(accs.values()))):.3f}% (min "
              f"{min(accs.values()):.3f}%), merged {merged[name]:.3f}%; "
              f"{run_['shapes']['trimmed']} of {run_['shapes']['loaded']} "
              f"events trimmed; {_shapes(run_['shapes'])}; launches "
              f"{run_['launches']}, engine host seconds (calls, s) "
              f"{_host_secs(run_['secs'])}, peak device memory "
              f"{run_['peak'] / 2**20:.1f} MiB | {gpu_line()}", flush=True)
    print(f"[genome] 10b f32 against f64: {differ} of {len(both)} regions "
          f"differ, {len(degraded)} degraded {degraded}; held to the twins "
          f"({time.perf_counter() - t0:.1f} s: holds {hold_s:.1f} s, then "
          f"{wait_s:.1f} s waiting for the f64 process): "
          + "; ".join(f"{held[k]} max |diff| {errs[k]:.3e}" for k in held)
          + "; largest launches timed (f32): "
          + "; ".join(f"{k} {_timing(v)}"
                      + (f", queued {v['queued_ms']:.4f} ms"
                         if "queued_ms" in v else "")
                      for k, v in times.items())
          + f"; 10b wall {time.perf_counter() - t_phase:.1f} s | "
          f"{gpu_line()}", flush=True)
    for name, accs, todo in (("f32", accs32, regions),
                             ("f64", accs64, regions64)):
        if len(accs) != len(todo):
            fail(f"genome 10b: {name} did {len(accs)} of {len(todo)} "
                 "regions")
        if merged[name] < 99.0:
            fail(f"genome 10b: {name} merged accuracy {merged[name]:.3f}% "
                 "< 99.0%")
    if degraded:
        fail(f"genome 10b: {len(degraded)} regions degraded in f32: "
             f"{degraded}")
    _need_launches("genome 10b f32", b32["launches"])
    # f64 takes the scoring geometry from the host, as the JAX engine does
    _need_launches("genome 10b f64", b64["launches"],
                   [k for k in b64["launches"] if k != "geom"])
    return (b32["launches"], b64["launches"]), times


def phase_genome(seed: int):
    """10: the genome-scale path through tools/genome_run.py's functions
    (write_run, the CLI's split, consensus per shard and merge): 10a
    (genome_2kb) then 10b (genome_10kb).  Returns (the launches of its runs
    summed, 10b's {kernel: timing})."""
    from tools import genome_run as tool

    t0 = time.perf_counter()
    a = genome_2kb(tool)
    (b32, b64), times = genome_10kb(tool, seed)
    runs = (a, b32, b64)
    print(f"[genome] phase wall {time.perf_counter() - t0:.1f} s | "
          f"{gpu_line()}", flush=True)
    return {k: sum(r[k] for r in runs) for k in runs[0]}, times


# ---------------------------------------------------------------------------
# phase 11: bench, the port's measurement and driver entry points
# ---------------------------------------------------------------------------

# cuts for the smoke's time limit (the tools' own defaults in brackets):
# bench_e2e's steady runs 2 (5), bench_multihost's process counts 2 (2, 4),
# bench_consensus's batches 1 (the batch of 8 is bench_e2e's run: the same
# build_run and argv) and repeats 1 (1)
BENCH_STEADY_RUNS = 2
MULTIHOST_ARGS = ["--processes", "2"]


def _bench_line(name: str, res: dict):
    print(json.dumps(dict(bench=name, **res, card_line=gpu_line())),
          flush=True)


def phase_bench(seed: int):
    """11: the tools' functions on the card: tools/bench.py's bench_e2e
    (steady runs cut to BENCH_STEADY_RUNS; accuracy >= 99.0 %, every kernel
    launched), bench_refine and bench_fill beside their bounds,
    bench_multihost at 2 processes (the joined shards equal one process's
    output), bench_consensus at batch 1 against bench_e2e's batch of 8 on
    the same run, and dryrun_multichip(4) at ref_len 1500 on a 2x2 mesh of
    cuda:0 (equal to one device, every shard launching the fill, backtrace
    and scorer).  One JSON line each; returns bench_e2e's launches of one
    run."""
    import torch

    from tools import bench as tb
    from tools import bench_consensus as bc
    from tools import bench_multihost as mh
    from tools import dryrun as dry

    t_phase = time.perf_counter()
    e2e = tb.bench_e2e(time.monotonic() + 600, "cuda",
                       steady_runs=BENCH_STEADY_RUNS)
    _bench_line("bench_e2e", e2e)
    launches = e2e["launches_per_run"]
    if e2e["mean_accuracy_pct"] < 99.0:
        fail(f"bench: bench_e2e mean accuracy "
             f"{e2e['mean_accuracy_pct']:.3f}% < 99.0%")
    _need_launches("bench_e2e", launches)
    _bench_line("bench_refine", tb.bench_refine("cuda"))
    _bench_line("bench_fill", tb.bench_fill("cuda"))

    try:
        res = mh.run(mh.parse(MULTIHOST_ARGS))
    except SystemExit as e:
        fail(f"bench: {e}")
    _bench_line("bench_multihost", res)
    if res["outputs_equal"] != {2: True}:
        fail(f"bench: bench_multihost outputs equal {res['outputs_equal']}")

    args = bc.parse(["--batch", "1"])
    d = tempfile.mkdtemp(prefix="psq_smoke_bc_")
    try:
        res = bc.run(args, bc.build(args, d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["batch_8_s"] = e2e["steady_run_median_s"]
    res["batch_8_regions_per_hour"] = e2e["regions_per_hour"]
    _bench_line("bench_consensus", res)
    if res["n_out"] != args.regions or res["mean_acc"] < 99.0:
        fail(f"bench: bench_consensus --batch 1: {res}")

    fn, fargs = dry.entry("cuda")
    best = fn(*fargs)
    try:
        res = dry.dryrun_multichip(4, 1500, "cuda:0")
    except SystemExit as e:
        fail(f"bench: {e}")
    res["entry_best_finite"] = bool(torch.isfinite(best).all())
    _bench_line("dryrun_multichip", res)
    missing = [(sh, k) for sh, n in res["shard_launches"].items()
               for k in ALIGN_KERNELS if n.get(k, 0) <= 0]
    if missing or not res["entry_best_finite"]:
        fail(f"bench: dryrun shards that never launched a kernel "
             f"{missing}, entry best finite {res['entry_best_finite']}")
    print(f"[bench] phase wall {time.perf_counter() - t_phase:.1f} s | "
          f"{gpu_line()}", flush=True)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run phase 3 under torch.profiler, trace into DIR")
    ap.add_argument("--f32-regions", type=int, default=6, metavar="N",
                    help="regions of phase 8 (f32_equiv)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    walls, t_run = {}, time.perf_counter()

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    kernels = run("build", phase_build)
    report = run("kernels", phase_kernels, args.seed)
    run("viterbi", phase_viterbi, args.seed)
    by_phase, held = {}, {}
    by_phase["e2e"], e2e = run("e2e", phase_e2e, args.seed, args.profile)
    by_phase["coverage"], cov_held = run("coverage", phase_coverage,
                                         args.seed)
    by_phase["variant"], held["variant"] = run("variant", phase_variant,
                                               args.seed)
    by_phase["train"], held["train"] = run("train", phase_train, args.seed)
    by_phase["multihost"] = run("multihost", phase_multihost, args.seed)
    by_phase["mesh"] = run("mesh", phase_mesh, args.seed, e2e,
                           by_phase["e2e"])
    by_phase["f32_equiv"] = run("f32_equiv", phase_f32_equiv,
                                args.f32_regions)
    by_phase["wide"], held["wide"] = run("wide", phase_wide, args.seed, e2e)
    by_phase["genome"], largest = run("genome", phase_genome, args.seed)
    by_phase["bench"] = run("bench", phase_bench, args.seed)
    print(f"[smoke] phase walls (s) {walls}, all "
          f"{time.perf_counter() - t_run:.1f} s | {gpu_line()}", flush=True)

    # the held launches' keys of each kernel: "fill fwd", "fill bwd",
    # "mutscore" (phase 9: "mutscore Ws=N"), "viterbi_obs" (the coverage
    # phase's largest)
    held_keys = {"fill": "fill", "mutscore": "mutscore",
                 "viterbi_obs": "viterbi_obs"}
    held["coverage"] = {"viterbi_obs": cov_held}
    entries = []
    for k in kernels:
        line = report[(k.name, False)]
        entries.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=sum(n[k.name] for n in by_phase.values()),
            launches_by_phase={p: n[k.name] for p, n in by_phase.items()},
            max_abs_err=max(line["max_abs_err"],
                            report[(k.name, True)]["max_abs_err"]),
            library_ms=None, library_note=LIBRARY_NOTE[k.name],
            instances=dict(INSTANCES_RUN.get(k.name, collections.Counter())
                           + k.instances),
            **{key: v for key, v in line.items() if key != "max_abs_err"},
            held_launches={p: {hk: v for hk, v in t.items()
                               if k.name in held_keys
                               and hk.startswith(held_keys[k.name])}
                           for p, t in held.items()},
            genome_largest={hk: v for hk, v in largest.items()
                            if hk == k.name or hk.startswith(k.name + " ")}))
    print(json.dumps({"kernels": entries}), flush=True)
    # the run needs one card (phases 6 and 7 put every process and shard on
    # cuda:0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
