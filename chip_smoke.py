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
                regions, the Viterbi observations on those regions' rows,
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
                and the geometry at 256 levels past its staged cap and at
                twice the cap (the instance that reads the row from device
                memory), equal; each timed in f32 (event and queued ms)
                under the kernel's "wide" key;
  2b. viterbi — the sampler's counter hash on the card equals its pinned
                values bit for bit, and in f64 each of the 8 regions of
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
                (300/100/20) on --f32-regions 1 kb regions (default 10,
                the script's own count; region i: seed 1000 + 37 i,
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
                twins (phase 2's tolerances) and timed;
 10. genome   — the genome-scale path through tools/genome_run.py's
                functions (write_run, the CLI's split, consensus per shard,
                merge), widths 300/100/20, -i 4 --region-batch 8: 10a
                lambda-2kb, the JAX README's lambda configuration (48.5 kb
                at 10X, 8 kb reads over 2 kb regions) cut to its first 16
                regions, dealt over 2 shards: one merged contig at >= 99.0 %
                over the covered span, trimmed events (batch T below the
                reads' levels) and every kernel launched; 10b long-10kb, the
                lambda genome split at 10 kb (6 regions, 10.4 kb reads) in
                one lockstep batch on TorchEngine f32 (the CLI) and its
                first 3 regions on f64 (pipeline.mutate_many, in a process
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
the kernels of its path (phases 3 and 11's bench_e2e run: every kernel;
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
    ((bytes, operations) from engine/roofline.py)."""
    from poreseq_tpu_torch.engine.roofline import bound_ms

    b_ms, by = bound_ms(*work, dtype)
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


def _session(seed: int, realign: int = P_WIDTHS["realign_width"]):
    """A simulated 1 kb region at 10X with a 2% draft error."""
    from poreseq_tpu_torch.engine.types import AlignData
    from poreseq_tpu_torch.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=1000,
                             coverage=10, draft_error=0.02)
    pa.params.update(P_WIDTHS, realign_width=realign)
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


def hold_fill(args, where: str, timing: dict | None = None) -> float:
    """One fill launch (fill_cuda's arguments) against its plain twin on the
    same operands: M, S and cmax equal (f64) or within the tolerance (f32),
    step bytes equal (f64) or >= 99.95 % equal (f32), first argmaxes and
    best coordinates equal; the kernel's running best (best_pfx, best,
    best_i, best_j) equal to dp.finish_fill on its own cmax and carg.
    Returns the max |diff|; timing: gets the twin's wall (ms, one call
    closed by a synchronize) under "plain_ms"."""
    import torch

    from poreseq_tpu_torch.engine.dp import fill_reference, finish_fill
    from poreseq_tpu_torch.engine.fill import fill_cuda

    batch, states, i0, i1, pad, off, backward, W, need_steps = args
    f64 = batch.mean.dtype == torch.float64
    rtol, atol = _tolerance(f64)
    got = fill_cuda(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = fill_reference(*args)
    torch.cuda.synchronize()
    if timing is not None:
        timing["plain_ms"] = (time.perf_counter() - t0) * 1e3
    own = finish_fill(*got[:6], i0, i1, backward)
    torch.cuda.synchronize()
    what = f"{where} fill (f64={f64}, backward={backward})"
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
    from poreseq_tpu_torch.core.regions import MutationInfo
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
        seq, muts = data.sequence, []
        for _ in range(300):
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
        mutate[0].append(data)
        mutate[1].append(muts)
    return dict(refine=refine, mutate=mutate)


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


def hold_mutscore(args, where: str) -> float:
    """One group-scorer launch (group_totals_cuda's arguments) against its
    plain twin on every group: totals equal (f64) or within 3e-3 + 2e-4 |x|
    (f32), and no accept-sign flip.  Returns the max |diff|."""
    import torch

    from poreseq_tpu_torch.engine.mutscore import group_totals_cuda

    f64 = args[1].dtype == torch.float64
    tot_k, _ = group_totals_cuda(*args)
    tot_r = _twin_totals(args)
    torch.cuda.synchronize()
    d = (tot_k - tot_r).abs()
    bound = 0.0 if f64 else 3e-3 + 2e-4 * tot_r.abs()
    what = f"{where} mutscore K={args[18]} D={args[20]} (f64={f64})"
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
# levels), the Gumbel noise (an element a thread) and the geometry (serial
# walks over the threads' summaries)
EARLIER_MS = {"viterbi_obs": (0.424, "a block a row"),
              "likes": (0.027, "a warp an event"),
              "viterbi_gumbel": (0.0735, "an element a thread"),
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
          f"the Gumbel kernel's [{nk}, {R}, 1024] equal"
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


def check_wide(engine, seed: int, f64: bool, report: dict):
    """The wide instances held to their twins: the fill at WIDE_FILL
    (forward with steps, backward without: the main path's) with phase 2's
    tolerances, the group scorer on a Mutate call's groups at WIDE_WIDTHS
    (8 regions), the geometry past its staged cap bit-equal; in f32 each
    wide launch timed (event and queued ms) beside its bound, under the
    kernel's "wide" key."""
    import torch

    from poreseq_tpu_torch.engine.fill import fill_cuda
    from poreseq_tpu_torch.engine.mutscore import (GEOM_MAX_LEVELS,
                                                   geom_cuda, geom_reference,
                                                   group_launches,
                                                   group_totals_cuda)
    from poreseq_tpu_torch.engine.roofline import (fill_work, geom_work,
                                                   group_work)

    t0 = time.perf_counter()
    dt = engine.dtype
    wide = {"fill": {}, "mutscore": {}, "geom": {}}
    errs = {k: 0.0 for k in wide}

    def time_it(fn, work, **shape):
        return dict(shape, queued_ms=queued_ms(fn),
                    **timed(event_ms(fn), work, dt))

    for width in WIDE_FILL:
        W = 2 * width + 1
        batch, states, i0, i1, pad, off = _fill_inputs(
            engine, _session(seed, width))
        shape = dict(E=batch.mean.shape[0], C=states.shape[0])
        for name, backward, steps in (("forward", False, True),
                                      ("backward", True, False)):
            args = (batch, states, i0, i1, pad, off, backward, W, steps)
            errs["fill"] = max(errs["fill"],
                               hold_fill(args, f"kernels wide W={W}"))
            if not f64:
                wide["fill"].setdefault(f"W={W}", {})[name] = time_it(
                    lambda: fill_cuda(*args),
                    fill_work(batch, states, pad, W, steps), **shape)

    datas, mlists = _mut_regions(seed, WIDE_WIDTHS)["mutate"]
    n_groups = 0
    for gp, _, args in group_launches(engine, datas, mlists,
                                      [True] * len(datas)):
        if args[16] != 2 * WIDE_WIDTHS["scoring_width"] + 1:
            fail(f"kernels wide: a Mutate launch at Ws={args[16]}")
        n_groups += gp["G"]
        errs["mutscore"] = max(errs["mutscore"],
                               hold_mutscore(args, "kernels wide"))
        if not f64:
            wide["mutscore"].setdefault(f"Ws={args[16]}", []).append(
                time_it(lambda: group_totals_cuda(*args), group_work(*args),
                        G=gp["G"], C=args[1].shape[0], E=args[1].shape[1]))

    cap = GEOM_MAX_LEVELS[dt]
    for T in (cap + 256, 2 * cap):
        ral, n0, S_e = _long_rows(np.random.default_rng(seed + T), 8, T)
        t = lambda x: torch.as_tensor(x, device="cuda")
        args = (t(ral).to(dt), t(n0), t(S_e), WIDE_WIDTHS["scoring_width"],
                T)
        for a, b in zip(geom_cuda(*args), geom_reference(*args)):
            if not torch.equal(a, b):
                fail(f"kernels wide geom T={T} (f64={f64}) "
                     + _differs("geom", a, b))
        if not f64:
            wide["geom"][f"T={T}"] = time_it(
                lambda: geom_cuda(*args), geom_work(args[0], args[1], T),
                E=ral.shape[0], C=T)
    for k, err in errs.items():
        # in f64 the fill's line comes after the pool's holds (phase_kernels)
        line = report.setdefault((k, f64), dict(max_abs_err=0.0))
        line["max_abs_err"] = max(line["max_abs_err"], err)
        if not f64:
            line["wide"] = wide[k]
    fmt = lambda d: f"E={d['E']} " + _timing(d) + \
        f", queued {d['queued_ms']:.4f} ms"
    print(f"[kernels] wide f{'64' if f64 else '32'}: fill W="
          f"{[2 * w + 1 for w in WIDE_FILL]} forward with steps and "
          f"backward held to the twin (max |diff| {errs['fill']:.3e}); "
          f"mutscore Ws={2 * WIDE_WIDTHS['scoring_width'] + 1} on "
          f"{n_groups} groups of {len(datas)} regions held (max |diff| "
          f"{errs['mutscore']:.3e}); geom T={cap + 256} and {2 * cap} equal "
          f"the twin; {time.perf_counter() - t0:.1f} s"
          + ("".join(f"; fill {w} {n} {fmt(d)}"
                     for w, runs in wide["fill"].items()
                     for n, d in runs.items())
             + "".join(f"; mutscore {w} G={d['G']} {fmt(d)}"
                       for w, runs in wide["mutscore"].items() for d in runs)
             + "".join(f"; geom {w} {fmt(d)}"
                       for w, d in wide["geom"].items())
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
        held = {k: f.result(timeout=900) for k, f in pending.items()}
    check_fill(engine, seed, True, report, held)
    engine = TorchEngine("cuda", torch.float32)
    check_fill(engine, seed, False, report, held)
    check_backtrace(engine, _session(seed), False, report)
    check_mutscore(engine, regions, False, report)
    check_viterbi(engine, events, seed, False, report)
    check_prologue(engine, _mut_regions(seed)["mutate"][0], False, report)
    check_wide(engine, seed, False, report)
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


def _reset_launches():
    import torch

    torch.cuda.synchronize()
    for k in _kernels():
        k.launches = 0


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
                kept[key] = _copied(tuple(b.arguments.values()), to)
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


def _e2e_run(d: str, seed: int, conf_text: str = CONF_WIDTHS):
    """Phase 3's synthetic run: 8 x 1 kb regions at 10X, 2 % draft error
    (conf_text: the params file's text, phase 9's WIDE_CONF)."""
    from poreseq_tpu_torch.sim import write_run

    R, L, cov = E2E_REGIONS, 1000, 10
    truth, _, reads_dir, bam, fasta = write_run(
        d, np.random.default_rng(seed), ref_len=R * L,
        n_reads=(cov // 2) * R, read_len=L + 200, draft_error=0.02)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write(conf_text)
    regions = ["synthref:{}:{}".format(r * L, (r + 1) * L) for r in range(R)]
    return truth, fasta, bam, reads_dir, conf, regions


def _write_lines(path: str, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_viterbi(seed: int):
    """2b: the counter hash on the card, and each region's Viterbi
    candidates inside an 8-region batch against its solo call."""
    import torch

    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.viterbi import (counter_hash,
                                                  counter_uniforms)

    _reset_launches()
    t0 = time.perf_counter()
    t = lambda v: torch.tensor(v, dtype=torch.int64, device="cuda")
    for (sd, k, i, w), h in PINNED_HASH:
        got = int(counter_hash(sd, t([k]), t([i]), t([w]))[0])
        if got != h:
            fail(f"viterbi: counter_hash{(sd, k, i, w)} = {got} on the card, "
                 f"pinned {h}")
    rows = torch.arange(0, 4096, 7, dtype=torch.int64)
    for dt in (torch.float32, torch.float64):
        u_card = counter_uniforms(seed, 16, rows.cuda(), dt).cpu()
        if not torch.equal(u_card, counter_uniforms(seed, 16, rows, dt)):
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
    print(f"[viterbi] counter hash on the card = pinned values, uniforms "
          f"bit-equal to the CPU's; {len(events)} regions (10-14X, 1 kb) "
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
    "viterbi_gumbel": "no single PyTorch call draws Gumbel noise from a "
                      "counter hash",
    "viterbi_obs": "no single PyTorch call computes a trimmed mean over "
                   "events (torch.sort then a masked sum is several calls)",
    "likes": "no single PyTorch call computes the last anchored value at "
             "each reference index (two cummax, a searchsorted, gathers)",
    "geom": "no single PyTorch call computes update_refs' interpolation, "
            "a band placement and its rate limit",
    "windows": "no single PyTorch call gathers windows with pad values "
               "outside the event (a gather, a clamp and a where)",
}

# (seed, k, i, w) -> h, as tests/test_torch_viterbi.py pins them on the CPU
PINNED_HASH = [((0, 0, 0, 0), 1106484830), ((7, 0, 0, 0), 993596527),
               ((7, 15, 1234, 1023), 3231325825),
               ((7, 3, 99999, 1541), 3294090134),
               ((2 ** 32 + 7, 3, 99999, 1541), 3294090134),
               ((123456789, 1, 7, 2047), 767034526)]


# phase 9's params file: phase 3's with realign width 700 and scoring width
# 600 (W = 1401, Ws = 1201: the fill and the group scorer two rows a thread)
WIDE_CONF = (CONF_WIDTHS
             .replace("realign_width = 300", "realign_width = 700")
             .replace("scoring_width = 100", "scoring_width = 600"))


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
    return launches, times


# ---------------------------------------------------------------------------
# phase 10: genome, tools/genome_run.py's split -> consensus -> merge
# ---------------------------------------------------------------------------

# 10a: the JAX README's lambda configuration (48.5 kb at 10X, 8 kb reads
# over 2 kb regions, widths 300/100/20, -i 4 --region-batch 8), cut to its
# first 16 regions dealt over 2 shards: one lockstep batch of 8 a shard
GENOME_2KB = ["sharded", "--genome", "48500", "--region-length", "2000",
              "--read-len", "8000", "--shards", "2", "--limit", "8"]
# 10b: the lambda genome split at the defaults' region length (10 kb: 6
# regions, reads of 10.4 kb), one lockstep batch
GENOME_10KB = ["lambda", "--region-length", "10000"]
# the rows of 10b's held fill launches and the groups of its held scorer
# launch (rows and groups are independent in the fill and the scorer; the
# twins at full size ran the card out of memory at phase 9's widths)
HOLD_ROWS, HOLD_GROUPS = 8, 2048
# 10b's f64 run takes the batch's first 3 regions (cut: the phase ran 541 s
# with all 6 on an H100 at 700 W, against a budget of about 240 s); it runs
# in a process of its own while the f32 run's launches are held to their
# twins
F64_REGIONS = 3


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
    from poreseq_tpu_torch.engine.fill import rows_per_thread
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
        cap = mutscore.GEOM_MAX_LEVELS[a["ral"].dtype]
        return f"{'staged' if T <= cap else 'unstaged'} (T {T}, cap {cap})"

    load._set_trim_hint = hint
    TorchEngine._prepare_multi, TorchEngine.score_alignments_multi = (prep,
                                                                     score)
    fill.fill_cuda = instance(real["fill"], "fill", lambda a: (
        f"W={a['W']} ({rows_per_thread(a['W'])} row a thread)"))
    mutscore.group_totals_cuda = instance(real["scorer"], "scorer", lambda a: (
        f"Ws={a['Ws']} ({rows_per_thread(a['Ws'])} row a thread)"))
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
    """10a: the lambda genome's first 16 of 49 regions of 2 kb with 8 kb
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
    """10b: the lambda genome's 6 regions of 10 kb in one lockstep batch on
    TorchEngine f32 (the CLI), and its first F64_REGIONS of them on f64
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
              + ("" if todo is regions else
                 f" (cut: the first {len(todo)} of "
                 f"{run['regions_total']})")
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
    ap.add_argument("--f32-regions", type=int, default=10, metavar="N",
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
    # "mutscore" (phase 9: "mutscore Ws=N")
    held_keys = {"fill": "fill", "mutscore": "mutscore"}
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
