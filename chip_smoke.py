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
                and the twin's time;
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
                region, the truth outscores a 5 %-mutated copy;
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
                exact engine's, or below 99 %), which fail the run.
Phase 2 also holds the fill, backtrace and group scorer on cuda:1 in f64
when torch sees a second card.  Phases 2b-8 reset the kernels' launch
counters before they start and report them after; each must have launched
the kernels of its path (phase 3: every kernel; phase 7: all but the
geometry, which a mesh takes from the host).  The line before the
last is a JSON object with one entry per kernel; the last line is
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


def event_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn in ms: CUDA events around reps calls,
    after two warm-up calls."""
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


class _NpzH5:
    """Stand-in for the slice of h5py's File API that
    poreseq_tpu_torch/io/fast5.py uses (groups by path, datasets, structured
    fields, attrs), stored as one npz per file.  Installed only where h5py
    cannot be imported, so the synthetic run's fast5 files are written and
    read through the package's own write_fast5 / load_event unchanged."""

    class _Node:
        def __init__(self, store, path):
            self._store, self._path = store, path.strip("/")

        def _join(self, name):
            if name.startswith("/"):
                return name.strip("/")
            return f"{self._path}/{name}".strip("/")

        @property
        def attrs(self):
            return self._store["attrs"].setdefault(self._path, {})

        def create_group(self, name):
            return _NpzH5._Node(self._store, self._join(name))

        def create_dataset(self, name, data):
            self._store["data"][self._join(name)] = np.asarray(data)

        def __getitem__(self, name):
            path = self._join(name)
            if path in self._store["data"]:
                return self._store["data"][path]
            return _NpzH5._Node(self._store, path)

    class File(_Node):
        def __init__(self, filename, mode="r"):
            super().__init__({"data": {}, "attrs": {}}, "")
            self._filename, self._mode = filename, mode
            if mode == "r":
                with np.load(filename, allow_pickle=False) as z:
                    for key in z.files:
                        kind, path, *name = key.split("|")
                        path = path.replace(":", "/")
                        if kind == "d":
                            self._store["data"][path] = z[key]
                        else:
                            self._store["attrs"].setdefault(path, {})[
                                name[0]] = z[key][()]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if self._mode == "w" and exc[0] is None:
                out = {f"d|{p.replace('/', ':')}": a
                       for p, a in self._store["data"].items()}
                for p, attrs in self._store["attrs"].items():
                    for name, v in attrs.items():
                        out[f"a|{p.replace('/', ':')}|{name}"] = \
                            np.asarray(v)
                with open(self._filename, "wb") as fh:
                    np.savez(fh, **out)


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


def hold_fill(args, where: str) -> float:
    """One fill launch (fill_cuda's arguments) against its plain twin on the
    same operands: M, S and cmax equal (f64) or within the tolerance (f32),
    step bytes equal (f64) or >= 99.95 % equal (f32), first argmaxes and
    best coordinates equal; the kernel's running best (best_pfx, best,
    best_i, best_j) equal to dp.finish_fill on its own cmax and carg.
    Returns the max |diff|."""
    import torch

    from poreseq_tpu_torch.engine.dp import fill_reference, finish_fill
    from poreseq_tpu_torch.engine.fill import fill_cuda

    batch, states, i0, i1, pad, off, backward, W, need_steps = args
    f64 = batch.mean.dtype == torch.float64
    rtol, atol = _tolerance(f64)
    got = fill_cuda(*args)
    ref = fill_reference(*args)
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


def check_fill(engine, seed: int, f64: bool, report: dict):
    """The fill at every realign width of FILL_WIDTHS: forward with steps,
    backward with and without (the main path's backward fill) held to the
    twin; at width 300 in f32 the forward and the backward fill timed."""
    from poreseq_tpu_torch.engine.dp import fill_reference
    from poreseq_tpu_torch.engine.fill import fill_cuda
    from poreseq_tpu_torch.engine.roofline import fill_work

    rtol, atol = _tolerance(f64)
    err, line = 0.0, {}
    for width in FILL_WIDTHS:
        W = 2 * width + 1
        batch, states, i0, i1, pad, off = _fill_inputs(
            engine, _session(seed, width))
        runs = {"forward": (False, True), "backward": (True, False),
                "backward, steps": (True, True)}
        for name, (backward, steps) in runs.items():
            args = (batch, states, i0, i1, pad, off, backward, W, steps)
            err = max(err, hold_fill(args, f"kernels W={W}"))
            if f64 or width != FILL_WIDTHS[0] or name == "backward, steps":
                continue
            t = timed(event_ms(lambda: fill_cuda(*args)),
                      fill_work(batch, states, pad, W, steps),
                      batch.mean.dtype)
            t["plain_ms"] = cuda_ms(lambda: fill_reference(*args), reps=2)
            line[name] = t
        print(f"[kernels] fill f{'64' if f64 else '32'} "
              f"E={batch.mean.shape[0]} C={states.shape[0]} W={W}: forward "
              f"with steps, backward with "
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
TWIN_GROUPS = 512     # the twin's joins hold [G, P, E_g, W] temporaries


def _mut_regions(seed: int):
    """The group scorer's inputs at main-path shapes: 8 simulated 1 kb
    regions in one lockstep batch, each as a Refine call sees it (point
    width 20, every point mutation) and as a Mutate round sees it (scoring
    width 100, 300 random indels and substitutions)."""
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
        pa.params.update(P_WIDTHS)
        data = AlignData.from_session(pa)
        data.params.scoring_width = P_WIDTHS["point_width"]
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
    time: totals [G, P]."""
    import torch

    from poreseq_tpu_torch.engine.mutscore import (group_deltas_reference,
                                                   sum_rows_reference)

    gp = args[13]
    G = gp["g_start"].shape[0]
    out = []
    for at in range(0, G, TWIN_GROUPS):
        sub = {k: v[at : at + TWIN_GROUPS] for k, v in gp.items()}
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


def phase_kernels(seed: int):
    import torch

    from poreseq_tpu_torch.engine import TorchEngine

    report = {}
    regions = _mut_regions(seed)
    # the Viterbi kernels' regions as phase 2b has them: the group scorer's
    # check realigns its regions' events in place
    events = [d.events for d in _mut_regions(seed)["refine"][0]]
    for f64 in (True, False):
        engine = TorchEngine("cuda", torch.float64 if f64 else torch.float32)
        check_fill(engine, seed, f64, report)
        check_backtrace(engine, _session(seed), f64, report)
        check_mutscore(engine, regions, f64, report)
        check_viterbi(engine, events, seed, f64, report)
        check_prologue(engine, _mut_regions(seed)["mutate"][0], f64, report)
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


def _copied(x):
    """x with every tensor in it cloned (tuples, named tuples, lists and
    dicts rebuilt around the clones)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_copied, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(_copied, x))
    return x


@contextlib.contextmanager
def largest_launches():
    """Inside the block, keep a copy of the operands of the largest forward
    fill, the largest backward fill (C x E cells) and the largest group-scorer
    launch (G x C x E) that the path makes, the first of equals, under the
    keys "fill fwd", "fill bwd" and "mutscore".  They are held to their twins
    after the path's launch counts are read."""
    import inspect

    from poreseq_tpu_torch.engine import fill, mutscore

    kept, sizes = {}, {}
    real = fill.fill_cuda, mutscore.group_totals_cuda

    def keeper(fn, key_size):
        sig = inspect.signature(fn)

        def wrapped(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            key, size = key_size(b.arguments)
            if size > sizes.get(key, 0):
                kept[key] = _copied(tuple(b.arguments.values()))
                sizes[key] = size
            return fn(*a, **kw)
        return wrapped

    fill.fill_cuda = keeper(real[0], lambda a: (
        "fill bwd" if a["backward"] else "fill fwd", a["states"].numel()))
    mutscore.group_totals_cuda = keeper(real[1], lambda a: (
        "mutscore", a["gp"]["g_start"].shape[0] * a["Mf"].shape[0]
        * a["Mf"].shape[1]))
    try:
        yield kept
    finally:
        fill.fill_cuda, mutscore.group_totals_cuda = real


def hold_path_launches(kept: dict, phase: str):
    """Hold the launches kept by largest_launches to their twins and time
    each on the card; returns (a line of what was held, {key: timing})."""
    from poreseq_tpu_torch.engine.fill import fill_cuda
    from poreseq_tpu_torch.engine.mutscore import group_totals_cuda
    from poreseq_tpu_torch.engine.roofline import fill_work, group_work

    for key in ("fill fwd", "fill bwd", "mutscore"):
        if key not in kept:
            fail(f"{phase}: no {key} launch was kept to hold to its twin")
    t0 = time.perf_counter()
    errs = {k: hold_fill(kept[k], phase) for k in ("fill fwd", "fill bwd")}
    errs["mutscore"] = hold_mutscore(kept["mutscore"], phase)
    secs = time.perf_counter() - t0
    times = {}
    for k in ("fill fwd", "fill bwd"):
        a = kept[k]
        times[k] = timed(event_ms(lambda: fill_cuda(*a)),
                         fill_work(a[0], a[1], a[4], a[7], a[8]),
                         a[0].mean.dtype)
    a = kept["mutscore"]
    times["mutscore"] = timed(event_ms(lambda: group_totals_cuda(*a)),
                              group_work(*a), a[1].dtype)
    batch, states = kept["fill fwd"][:2]
    mf, gp = kept["mutscore"][1], kept["mutscore"][13]
    line = (f"held to the twins: fill fwd/bwd C={states.shape[0]} "
            f"E={states.shape[1]} max |diff| {errs['fill fwd']:.3e}/"
            f"{errs['fill bwd']:.3e}, mutscore G={gp['g_start'].shape[0]} "
            f"C={mf.shape[0]} E={mf.shape[1]} max |diff| "
            f"{errs['mutscore']:.3e}, {secs:.2f} s; timed: "
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
    (the card's machine): an npz stand-in takes its place."""
    try:
        import h5py  # noqa: F401
        return "h5py"
    except ImportError:
        sys.modules["h5py"] = _NpzH5
        return "npz stand-in for h5py"


CONF_WIDTHS = ("realign_width = 300\nscoring_width = 100\npoint_width = 20\n"
               "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 300\n"
               "max_length = 10000\nlik_offset = 4.5\n")


def _e2e_run(d: str, seed: int):
    """Phase 3's synthetic run: 8 x 1 kb regions at 10X, 2 % draft error."""
    from poreseq_tpu_torch.sim import write_run

    R, L, cov = E2E_REGIONS, 1000, 10
    truth, _, reads_dir, bam, fasta = write_run(
        d, np.random.default_rng(seed), ref_len=R * L,
        n_reads=(cov // 2) * R, read_len=L + 200, draft_error=0.02)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write(CONF_WIDTHS)
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


def phase_e2e(seed: int, profile: str | None = None):
    import glob

    import torch

    from poreseq_tpu_torch.api import swalign
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
        # regions are draft coordinates: widen the truth window so draft
        # indel drift does not push a region out of it
        accs = [swalign(s, truth[max(int(n.split(":")[1]) - 400, 0)
                                 : int(n.split(":")[2]) + 400])[0]
                for n, s in seqs.items()]
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
    from poreseq_tpu_torch.core.regions import RegionInfo
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
        launches = _launches()
        held, times = hold_path_launches(kept, "variant")

        from poreseq_tpu_torch.core.params import load_params

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
    fscores = dict((vid, float(sc)) for vid, sc in
                   (l.rsplit(", ", 1) for l in out_f.splitlines()))
    print(f"[variant] 5 kb, 25 reads of 1.2 kb, widths 300/100/20: -m "
          f"{len(muts)} "
          f"mutations {wall_m:.2f} s (reverting min {min(revert):.3f}, "
          f"corrupting max {max(corrupt):.3f}); -a {region_a} "
          f"{len(lines_a)} lines for {n_points} point mutations "
          f"{wall_a:.2f} s; -f truth {fscores.get('truth')} vs 5 %-mutated "
          f"{fscores.get('mutated5')} {wall_f:.2f} s; launches {launches}; "
          f"{held} | {gpu_line()}", flush=True)
    if min(revert) <= 0 or max(corrupt) >= 0:
        fail("variant -m: a reverting mutation scored <= 0 or a corrupting "
             "one >= 0")
    if len(lines_a) != n_points:
        fail(f"variant -a: {len(lines_a)} lines, {n_points} point mutations")
    if not fscores.get("truth", -np.inf) > fscores.get("mutated5", np.inf):
        fail(f"variant -f: scores {fscores}")
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
    from poreseq_tpu_torch.api import swalign
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
    accs = [swalign(s, truth[max(int(n.split(":")[1]) - 400, 0)
                             : int(n.split(":")[2]) + 400])[0]
            for n, s in seqs.items()]
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

    kernels = phase_build()
    report = phase_kernels(args.seed)
    phase_viterbi(args.seed)
    by_phase, held = {}, {}
    by_phase["e2e"], e2e = phase_e2e(args.seed, args.profile)
    by_phase["variant"], held["variant"] = phase_variant(args.seed)
    by_phase["train"], held["train"] = phase_train(args.seed)
    by_phase["multihost"] = phase_multihost(args.seed)
    by_phase["mesh"] = phase_mesh(args.seed, e2e, by_phase["e2e"])
    by_phase["f32_equiv"] = phase_f32_equiv(args.f32_regions)

    held_keys = {"fill": ("fill fwd", "fill bwd"), "mutscore": ("mutscore",),
                 "backtrace": (), "viterbi_sweep": (), "viterbi_sample": (),
                 "viterbi_gumbel": (), "viterbi_obs": (), "likes": (),
                 "geom": (), "windows": ()}
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
            held_launches={p: {hk: t[hk] for hk in held_keys[k.name]}
                           for p, t in held.items()}))
    print(json.dumps({"kernels": entries}), flush=True)
    # the run needs one card (phases 6 and 7 put every process and shard on
    # cuda:0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
