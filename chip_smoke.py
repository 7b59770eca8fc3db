#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (each prints one line of what it measured; any failure exits
non-zero, nothing runs on the CPU instead):
  1. build    — nvcc builds the kernels of poreseq_tpu_torch/csrc/ for sm_90a;
  2. kernels  — each kernel against its plain PyTorch twin on the card at
                main-path shapes (fill width 300, scoring width 100,
                Refine point width 20): the fill and the backtrace on a
                simulated 1 kb region at 10X, the group scorer on every
                group of an 8-region lockstep batch, in f64 (semantics) and
                f32 (the production type), with the kernel's and the twin's
                times;
  3. e2e      — the port's CLI `consensus --region-batch 8 --device cuda` on a
                synthetic run (8 x 1 kb regions at 10X, widths 300/100/20,
                -i 4), checking the output count, the mean accuracy against
                the truth and that every kernel of the path was launched.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
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
    """Stand-in for the slice of h5py's File API that poreseq_tpu/io/fast5.py
    uses (groups by path, datasets, structured fields, attrs), stored as one
    npz per file.  Installed only where h5py cannot be imported, so the
    synthetic run's fast5 files are written and read through the package's
    own write_fast5 / load_event unchanged."""

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


def phase_build():
    from poreseq_tpu_torch.engine.align import BACKTRACE
    from poreseq_tpu_torch.engine.fill import FILL
    from poreseq_tpu_torch.engine.mutscore import MUTSCORE

    kernels = [FILL, MUTSCORE, BACKTRACE]
    t0 = time.perf_counter()
    for k in kernels:
        k.lib()
    secs = {k.name: round(k.build_seconds, 3) for k in kernels}
    print(f"[build] nvcc sm_90a: {secs} total "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(gpu_line(), flush=True)
    return kernels


def _session(seed: int):
    """A simulated 1 kb region at 10X with a 2% draft error."""
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(seed), ref_len=1000,
                             coverage=10, draft_error=0.02)
    pa.params.update(P_WIDTHS)
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


def check_fill(engine, data, f64: bool, report: dict):
    import torch

    from poreseq_tpu_torch.engine.dp import fill_reference
    from poreseq_tpu_torch.engine.fill import fill_cuda

    W = 2 * data.params.realign_width + 1
    batch, states, i0, i1, pad, off = _fill_inputs(engine, data)
    rtol, atol = (1e-11, 1e-9) if f64 else (2e-5, 2e-4)
    err = 0.0
    for backward in (False, True):
        args = (batch, states, i0, i1, pad, off, backward, W, True)
        got = fill_cuda(*args)
        ref = fill_reference(*args)
        torch.cuda.synchronize()
        names = ("M", "S", "steps_m", "steps_s", "cmax", "carg")
        for n, a, b in zip(names, got, ref):
            if n.startswith("steps"):
                agree = (a == b).double().mean().item()
                if (f64 and agree < 1.0) or agree < 0.9995:
                    fail(f"fill {n} agreement {agree} (f64={f64}, "
                         f"backward={backward})")
            elif n == "carg":
                if not torch.equal(a, b):
                    fail(f"fill carg differs (f64={f64})")
            else:
                d = (a - b).abs()
                if not bool((d <= atol + rtol * b.abs()).all()):
                    fail(f"fill {n}: max |diff| {d.max().item()} "
                         f"(f64={f64}, backward={backward})")
                err = max(err, d.max().item())
        from poreseq_tpu_torch.engine.dp import finish_fill

        rg = finish_fill(*got, i0, i1, backward)
        rr = finish_fill(*ref, i0, i1, backward)
        if not (torch.equal(rg.best_i, rr.best_i)
                and torch.equal(rg.best_j, rr.best_j)):
            fail(f"fill best_i/best_j differ (f64={f64}, "
                 f"backward={backward})")
    line = dict(max_abs_err=err)
    if not f64:
        args = (batch, states, i0, i1, pad, off, False, W, True)
        line["ms"] = cuda_ms(lambda: fill_cuda(*args))
        line["plain_ms"] = cuda_ms(lambda: fill_reference(*args), reps=2)
    report[("fill", f64)] = line
    print(f"[kernels] fill f{'64' if f64 else '32'} E={batch.mean.shape[0]} "
          f"C={states.shape[0]} W={W}: max |diff| {err:.3e} "
          f"(rtol {rtol}, atol {atol}); steps/best equal"
          + (f"; kernel {line['ms']:.3f} ms, twin {line['plain_ms']:.1f} ms"
             if not f64 else ""), flush=True)


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
    rtol, atol = (1e-11, 1e-9) if f64 else (2e-5, 2e-4)
    d = (rlk_k - rlk_r).abs()
    if not bool((d <= atol + rtol * rlk_r.abs()).all()):
        fail(f"backtrace ref_like max |diff| {d.max().item()}")
    line = dict(max_abs_err=d.max().item())
    if not f64:
        line["ms"] = cuda_ms(lambda: backtrace_cuda(*args))
        line["plain_ms"] = cuda_ms(lambda: backtrace_reference(*args),
                                   reps=2)
    report[("backtrace", f64)] = line
    print(f"[kernels] backtrace f{'64' if f64 else '32'}: ref_align equal, "
          f"ref_like max |diff| {line['max_abs_err']:.3e}"
          + (f"; kernel {line['ms']:.3f} ms, twin {line['plain_ms']:.1f} ms"
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
    from poreseq_tpu.core.regions import MutationInfo
    from poreseq_tpu.engine.driver import find_point_mutations
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.sim import simulate_session

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


def check_mutscore(engine, calls, f64: bool, report: dict):
    """Group scorer (one launch per (K, D) class over all groups of the
    8-region batch, as the main path launches it) against its twin on every
    group."""
    import torch

    from poreseq_tpu_torch.engine.mutscore import (group_launches,
                                                   group_totals_cuda)

    tol = (lambda a, b: (a - b).abs() <= 1e-8) if f64 else (
        lambda a, b: (a - b).abs() <= 3e-3 + 2e-4 * b.abs())
    err, ms, plain_ms, n_groups, clamped = 0.0, [], [], {}, 0
    for name, (datas, mlists) in calls.items():
        n_groups[name] = 0
        for gp, _, args in group_launches(engine, datas, mlists,
                                          [True] * len(datas)):
            E, E_g, G = args[1].shape[1], args[21], gp["G"]
            clamped += int((gp["g_evoff"][:G] > E - E_g).sum())
            n_groups[name] += G
            tot_k, _ = group_totals_cuda(*args)
            tot_r = _twin_totals(args)
            torch.cuda.synchronize()
            if not bool(tol(tot_k, tot_r).all()):
                fail(f"mutscore {name} K={args[18]} D={args[20]}: max "
                     f"|diff| {(tot_k - tot_r).abs().max().item()}")
            valid = args[13]["s_valid"].bool()
            flips = ((tot_k - 1e-6 > 0) != (tot_r - 1e-6 > 0)) & valid
            if bool(flips.any()):
                fail(f"mutscore {name}: {int(flips.sum())} accept-sign flips")
            err = max(err, (tot_k - tot_r).abs().max().item())
            if not f64 and name == "refine":
                ms.append(cuda_ms(lambda: group_totals_cuda(*args)))
                plain_ms.append(cuda_ms(lambda: _twin_totals(args), reps=2))
    if not clamped:
        fail("mutscore: no group's event slice was clamped to E - E_g")
    line = dict(max_abs_err=err)
    if not f64:
        line["ms"] = float(sum(ms))
        line["plain_ms"] = float(sum(plain_ms))
    report[("mutscore", f64)] = line
    print(f"[kernels] mutscore f{'64' if f64 else '32'}: "
          f"{len(MUT_COVERAGE)} regions, groups {n_groups} "
          f"({clamped} with a clamped event slice), every group held to the "
          f"twin: totals max |diff| {err:.3e}, 0 accept-sign flips"
          + (f"; Refine call kernel {line['ms']:.3f} ms, twin "
             f"{line['plain_ms']:.1f} ms" if not f64 else ""), flush=True)


def phase_kernels(seed: int):
    import torch

    from poreseq_tpu_torch.engine import TorchEngine

    report = {}
    for f64 in (True, False):
        engine = TorchEngine("cuda", torch.float64 if f64 else torch.float32)
        data = _session(seed)
        check_fill(engine, data, f64, report)
        check_backtrace(engine, data, f64, report)
        check_mutscore(engine, _mut_regions(seed), f64, report)
    return report


def phase_e2e(seed: int):
    import torch

    from poreseq_tpu.api import swalign
    from poreseq_tpu.io.fasta import read_fasta
    from poreseq_tpu.sim import write_run
    from poreseq_tpu_torch import cli
    from poreseq_tpu_torch.engine.align import BACKTRACE
    from poreseq_tpu_torch.engine.fill import FILL
    from poreseq_tpu_torch.engine.mutscore import MUTSCORE

    try:
        import h5py  # noqa: F401
        fast5_io = "h5py"
    except ImportError:
        sys.modules["h5py"] = _NpzH5
        fast5_io = "npz stand-in for h5py"
    R, L, cov = E2E_REGIONS, 1000, 10
    d = tempfile.mkdtemp(prefix="psq_smoke_")
    try:
        truth, _, reads_dir, bam, fasta = write_run(
            d, np.random.default_rng(seed), ref_len=R * L,
            n_reads=(cov // 2) * R, read_len=L + 200, draft_error=0.02)
        conf = os.path.join(d, "params.conf")
        with open(conf, "w") as f:
            f.write("realign_width = 300\nscoring_width = 100\n"
                    "point_width = 20\nmin_coverage = 0\nmax_coverage = 30\n"
                    "min_overlap = 300\nmax_length = 10000\n"
                    "lik_offset = 4.5\n")
        rf = os.path.join(d, "regions.txt")
        with open(rf, "w") as f:
            f.write("\n".join("synthref:{}:{}".format(r * L, (r + 1) * L)
                              for r in range(R)) + "\n")
        out = os.path.join(d, "out.fasta")
        for k in (FILL, MUTSCORE, BACKTRACE):
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["consensus", fasta, bam, reads_dir, "-R", rf, "-p", conf,
                  "-o", out, "-i", "4", "--region-batch", "8",
                  "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in (FILL, MUTSCORE, BACKTRACE)}
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
          f"(min {min(accs):.3f}%), launches {launches}, fast5 via "
          f"{fast5_io} | {gpu_line()}", flush=True)
    if acc < 99.0:
        fail(f"e2e mean accuracy {acc:.3f}% < 99.0%")
    for name, n in launches.items():
        if n <= 0:
            fail(f"e2e: kernel {name} was never launched")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels = phase_build()
    report = phase_kernels(args.seed)
    launches = phase_e2e(args.seed)

    entries = []
    for k in kernels:
        line = report[(k.name, False)]
        entries.append(dict(name=k.name, route="cuda", source=k.source,
                            replaces=k.replaces, launches=launches[k.name],
                            max_abs_err=line["max_abs_err"], ms=line["ms"],
                            plain_ms=line["plain_ms"]))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
