#!/usr/bin/env python3
"""The Viterbi observations past the tiled instance's cap on one card: each
instance of csrc/viterbi_obs.cu that takes a shape, and a parent checkout's
kernel, held to the twin and timed in turns in one call.

    python3 tools/obs_instances.py [--parent DIR] [--dtypes f32,f64]
                                   [--shapes 30X,60,64,65,100,257,1024,8193]
                                   [--seed N]

Shapes: `30X` is the largest observation launch the engine makes in
chip_smoke.py's coverage phase (8 x 1 kb at 30X, run once through the CLI
on the card: chip_smoke.coverage_obs_operands); `30X-loader` the same 8
regions' events as the loader gives them, in one batch before any
refinement (chip_smoke.loader_obs_operands); a number E is
chip_smoke.OBS_SHAPES[E] (B regions of R rows, E events,
chip_smoke.obs_shape_inputs).  The instances are those of
engine/viterbi.py OBS_PATHS whose cap holds E; with --parent, DIR's
csrc/viterbi_obs.cu is built with the same nvcc flags and its C entry
called with the path its own rule picks (32 events or fewer: 0, 8192 or
fewer: 1, else 2), under the name `parent`.  Each is held to
obs_multi_reference (bit for bit) and then timed in turns (parent, the
instances, the instances again in reverse, parent), each by CUDA events
around a run of launches (chip_smoke's event_ms) and by the same launches
queued behind a spin kernel (chip_smoke.queued_ms), beside
engine/roofline.py viterbi_obs_work's least time.  First each build's
registers and spills as ptxas reports them; one line `[obs_instances]
{json}` per (shape, dtype), then the card's name and power limit.  Needs a
CUDA card; a hold that fails exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DTYPES = {"f32": "float32", "f64": "float64"}


def parent_entry(parent: str):
    """Build DIR's csrc/viterbi_obs.cu; returns ({suffix: C function},
    ptxas lines)."""
    from chip_smoke import ptxas_usage
    from poreseq_tpu_torch import _build
    from poreseq_tpu_torch.engine.viterbi import _OBS_SIG

    csrc = os.path.join(parent, "poreseq_tpu_torch", "csrc")
    lib = os.path.join(tempfile.mkdtemp(prefix="psq_obs_parent_"),
                       "libviterbi_obs.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                           "-o", lib, os.path.join(csrc, "viterbi_obs.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"obs_instances: the parent's build failed:\n"
                         f"{proc.stderr}")
    cdll = ctypes.CDLL(lib)
    fns = {}
    for sfx in ("f32", "f64"):
        fn = getattr(cdll, f"psq_viterbi_obs_{sfx}")
        fn.argtypes, fn.restype = _OBS_SIG, ctypes.c_int
        fns[sfx] = fn
    return fns, ptxas_usage(proc.stderr)


def parent_call(fns, lvl, sd, valid, tabs):
    """The parent's kernel on these operands, on the path its rule picks."""
    import torch

    from poreseq_tpu_torch._build import dtype_suffix, ptr, stream

    B, R, E = lvl.shape
    obs = torch.empty((B, R, 1024), dtype=lvl.dtype, device=lvl.device)
    path = 0 if E <= 32 else 1 if E <= 8192 else 2
    err = fns[dtype_suffix(lvl.dtype)](ptr(lvl), ptr(sd), ptr(valid),
                                       ptr(tabs), ptr(obs), B, R, E, path,
                                       stream(lvl.device))
    if err:
        raise RuntimeError(f"parent viterbi_obs: CUDA error {err}")
    return obs


def operands(shape: str, seed: int, dt):
    import chip_smoke

    if shape == "30X":
        return chip_smoke.coverage_obs_operands(seed, dt)
    if shape == "30X-loader":
        return chip_smoke.loader_obs_operands(seed, dt)
    E = int(shape)
    B, R = chip_smoke.OBS_SHAPES[E]
    return chip_smoke.obs_shape_inputs(seed, B, R, E, dt)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, metavar="DIR")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--shapes", default="30X,60,64,65,100,257,1024,8193")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("obs_instances: needs a CUDA card")
    from chip_smoke import event_ms, gpu_line, ptxas_usage, queued_ms, timed
    from poreseq_tpu_torch.engine.roofline import viterbi_obs_work
    from poreseq_tpu_torch.engine.viterbi import (OBS_PATHS, VITERBI_OBS,
                                                  obs_multi_cuda,
                                                  obs_multi_reference,
                                                  trim_counts)

    t0 = time.perf_counter()
    VITERBI_OBS.lib()
    print(f"[obs_instances] build {VITERBI_OBS.build_seconds:.1f} s",
          flush=True)
    for line in ptxas_usage(VITERBI_OBS.build_log):
        print(f"[obs_instances] ptxas {line}", flush=True)
    fns = None
    if args.parent:
        fns, lines = parent_entry(args.parent)
        for line in lines:
            print(f"[obs_instances] ptxas parent {line}", flush=True)
    for shape in args.shapes.split(","):
        for sfx in args.dtypes.split(","):
            dt = getattr(torch, DTYPES[sfx])
            ops = operands(shape, args.seed, dt)
            B, R, E = ops[0].shape
            ref = obs_multi_reference(*ops)
            runs = {name: (lambda n=name: obs_multi_cuda(*ops, instance=n))
                    for cap, name in OBS_PATHS if cap is None or E <= cap}
            if fns:
                runs["parent"] = lambda: parent_call(fns, *ops)
            for name, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    bad = int((got != ref).sum())
                    raise SystemExit(
                        f"obs_instances: {name} at {shape} {sfx} differs "
                        f"from the twin in {bad} of {got.numel()}")
            del ref, got
            work = viterbi_obs_work(ops[0], ops[2], ops[3])
            # about 0.3 s of launches a timing
            t1 = time.perf_counter()
            for fn in runs.values():
                fn()
            torch.cuda.synchronize()
            each = (time.perf_counter() - t1) / len(runs)
            reps = int(min(max(0.3 / max(each, 1e-6), 3), 20))
            order = list(runs)
            order = ([n for n in order if n == "parent"]
                     + [n for n in order if n != "parent"])
            times = {}
            for name in order + order[::-1]:
                d = timed(event_ms(runs[name], reps), work, dt)
                d["queued_ms"] = queued_ms(runs[name], reps)
                times.setdefault(name, []).append(d)
            nlik, nskip = trim_counts(ops[2])
            print("[obs_instances] " + json.dumps(dict(
                shape=shape, dtype=sfx, B=B, R=R, E=E,
                valid_pairs=int(nlik.sum()), rows=int((nlik > 0).sum()),
                rows_past_8=int((nskip > 8).sum()), reps=reps,
                times=times, card=gpu_line())), flush=True)
            del ops
            torch.cuda.empty_cache()
    print(f"[obs_instances] done in {time.perf_counter() - t0:.1f} s | "
          f"{gpu_line()}", flush=True)


if __name__ == "__main__":
    main()
