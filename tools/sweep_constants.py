#!/usr/bin/env python3
"""Time variants of a hand kernel's compile-time constants on one card.

    python3 tools/sweep_constants.py KERNEL NAME=V1,V2 ... [--seed N]
                                     [--obs-shape 30X|E] [--obs-instance I]

KERNEL is one of viterbi_obs, likes, viterbi_gumbel, geom.  For every
combination of the values given, a copy of poreseq_tpu_torch/csrc/<src>.cu
with each `constexpr int NAME = n;` line set to the value is built with
_build.py's nvcc flags (all variants at once; a combination the source's
static_asserts refuse is reported as not built), loaded with ctypes and
launched on the operands of chip_smoke.py's phase 2 in f32 and in f64:
the observations and the Gumbel noise on phase 2b's 8 regions (960 rows,
E_pad 14; 16 candidates; the observations with --obs-shape 30X on the
largest launch of the coverage phase's run, E_pad 60, or at an E of
chip_smoke.OBS_SHAPES,
on --obs-instance NAME of engine/viterbi.py OBS_PATHS, else obs_path's),
the likes and the geometry on a Mutate round's 8-region batch (E = 96, T =
1024, C = 1024).  Each variant's outputs must
equal the plain twin's; its time is profile_phase3.queued_ms of a bare
launch (CUDA events around 20 launches queued behind a spin kernel).  For
each variant one line `[sweep] {json}` follows: the constants, built or
not, and per dtype whether it is equal, its ms, what ptxas reports for
its kernels (registers, spills) and their static SASS instruction counts
(cuobjdump -sass, NOPs left out), and the card's name and power limit.
Needs a CUDA card, nvcc and cuobjdump; exits non-zero when a variant that
builds differs from the twin.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def variant_source(text: str, values: dict) -> str:
    for name, v in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {v};", text)
        if n != 1:
            raise SystemExit(f"sweep_constants: no constant {name}")
    return text


def build(src: str, lib: str) -> tuple[bool, str]:
    from poreseq_tpu_torch import _build

    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", lib, src],
                          capture_output=True, text=True)
    return proc.returncode == 0, proc.stderr


def sass_counts(lib: str) -> dict:
    """{kernel<f|d>: static SASS instructions, NOPs left out} of each
    kernel instance in a built library (cuobjdump -sass)."""
    from poreseq_tpu_torch import _build

    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"([a-z_]+_kernel)I([fd])((?:L[ib]\d+E)*)E",
                      fn.split("\n", 1)[0])
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         fn)
        if m:
            flag = "".join(f", {v}" for v in re.findall(r"L[ib](\d+)E",
                                                         m.group(3)))
            counts[f"{m.group(1)}<{m.group(2)}{flag}>"] = sum(
                o != "NOP" for o in ops)
    return counts


# each kernel's source, its C entry without the dtype suffix, the null
# pointers the entry takes after the outputs' (the geometry's scratch row:
# null runs the staged instance, which the sweep times) and the ctypes of
# its integer arguments (the Gumbel kernel's seed is 64-bit)
_I, _U64 = ctypes.c_int, ctypes.c_uint64
SOURCES = {"viterbi_obs": ("viterbi_obs", "psq_viterbi_obs", 0,
                           (_I, _I, _I, _I)),
           "likes": ("likes", "psq_likes", 0, (_I, _I, _I)),
           "viterbi_gumbel": ("viterbi_gumbel", "psq_viterbi_gumbel", 0,
                              (_I, _I, _U64)),
           "geom": ("geom", "psq_geom", 1, (_I, _I, _I, _I))}


def operands(kernel: str, seed: int, dtype, obs_shape: str | None = None,
             obs_instance: str | None = None):
    """(inputs, the twin's outputs, the C entry's int arguments after the
    pointers) at phase 2's shapes in dtype; the entry takes the inputs'
    and then the outputs' pointers.  The observations: obs_shape `30X` (the
    coverage phase's largest launch) or an E of chip_smoke.OBS_SHAPES in place
    of phase 2b's batch, on obs_instance (else obs_path's choice); the
    coverage phase's launch is taken once (chip_smoke.coverage_obs_operands
    runs its consensus on the card)."""
    import torch

    import chip_smoke
    from poreseq_tpu_torch.engine import TorchEngine

    engine = TorchEngine("cuda", dtype)
    if kernel in ("viterbi_obs", "viterbi_gumbel"):
        from poreseq_tpu_torch.engine.viterbi import (OBS_PATHS,
                                                      gumbel_reference,
                                                      obs_inputs,
                                                      obs_multi_reference,
                                                      obs_path)

        regions = chip_smoke._mut_regions(seed)["refine"][0]
        _, ops, _ = obs_inputs([d.events for d in regions], engine.device,
                               dtype)
        if kernel == "viterbi_obs" and obs_shape == "30X":
            ops = chip_smoke.coverage_obs_operands(seed, dtype)
        elif kernel == "viterbi_obs" and obs_shape:
            ops = chip_smoke.obs_shape_inputs(
                seed, *chip_smoke.OBS_SHAPES[int(obs_shape)], int(obs_shape),
                dtype)
        B, R, E = ops[0].shape
        if kernel == "viterbi_obs":
            path = obs_path(E)[0] if obs_instance is None else [
                n for _, n in OBS_PATHS].index(obs_instance)
            return ops, (obs_multi_reference(*ops),), (B, R, E, path)
        nk = chip_smoke.SAMPLE_ARGS[0]
        rows = torch.arange(R, device=engine.device)
        return [], (gumbel_reference(seed, nk, rows, dtype),), (nk, R, seed)
    from poreseq_tpu_torch.engine.align import likes_reference
    from poreseq_tpu_torch.engine.mutscore import geom_reference

    batch, ral, rlk, S_e, C, sw, _ = chip_smoke._scoring_operands(
        engine, chip_smoke._mut_regions(seed)["mutate"][0])
    E, T = ral.shape
    if kernel == "likes":
        return [ral, rlk], (likes_reference(ral, rlk, C),), (E, T, C)
    ins = [ral, batch.n0, S_e]
    return ins, geom_reference(*ins, sw, C), (E, T, C, sw)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=tuple(SOURCES))
    ap.add_argument("constants", nargs="+", metavar="NAME=V1,V2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-shape", default=None, metavar="30X|E")
    ap.add_argument("--obs-instance", default=None, metavar="NAME")
    args = ap.parse_args()

    import torch

    import chip_smoke
    from poreseq_tpu_torch import _build
    from profile_phase3 import queued_ms

    if not torch.cuda.is_available():
        raise SystemExit("sweep_constants: needs a CUDA card")
    axes = [(c.split("=")[0], c.split("=")[1].split(","))
            for c in args.constants]
    combos = [dict(zip([a for a, _ in axes], vs))
              for vs in itertools.product(*(v for _, v in axes))]
    src_name, fn, nulls, int_types = SOURCES[args.kernel]
    text = (_build.CSRC / f"{src_name}.cu").read_text()
    P = ctypes.c_void_p
    with tempfile.TemporaryDirectory(prefix="psq_sweep_") as tmp:
        paths = []
        for i, values in enumerate(combos):
            src = os.path.join(tmp, f"v{i}.cu")
            with open(src, "w") as f:
                f.write(variant_source(text, values))
            paths.append((src, os.path.join(tmp, f"libv{i}.so")))
        with ThreadPoolExecutor(len(paths)) as ex:
            built = list(ex.map(lambda p: build(*p), paths))
        ops = {d: operands(args.kernel, args.seed, dt, args.obs_shape,
                           args.obs_instance)
               for d, dt in (("f32", torch.float32), ("f64", torch.float64))}
        stream = P(torch.cuda.current_stream().cuda_stream)
        bad = 0
        for values, (_, lib), (ok, log) in zip(combos, paths, built):
            line = dict(kernel=args.kernel, constants=values, built=ok)
            if ok:
                sass = sass_counts(lib)
                for d, (ins, refs, ints) in ops.items():
                    c = "f" if d == "f32" else "d"     # the template's type
                    entry = getattr(ctypes.CDLL(lib), f"{fn}_{d}")
                    assert len(ints) == len(int_types)
                    entry.argtypes = [P] * (len(ins) + len(refs) + nulls) \
                        + list(int_types) + [P]
                    entry.restype = ctypes.c_int
                    outs = [torch.empty_like(r) for r in refs]
                    call = lambda: entry(*(P(x.data_ptr())
                                           for x in [*ins, *outs]),
                                         *[None] * nulls, *ints, stream)
                    if call() != 0:
                        raise SystemExit(f"sweep_constants: {values} {d} "
                                         "refused")
                    torch.cuda.synchronize()
                    equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
                    bad += not equal
                    line[d] = dict(
                        equal=equal, ms=queued_ms(call),
                        ptxas=[u.split(": ")[1]
                               for u in chip_smoke.ptxas_usage(log)
                               if re.search(f"I{c}[EL]", u.split(":")[0])],
                        sass={k: n for k, n in sass.items()
                              if f"<{c}" in k})
            line["card"] = chip_smoke.gpu_line()
            print("[sweep] " + json.dumps(line), flush=True)
    if bad:
        raise SystemExit(f"sweep_constants: {bad} variants differ from the "
                         "twin")


if __name__ == "__main__":
    main()
