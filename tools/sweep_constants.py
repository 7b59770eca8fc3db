#!/usr/bin/env python3
"""Time variants of a hand kernel's compile-time constants on one card.

    python3 tools/sweep_constants.py KERNEL NAME=V1,V2 ... [--seed N]
                                     [--obs-shape 30X|E] [--obs-instance I]

KERNEL is one of viterbi_obs, likes, viterbi_gumbel, geom, mutscore,
geom_cluster.  For every
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

    python3 tools/sweep_constants.py mutscore GCL_THREADS=512 GCL_RPT=2,4
                                     [--ws 4097,8193,16385]
                                     [--pairs 400,1600,6400]

times the group scorer's cluster instance (csrc/mutscore.cu group_kernel<T,
GCL_RPT, true>; its span a CTA is GCL_THREADS x GCL_RPT window rows) of each
variant against the wide instance, in turns (cluster, wide, wide, cluster),
at each window width Ws and count of (group, event row) pairs, f32 and f64:
the groups of chip_smoke.py phase 2's small region at scoring width (Ws -
1) / 2 (8 event rows, SCAN_WIDE_MUTS random mutations), repeated up to the
pair count.  Each variant's deltas must equal the wide instance's bit for
bit, and its totals at the region's own groups the twin's (f64: equal).
One line `[sweep] {json}` a variant and shape, with the queued ms of each
turn and the ratio cluster / wide: the span with the least cluster time
is csrc/mutscore.cu's, and with it the largest pair count at which the
cluster instance measured faster at each width is engine/mutscore.py
GROUP_CLUSTER_PAIRS.

    python3 tools/sweep_constants.py geom_cluster CTAS=need,4,8,16
                                     [GCL_CPT=1,2,4]
                                     [--levels 1.0045,2,4,8,15.9]
                                     [--rows 8,32,64,128]

times the geometry's cluster instance at each cluster size (CTAS: a
launch argument, "need" the fewest CTAs that hold the row; any other axis
a constant of csrc/geom.cu, each combination built) against the memory
instance, in turns, on chip_smoke._long_rows' rows of T = LEVELS x
GEOM_MAX_LEVELS levels (C = T columns) on ROWS events, f32 and f64, each
held to the twin: the size that measured fastest is engine/mutscore.py
GEOM_CLUSTER_CTAS, and the most events at which it measured faster than
the memory instance GEOM_CLUSTER_ROWS.
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
# null, and a cluster size of 0, run the staged instance, which the sweep
# times) and the ctypes of its integer arguments (the Gumbel kernel's seed
# is 64-bit)
_I, _U64 = ctypes.c_int, ctypes.c_uint64
SOURCES = {"viterbi_obs": ("viterbi_obs", "psq_viterbi_obs", 0,
                           (_I, _I, _I, _I)),
           "likes": ("likes", "psq_likes", 0, (_I, _I, _I)),
           "viterbi_gumbel": ("viterbi_gumbel", "psq_viterbi_gumbel", 0,
                              (_I, _I, _U64)),
           "geom": ("geom", "psq_geom", 1, (_I, _I, _I, _I, _I))}


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
    return ins, geom_reference(*ins, sw, C), (E, T, C, sw, 0)


def scorer_operands(seed: int, Ws: int, dtype):
    """group_totals_cuda's arguments at window width Ws: phase 2's small
    region at scoring width (Ws - 1) / 2, its largest launch's real
    groups."""
    import numpy as np

    import chip_smoke
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.mutscore import group_launches

    engine = TorchEngine("cuda", dtype)
    sw = (Ws - 1) // 2
    data = chip_smoke._session(seed, sw, scoring_width=sw,
                               **chip_smoke.SCAN_WIDE_REGION)
    muts = chip_smoke._random_mutations(
        data.sequence, np.random.default_rng(seed + 2),
        chip_smoke.SCAN_WIDE_MUTS)
    return max(((gp["G"], chip_smoke._groups(a, gp["G"]))
                for gp, _, a in group_launches(engine, [data], [muts],
                                               [True])),
               key=lambda x: x[0])[1]


def repeat_groups(base, pairs: int):
    """base's groups repeated (groups are independent) to about `pairs`
    (group, event row) pairs."""
    import torch

    G0, E_g = base[13]["g_start"].shape[0], base[21]
    idx = torch.arange(max(1, -(-pairs // E_g)), device="cuda") % G0
    return (*base[:13], {k: v[idx].contiguous() for k, v in
                         base[13].items()}, *base[14:])


def _load_variant(kernel, lib: str):
    """A variant's library in place of kernel's own (its signatures)."""
    cdll = ctypes.CDLL(lib)
    for fn, argtypes in kernel._signatures.items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    kernel._lib = cdll


def sweep_scorer(args, combos, paths, built, queued_ms):
    """The mutscore sweep (the module docstring), a window width's operands
    at a time; returns the variants that differ."""
    import torch

    import chip_smoke
    from poreseq_tpu_torch.engine import mutscore

    bad, real = 0, mutscore.MUTSCORE.lib()
    for values, (ok, _) in zip(combos, built):
        if not ok:
            print("[sweep] " + json.dumps(dict(
                kernel="mutscore", constants=values, built=False)),
                flush=True)
    try:
        for d, dt in (("f32", torch.float32), ("f64", torch.float64)):
            c = "f" if d == "f32" else "d"
            for Ws in (int(w) for w in args.ws.split(",")):
                mutscore.MUTSCORE._lib = real
                base = scorer_operands(args.seed, Ws, dt)
                t_r = chip_smoke._twin_totals(base)
                t_w = mutscore.group_totals_cuda(*base, instance="wide")[0]
                for pairs in (int(p) for p in args.pairs.split(",")):
                    mutscore.MUTSCORE._lib = real
                    a = repeat_groups(base, pairs)
                    ref = mutscore.group_totals_cuda(*a, instance="wide")
                    for values, (_, lib), (ok, log) in zip(combos, paths,
                                                           built):
                        span = (int(values["GCL_THREADS"])
                                * int(values["GCL_RPT"]))
                        ctas = max(1, -(-(Ws - 1) // span))
                        if not ok or ctas > mutscore.CLUSTER_MAX:
                            continue    # past the variant's widest cluster
                        _load_variant(mutscore.MUTSCORE, lib)
                        tot, dl = mutscore.group_totals_cuda(
                            *a, instance="cluster")
                        tb = mutscore.group_totals_cuda(
                            *base, instance="cluster")[0]
                        equal = (torch.equal(dl, ref[1])
                                 and torch.equal(tot, ref[0])
                                 and torch.equal(tb, t_w)
                                 and (d == "f32" or torch.equal(tb, t_r)))
                        bad += not equal
                        runs = {"cluster": [], "wide": []}
                        for inst in ("cluster", "wide", "wide", "cluster"):
                            runs[inst].append(queued_ms(
                                lambda: mutscore.group_totals_cuda(
                                    *a, instance=inst), 5))
                        G, E_g = a[13]["g_start"].shape[0], a[21]
                        print("[sweep] " + json.dumps(dict(
                            kernel="mutscore", constants=values, built=True,
                            dtype=d, Ws=Ws, pairs=G * E_g, G=G, E_g=E_g,
                            ctas=ctas, equal=equal,
                            cluster_ms=runs["cluster"], wide_ms=runs["wide"],
                            cluster_over_wide=sum(runs["cluster"])
                            / sum(runs["wide"]),
                            ptxas=[u.split(": ")[1]
                                   for u in chip_smoke.ptxas_usage(log)
                                   if re.search(f"group_kernelI{c}Li\\d+ELb1E",
                                                u.split(":")[0])],
                            card=chip_smoke.gpu_line())), flush=True)
                    del a, ref
                del base, t_r, t_w
                torch.cuda.empty_cache()
    finally:
        mutscore.MUTSCORE._lib = real
    return bad


def sweep_geom_cluster(args, sizes, variants, queued_ms):
    """The geom_cluster sweep (the module docstring): each cluster size of
    each variant ((constants, library or None: the repo's own)) against the
    memory instance; returns the launches that differ from the twin."""
    import numpy as np
    import torch

    import chip_smoke
    from poreseq_tpu_torch.engine import mutscore
    from poreseq_tpu_torch.engine.mutscore import (GEOM_MAX_LEVELS,
                                                   geom_cuda, geom_reference)
    from poreseq_tpu_torch.engine.roofline import bound_ms, geom_work

    bad, real = 0, mutscore.GEOM.lib()
    try:
        for d, dt in (("f32", torch.float32), ("f64", torch.float64)):
            cap = GEOM_MAX_LEVELS[dt]
            for mult in (float(x) for x in args.levels.split(",")):
                T = int(mult * cap)
                need = -(-T // cap)
                for E in (int(x) for x in args.rows.split(",")):
                    ral, n0, S_e = chip_smoke._long_rows(
                        np.random.default_rng(args.seed + T), E, T)
                    t = lambda x: torch.as_tensor(x, device="cuda")
                    a = (t(ral).to(dt), t(n0), t(S_e), 600, T)
                    ref = geom_reference(*a)
                    b_ms = bound_ms(*geom_work(a[0], a[1], T), dt)[0]
                    insts = [("cluster", need if v == "need" else int(v))
                             for v in sizes]
                    insts = [i for i in dict.fromkeys(insts)
                             if need <= i[1] <= 16]
                    runs = {f"{inst[0]} {inst[1]}" + "".join(
                        f" {k}={v}" for k, v in values.items()): (lib, inst)
                        for values, lib in variants for inst in insts}
                    runs["memory 0"] = (None, ("memory", 0))
                    line = dict(kernel="geom_cluster", dtype=d, T=T, E=E,
                                need=need, bound_ms=b_ms, ms={})

                    def launch(lib, inst):
                        mutscore.GEOM._lib = real
                        if lib:
                            _load_variant(mutscore.GEOM, lib)
                        return lambda: geom_cuda(*a, instance=inst)

                    for key, (lib, inst) in runs.items():
                        equal = all(torch.equal(x, y) for x, y in zip(
                            launch(lib, inst)(), ref))
                        bad += not equal
                        line["ms"][key] = dict(equal=equal, queued_ms=[])
                    for key in list(runs) + list(runs)[::-1]:
                        line["ms"][key]["queued_ms"].append(
                            queued_ms(launch(*runs[key]), 5))
                    line["card"] = chip_smoke.gpu_line()
                    print("[sweep] " + json.dumps(line), flush=True)
                    del ral, a, ref
    finally:
        mutscore.GEOM._lib = real
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=tuple(SOURCES) + ("mutscore",
                                                        "geom_cluster"))
    ap.add_argument("constants", nargs="+", metavar="NAME=V1,V2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-shape", default=None, metavar="30X|E")
    ap.add_argument("--obs-instance", default=None, metavar="NAME")
    ap.add_argument("--ws", default="4097,8193,16385")
    ap.add_argument("--pairs", default="400,1600,6400")
    ap.add_argument("--levels", default="1.0045,2,4,8,15.9")
    ap.add_argument("--rows", default="8,32,64,128")
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
    sizes = None
    if args.kernel == "geom_cluster":
        # CTAS is a launch argument; any other axis a constant of geom.cu
        sizes = dict(axes).pop("CTAS", None)
        if sizes is None:
            raise SystemExit("sweep_constants: geom_cluster takes CTAS=...")
        combos = [{k: v for k, v in c.items() if k != "CTAS"}
                  for c in combos]
        combos = list({json.dumps(c): c for c in combos}.values())
        if combos == [{}]:
            bad = sweep_geom_cluster(args, sizes, [({}, None)], queued_ms)
            if bad:
                raise SystemExit(f"sweep_constants: {bad} geometry launches "
                                 "differ from the twin")
            return
    src_name, fn, nulls, int_types = SOURCES.get(
        args.kernel, (args.kernel.split("_")[0], None, None, None))
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
        if args.kernel == "mutscore":
            bad = sweep_scorer(args, combos, paths, built, queued_ms)
            if bad:
                raise SystemExit(f"sweep_constants: {bad} variants differ "
                                 "from the wide instance or the twin")
            return
        if args.kernel == "geom_cluster":
            for values, (ok, log) in zip(combos, built):
                print("[sweep] " + json.dumps(dict(
                    kernel="geom_cluster", constants=values, built=ok,
                    ptxas=[u.split(": ")[1]
                           for u in chip_smoke.ptxas_usage(log)
                           if "geom_cluster_kernel" in u])), flush=True)
            bad = sweep_geom_cluster(
                args, sizes, [(v, lib) for v, (_, lib), (ok, _) in
                              zip(combos, paths, built) if ok], queued_ms)
            if bad:
                raise SystemExit(f"sweep_constants: {bad} geometry launches "
                                 "differ from the twin")
            return
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
