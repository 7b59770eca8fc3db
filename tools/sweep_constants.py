#!/usr/bin/env python3
"""Time variants of a hand kernel's compile-time constants on one card.

    python3 tools/sweep_constants.py {viterbi_obs,likes} NAME=V1,V2 ...
                                     [--seed N]

For every combination of the values given, a copy of
poreseq_tpu_torch/csrc/<kernel>.cu with each `constexpr int NAME = n;` line
set to the value is built with _build.py's nvcc flags (all variants at
once; a combination the source's static_asserts refuse is reported as not
built), loaded with ctypes and launched on the operands of chip_smoke.py's
phase 2 in f32: the observations on phase 2b's 8 regions (960 rows, E_pad
14), the likes on a Mutate round's 8-region batch (E = 96, T = 1024, C =
1024).  Each variant's output must equal the plain twin's; its time is
profile_phase3.queued_ms of a bare launch (CUDA events around 20 launches
queued behind a spin kernel).  For each variant one line
`[sweep] {json}` follows: the constants, built or not, equal, ms, what
ptxas reports for its f32 kernels (registers, spills), and the card's
name and power limit.  Needs a CUDA card and nvcc; exits non-zero when a
variant that builds differs from the twin.
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


def operands(kernel: str, seed: int):
    """(C entry's arguments after the pointers, inputs, twin's output,
    output shape) at phase 2's shapes, f32."""
    import torch

    import chip_smoke
    from poreseq_tpu_torch.engine import TorchEngine

    engine = TorchEngine("cuda", torch.float32)
    if kernel == "viterbi_obs":
        from poreseq_tpu_torch.engine.viterbi import (obs_inputs,
                                                      obs_multi_reference)

        regions = chip_smoke._mut_regions(seed)["refine"][0]
        events = [d.events for d in regions]
        _, ops, _ = obs_inputs(events, engine.device, torch.float32)
        B, R, E = ops[0].shape
        return (B, R, E), ops, obs_multi_reference(*ops), (B, R, 1024)
    from poreseq_tpu_torch.engine.align import likes_reference

    _, ral, rlk, _, C, _, _ = chip_smoke._scoring_operands(
        engine, chip_smoke._mut_regions(seed)["mutate"][0])
    E, T = ral.shape
    return (E, T, C), [ral, rlk], likes_reference(ral, rlk, C), (E, C)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("viterbi_obs", "likes"))
    ap.add_argument("constants", nargs="+", metavar="NAME=V1,V2")
    ap.add_argument("--seed", type=int, default=0)
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
    text = (_build.CSRC / f"{args.kernel}.cu").read_text()
    fn = f"psq_{args.kernel}_f32"
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
        ints, ins, ref, shape = operands(args.kernel, args.seed)
        stream = P(torch.cuda.current_stream().cuda_stream)
        bad = 0
        for values, (_, lib), (ok, log) in zip(combos, paths, built):
            line = dict(kernel=args.kernel, constants=values, built=ok)
            if ok:
                line["ptxas_f32"] = [u.split(": ")[1]
                                     for u in chip_smoke.ptxas_usage(log)
                                     if "IfE" in u.split(":")[0]]
                entry = getattr(ctypes.CDLL(lib), fn)
                entry.argtypes = [P] * (len(ins) + 1) + [ctypes.c_int] * 3 \
                    + [P]
                entry.restype = ctypes.c_int
                out = torch.empty(shape, device="cuda")
                call = lambda: entry(*(P(x.data_ptr()) for x in ins),
                                     P(out.data_ptr()), *ints, stream)
                if call() != 0:
                    raise SystemExit(f"sweep_constants: {values} refused")
                torch.cuda.synchronize()
                line["equal"] = bool(torch.equal(out, ref))
                bad += not line["equal"]
                line["ms"] = queued_ms(call)
            line["card"] = chip_smoke.gpu_line()
            print("[sweep] " + json.dumps(line), flush=True)
    if bad:
        raise SystemExit(f"sweep_constants: {bad} variants differ from the "
                         "twin")


if __name__ == "__main__":
    main()
