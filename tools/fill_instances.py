#!/usr/bin/env python3
"""The fill past 4095 band rows on one card: its cluster instance against
its wide (memory) instance at the same shapes, in one call.

    python3 tools/fill_instances.py [--widths 4097,6450,8193,12289,16384]
                                    [--rows 8,32,64,96,128]
                                    [--dtypes f32,f64] [--no-hold]
                                    [--seed N]

For each band width W (realign width (W - 1) / 2) the operands are
chip_smoke.py phase 2's: a 240 b region at 8X, its first 8 event rows (C = 256
columns); E rows are those 8 rows repeated. At E = 8 both instances
(csrc/fill.cu: `cluster`, ceil(W / 1024) CTAs an event in a thread-block
cluster; `wide`, one block an event, its column in shared or device memory) are
held to the plain twin (forward with steps and backward without, f32 and f64;
chip_smoke.hold_fill; not with --no-hold), then each (W, E) is timed in each of
--dtypes, the instances in turns (cluster, wide, wide, cluster), each by CUDA
events around 20 launches and by the same launches queued behind a spin kernel
(chip_smoke.queued_ms), beside engine/roofline.py fill_work's least time. Then
the largest cluster the card places: the cluster instance at W = n x 1024 for n
= 9..16 (one event), launched or refused. First the fill's instances' registers
and spills as ptxas reports them; one line `[fill_instances] {json}` per
(W, E, dtype), one for the cluster sizes, then the card's name and power limit. Needs
a CUDA card; any hold that fails exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

INSTANCES = ("cluster", "wide")
RUNS = {"forward": (False, True), "backward": (True, False)}


def operands(engine, W: int, E: int, seed: int):
    """phase 2's fill operands at band width W on E event rows (the
    region's first 8, repeated)."""
    import torch

    from chip_smoke import (SCAN_WIDE_REGION, SCAN_WIDE_ROWS, _fill_inputs,
                            _rows, _session)

    ops = _rows(_fill_inputs(engine, _session(seed, (W - 1) // 2,
                                              **SCAN_WIDE_REGION)),
                slice(0, SCAN_WIDE_ROWS))
    rows = torch.arange(E, device=engine.device) % SCAN_WIDE_ROWS
    return _rows(ops, rows) if E != SCAN_WIDE_ROWS else ops


def hold(W: int, seed: int) -> float:
    """Both instances against the twin at W on 8 rows, f64 and f32."""
    import torch

    from chip_smoke import SCAN_WIDE_ROWS, hold_fill
    from poreseq_tpu_torch.engine import TorchEngine

    err = 0.0
    for dt in (torch.float64, torch.float32):
        ops = operands(TorchEngine("cuda", dt), W, SCAN_WIDE_ROWS, seed)
        for backward, steps in RUNS.values():
            args = (*ops, backward, W, steps)
            cache = {}
            for inst in INSTANCES:
                err = max(err, hold_fill(args, f"fill_instances W={W}",
                                         None, inst, cache))
    return err


def time_shape(W: int, E: int, seed: int, dt) -> dict:
    """Events and queued ms of both instances at (W, E) in dtype dt, in
    turns."""
    import torch

    from chip_smoke import queued_ms, timed
    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.fill import cluster_ctas, fill_cuda
    from poreseq_tpu_torch.engine.roofline import fill_work
    from tools.bench import event_ms

    ops = operands(TorchEngine("cuda", dt), W, E, seed)
    out = dict(W=W, E=E, C=ops[1].shape[0], ctas=cluster_ctas(W),
               dtype=str(dt).removeprefix("torch."))
    for name, (backward, steps) in RUNS.items():
        args = (*ops, backward, W, steps)
        work = fill_work(ops[0], ops[1], ops[4], W, steps)
        runs = {inst: [] for inst in INSTANCES}
        for inst in INSTANCES + INSTANCES[::-1]:
            fn = lambda: fill_cuda(*args, instance=inst)
            runs[inst].append(dict(queued_ms=queued_ms(fn),
                                   **timed(event_ms(fn), work, dt)))
        out[name] = runs
        out[f"{name} cluster/wide"] = (
            sum(r["ms"] for r in runs["cluster"])
            / sum(r["ms"] for r in runs["wide"]))
    return out


def largest_cluster(seed: int) -> dict:
    """{ctas: "placed" or the error} for the cluster instance at W = n x
    1024 (n = 9..16) on one event row."""
    import torch

    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.engine.fill import CLUSTER_SPAN, fill_cuda

    engine = TorchEngine("cuda", torch.float32)
    out = {}
    for n in range(9, 17):
        W = n * CLUSTER_SPAN
        ops = operands(engine, W, 1, seed)
        try:
            fill_cuda(*ops, False, W, False, instance="cluster")
            torch.cuda.synchronize()
            out[n] = "placed"
        except RuntimeError as exc:
            out[n] = str(exc)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="4097,6450,8193,12289,16384")
    ap.add_argument("--rows", default="8,32,64,96,128")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--hold", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fill_instances: needs a CUDA card")
    from chip_smoke import gpu_line, ptxas_usage
    from poreseq_tpu_torch.engine.fill import FILL

    FILL.lib()
    for usage in ptxas_usage(FILL.build_log):
        print(f"[fill_instances] ptxas {usage}", flush=True)
    widths = [int(w) for w in args.widths.split(",")]
    for W in widths if args.hold else ():
        err = hold(W, args.seed)
        print(f"[fill_instances] held W={W}: cluster and wide equal the "
              f"twin, max |diff| {err:.3e}", flush=True)
    line = lambda d: print(f"[fill_instances] {json.dumps(d)}", flush=True)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    for dt in (dtypes[d] for d in args.dtypes.split(",")):
        for W in widths:
            for E in (int(e) for e in args.rows.split(",")):
                line(time_shape(W, E, args.seed, dt))
    line({"largest_cluster": largest_cluster(args.seed)})
    print(gpu_line(), flush=True)


if __name__ == "__main__":
    main()
