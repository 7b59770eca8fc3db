"""Readings for the limits of ``correct``, on the card at a cell's own size.

    python3 -m psq_benchmark.control --workload NAME --seeds S1,S2,... \\
        --seconds S [--control-seeds K]

For each seed, in one process: the cell's run with a window of S seconds
at the cell's own load, and the number each check compares (the sound
port's reading); for the first K seeds also the control's reading, the
reference in bfloat16 put in the port's place and judged by the same
float64 reference on the same regions.  One JSON line a seed, then a
summary line: the largest sound reading (the lower end of a limit) and
the smallest control reading (its upper end).  The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from . import spec
    from .run import run_cell

    if not torch.cuda.is_available():
        sys.stderr.write("psq_benchmark.control: no CUDA card\n")
        return 2
    cell = spec.cell(args.workload)
    sound, ctrl = [], []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        res = run_cell(cell, seed, args.seconds, False, "cuda", t0,
                       control=i < args.control_seeds)
        if res is None:
            return 3
        line = {"seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "sound": res["readings"], "control": res.get("control"),
                "seconds": time.time() - t0}
        print(json.dumps(line), flush=True)
        sound.append(res["readings"])
        if res.get("control"):
            ctrl.append(res["control"])
    print(json.dumps({
        "workload": args.workload,
        "sound_max": {k: max(r[k] for r in sound) for k in sound[0]},
        "control_min": ({k: min(c[k] for c in ctrl) for k in ctrl[0]}
                        if ctrl else None),
        "seeds": len(sound), "control_seeds": len(ctrl)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
