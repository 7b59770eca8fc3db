#!/usr/bin/env python3
"""Driver entry points of the port (the counterpart of __graft_entry__.py,
which drives the JAX package): one fill step, and one full consensus
region through the engine on an ev x mut device mesh against one device.

    python3 tools/dryrun.py [N] [--ref-len 1500] [--device cuda]

entry(device)  -> (fn, args): fn(*args) is one forward fill with steps
                  (engine/fill.py get_fill: the kernel on a card, its plain
                  twin on the CPU) over a simulated 64 b region's 4 events
                  at realign width 16; it returns each event's best score.
dryrun_multichip(n, ref_len, device)
               -> a simulated region (seed 0, 3 % draft error, max(4,
                  n_ev) events) polished by Mutate(reps=2),
                  Mutate("viterbi") and Refine() at the production widths
                  300/100/20 on a TorchEngine whose mesh is n_ev x n_mut
                  (n_mut = 2 for an even n): n cards where torch sees that
                  many, else the one card n times (or the CPU n times
                  with --device cpu).  The same session then runs on one
                  device with the mesh's scoring geometry (the host's:
                  PSQ_DEV_GEOM=0, as a mesh takes it) and must end with the
                  same sequence and base count (the mesh sums its totals in
                  the single device's order), else the tool exits
                  non-zero; and once more with the device's own geometry
                  (f32 on one device), whose agreement is reported only (a
                  band edge may move by one row, ROADMAP §C).  At ref_len
                  1500 and width 300 the band moves (C = 1,536 columns
                  against W = 601 rows); __graft_entry__.py's 360 b region
                  never moves it.

Prints the entry's best scores, then ONE JSON line of the dry run:
n_devices, mesh, devices, accuracy before and after, bases mutated, each
run's wall (closed by a synchronize on the card), the launches of each
shard, equal_to_one_device and equal_to_device_geometry.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.bench import fill_case  # noqa: E402

WIDTHS = (300, 100, 20)


def entry(device: str = "cuda"):
    """(fn, args): one forward fill step and its operands."""
    from poreseq_tpu_torch.engine.fill import get_fill

    t = fill_case(device, ref_len=64, coverage=4, width=16)
    fill = get_fill(t["width"], need_steps=True)

    def fn(batch, states, i0, i1, is_pad):
        return fill(batch, states, i0, i1, is_pad, t["lik_offset"],
                    False).best

    return fn, (t["batch"], t["states"], t["i0"], t["i1"], t["is_pad"])


@contextlib.contextmanager
def _host_geometry():
    """The scoring geometry from the host inside the block (PSQ_DEV_GEOM=0,
    engine/mutscore.py group_launches)."""
    old = os.environ.get("PSQ_DEV_GEOM")
    os.environ["PSQ_DEV_GEOM"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PSQ_DEV_GEOM"]
        else:
            os.environ["PSQ_DEV_GEOM"] = old


def mesh_devices(n: int, device: str) -> list:
    """n devices: the first n cards where torch sees that many (and device
    is plain "cuda"), else ``device`` n times."""
    import torch

    if device == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device(f"cuda:{k}") for k in range(n)]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda:0")
    return [dev] * n


def polish(engine, ref_len: int, n_ev: int, widths=WIDTHS) -> dict:
    """__graft_entry__.py:115-130's session on ``engine``: Mutate(reps=2),
    Mutate("viterbi"), Refine(); the final sequence, bases mutated,
    accuracy before and after, wall."""
    from poreseq_tpu_torch.api import swalign
    from poreseq_tpu_torch.sim import simulate_session

    params = dict(realign_width=widths[0], scoring_width=widths[1],
                  point_width=widths[2], verbose=0)
    pa, truth = simulate_session(np.random.default_rng(0), ref_len=ref_len,
                                 coverage=max(4, n_ev), draft_error=0.03,
                                 params=params, engine=engine)
    a0 = swalign(pa.sequence, truth)[0]
    t0 = time.perf_counter()
    nb = pa.Mutate(reps=2)
    pa.Mutate(seqs="viterbi", reps=1)
    nb2 = pa.Refine()
    if engine.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a1 = swalign(pa.sequence, truth)[0]
    return dict(sequence=pa.sequence, bases=nb + nb2, acc0=a0, acc1=a1,
                wall=wall, n_events=len(pa.events))


def dryrun_multichip(n_devices: int, ref_len: int = 1500,
                     device: str = "cuda", widths=WIDTHS) -> dict:
    """One full consensus region through the engine on an n-device mesh,
    then on one device on the mesh's geometry and on its own; the result
    line.  Raises SystemExit if the mesh's sequence or base count differs
    from the one device's on the same (host) geometry."""
    import torch

    from poreseq_tpu_torch.engine import TorchEngine
    from poreseq_tpu_torch.parallel.mesh import make_mesh

    devices = mesh_devices(n_devices, device)
    if devices[0].type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}, but torch sees no CUDA card "
                         "(--device cpu runs the plain twins)")
    n_mut = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_ev = n_devices // n_mut
    mesh = make_mesh(n_ev, n_mut, devices)
    m = polish(TorchEngine(devices[0], mesh=mesh), ref_len, n_ev, widths)
    with _host_geometry():
        one = polish(TorchEngine(devices[0]), ref_len, n_ev, widths)
    own = polish(TorchEngine(devices[0]), ref_len, n_ev, widths)
    equal = m["sequence"] == one["sequence"] and m["bases"] == one["bases"]
    res = dict(
        n_devices=n_devices, mesh=f"{n_ev}x{n_mut}",
        devices=[str(d) for d in devices], ref_len=ref_len,
        widths=list(widths), n_events=m["n_events"],
        accuracy_before_pct=m["acc0"], accuracy_after_pct=m["acc1"],
        bases_mutated=m["bases"], mesh_wall_s=m["wall"],
        one_device_wall_s=one["wall"],
        shard_launches={f"{i}x{j}": n for (i, j), n in
                        mesh.shard_launches().items()},
        equal_to_one_device=equal,
        one_device_bases_mutated=one["bases"],
        equal_to_device_geometry=own["sequence"] == m["sequence"],
        device_geometry_accuracy_pct=own["acc1"])
    if not equal:
        raise SystemExit("dryrun_multichip: the mesh's sequence or base count "
                         "differs from one device's: " + json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--ref-len", type=int, default=1500)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (tests only)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    print("entry:", np.round(fn(*fargs).double().cpu().numpy(), 2).tolist(),
          flush=True)
    print(json.dumps(dryrun_multichip(args.n, args.ref_len, args.device)),
          flush=True)


if __name__ == "__main__":
    main()
