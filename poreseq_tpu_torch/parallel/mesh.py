"""Device mesh over (event, mutation-group) axes.

Counterpart of ``poreseq_tpu/parallel/mesh.py``.  One region's events shard
over 'ev' (the reference's "different events simultaneously",
MakeMutations.cpp:20-22) and its mutation groups over 'mut' (independent
per mutation, MakeMutations.cpp:43-52); regions stay whole, spread over
processes as the reference's file-split mode does (``parallel/distributed``).

The mesh is one process driving a grid of torch devices, with no
torch.distributed and no collective.  Each shard's kernels launch under its
own device, on that device's current stream (``_build.Kernel.call``), so
shards on different cards overlap.  A device may repeat: ``["cpu"] * 4`` on
the CPU, ``[cuda:0] * 4`` on one card.  Work that every shard of a mesh row
needs (the fills of the row's events) runs once per distinct device of the
row.

The sum over 'ev' is no collective either: each shard's per-event deltas
are placed at their global rows on the 'mut' shard's first device and
summed there by the single-device scorer's own fixed-order step
(``engine/mutscore.sum_rows``), so the totals, and the accept decisions,
equal the single-device engine's bit for bit.  JAX's ``psum`` equals its
single device only up to reassociation.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np
import torch

from .._build import KERNELS


class Mesh:
    """An (n_ev, n_mut) grid of torch devices; ``devices[i][j]`` holds 'ev'
    shard i's events and 'mut' shard j's groups.  ``launches`` counts the
    kernel launches made for each shard: {(i, j, kernel name): n}, a fill
    shared by the shards of one device credited to each of them."""

    def __init__(self, devices):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError(f"Mesh: need a non-empty rectangular grid of "
                             f"devices, got {devices!r}")
        self.devices = grid
        self.launches: Counter = Counter()

    @property
    def n_ev(self) -> int:
        return len(self.devices)

    @property
    def n_mut(self) -> int:
        return len(self.devices[0])

    @property
    def first(self) -> torch.device:
        """Where gathered outputs, the reduction's result and everything
        unsharded (the Viterbi stage) live."""
        return self.devices[0][0]

    def row_devices(self, i: int) -> list:
        """The distinct devices of mesh row i, in 'mut' order."""
        return list(dict.fromkeys(self.devices[i]))

    def serves(self, i: int, device) -> list:
        """The 'mut' indexes j of row i whose device is ``device``."""
        return [j for j, d in enumerate(self.devices[i]) if d == device]

    def __repr__(self):
        return (f"Mesh({self.n_ev}x{self.n_mut}, "
                f"{[[str(d) for d in r] for r in self.devices]})")

    @contextlib.contextmanager
    def on(self, i: int, js):
        """Credit the kernel launches made inside the block to shards
        (i, j) for j in js."""
        before = [k.launches for k in KERNELS]
        try:
            yield
        finally:
            for k, b in zip(KERNELS, before):
                if k.launches > b:
                    for j in js:
                        self.launches[(i, j, k.name)] += k.launches - b

    def shard_launches(self) -> dict:
        """{(i, j): {kernel name: launches}} for every shard."""
        out = {(i, j): {} for i in range(self.n_ev)
               for j in range(self.n_mut)}
        for (i, j, name), n in sorted(self.launches.items()):
            out[(i, j)][name] = n
        return out


def make_mesh(n_ev: int | None = None, n_mut: int = 1,
              devices=None) -> Mesh:
    """Mesh of shape (n_ev, n_mut) over ``devices`` (default: every CUDA
    device, cuda:0 .. cuda:n-1), filled row by row; n_ev defaults to as
    many rows as the devices fill."""
    if devices is None:
        devices = [torch.device(f"cuda:{k}")
                   for k in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_ev is None:
        n_ev = len(devices) // n_mut
    if n_ev < 1 or n_mut < 1 or n_ev * n_mut > len(devices):
        raise ValueError(f"make_mesh({n_ev}, {n_mut}): needs "
                         f"{n_ev * n_mut} devices, have {len(devices)}")
    return Mesh([devices[i * n_mut : (i + 1) * n_mut] for i in range(n_ev)])


def pad_axis(x: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad axis length up to a multiple of n."""
    ln = x.shape[axis]
    rem = (-ln) % n
    if rem == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, rem)
    return np.pad(x, pads, constant_values=fill)


def ev_bounds(E: int, n_ev: int) -> list:
    """Contiguous row ranges [lo, hi) of the n_ev 'ev' shards of E rows."""
    if E % n_ev:
        raise ValueError(f"{E} event rows do not split into {n_ev} shards "
                         "(pack with e_div)")
    step = E // n_ev
    return [(i * step, (i + 1) * step) for i in range(n_ev)]


def shard_rows(x, lo: int, hi: int, device, dim: int = 0) -> torch.Tensor:
    """Rows [lo, hi) of x (numpy or torch) along ``dim`` on ``device``."""
    t = torch.as_tensor(x)
    return t.narrow(dim, lo, hi - lo).to(device).contiguous()


def gather(parts, device, dim: int = 0) -> torch.Tensor:
    """Shard outputs back in global order (shard order) on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim)


class ShardedBatch:
    """A packed event batch split over a mesh's 'ev' axis: ``parts[i]``
    maps each distinct device of mesh row i to an EventBatch of rows
    ``bounds[i]``."""

    def __init__(self, parts: list, bounds: list):
        self.parts = parts
        self.bounds = bounds

    @classmethod
    def upload(cls, mesh: Mesh, arrays: dict, dtype) -> "ShardedBatch":
        from ..engine.pack import to_device_batch

        bounds = ev_bounds(len(arrays["n0"]), mesh.n_ev)
        parts = [{d: to_device_batch({k: np.asarray(v)[lo:hi]
                                      for k, v in arrays.items()}, dtype, d)
                  for d in mesh.row_devices(i)}
                 for i, (lo, hi) in enumerate(bounds)]
        return cls(parts, bounds)

    def with_active(self, active: np.ndarray) -> "ShardedBatch":
        parts = [{d: b._replace(active=torch.as_tensor(active[lo:hi],
                                                       device=d))
                  for d, b in row.items()}
                 for row, (lo, hi) in zip(self.parts, self.bounds)]
        return ShardedBatch(parts, self.bounds)


def sharded_consensus_step(mesh: Mesh, width: int, scoring_width: int,
                           K: int, P: int, DM: int, dtype):
    """One scoring round on the mesh: forward and backward fills over
    events, group deltas over events x groups, the fixed-order sum over
    'ev', and the accept mask.  Returns

      step(arrays, states, i0, i1, is_pad, i0r, i1r, ev_region, gp,
           lik_offset, E_g) -> (scores [E], totals [G, P], accept)

    on the port's fill signature: ``arrays`` is ``pack_events``'s dict (E
    a multiple of n_ev), uploaded in ``dtype``, ``states`` [C, E],
    ``i0``/``i1`` [E, C+1] and ``is_pad`` [C, E] the realign-width band,
    ``i0r``/``i1r`` the scoring-width band, ``gp`` the group arrays of
    ``mutscore._pad_groups`` (host, with g_evoff); outputs on the mesh's
    first device."""
    from ..engine.align import both_dev_sharded
    from ..engine.mutscore import group_totals_sharded, mesh_scoring_inputs

    W = 2 * width + 1
    Ws = 2 * min(scoring_width, width) + 1
    RS = max(width - scoring_width, 0)

    def step(arrays, states, i0, i1, is_pad, i0r, i1r, ev_region, gp,
             lik_offset, E_g):
        batch = ShardedBatch.upload(mesh, arrays, dtype)
        T = arrays["mean"].shape[1]
        C = states.shape[0]
        shards, _, _ = both_dev_sharded(mesh, batch, states, i0, i1, is_pad,
                                        lik_offset, width, T,
                                        int(C + 2 * T + 8))
        mesh_scoring_inputs(shards, batch.bounds, i0r, i1r, ev_region, Ws)
        totals = group_totals_sharded(mesh, shards, batch.bounds, gp,
                                      lik_offset, W, Ws, RS, K, P, DM, E_g)
        firsts = [shards[i][mesh.devices[i][0]] for i in range(mesh.n_ev)]
        scores = gather([torch.maximum(s["bpf"][-1], s["bpb"][1])
                         for s in firsts], mesh.first)
        return scores, totals, totals > 0

    return step
