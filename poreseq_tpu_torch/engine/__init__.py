"""TorchEngine: the lockstep consensus engine on PyTorch and CUDA.

Counterpart of ``poreseq_tpu/engine/tpu/__init__.py:TpuEngine`` with the
same primitive surface, so the port's host pipeline (``pipeline.mutate_many``
-> ``engine/multi.py``, copies of the JAX package's) drives it as the JAX
one drives TpuEngine.
Every entry point runs the multi-region path: events of R regions share one
device batch, one fill program and one group-scorer launch per class.

The device is explicit: every tensor is created on ``device``.  On
``device="cpu"`` the kernel wrappers run their plain PyTorch twins; on a
CUDA device they launch the hand kernels of ``csrc/`` or raise.  With a
``mesh`` (``parallel/mesh.py``) one region's events shard over its 'ev'
axis and its mutation groups over 'mut': the fills, the backtrace and the
group scorer run per shard on the shard's device, and the results equal the
single device's bit for bit; the Viterbi stage runs on the mesh's first
device, which is the engine's ``device``.

A failure inside an engine call (a build, a refused launch, a device fault,
a bad operand) leaves it as ``EngineError``, so the CLI's per-region failure
units can tell it from a region's own failure and let it end the run.
Running out of memory leaves unchanged: the CLI retries smaller batches.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..core.sequence import seq_to_states
from ..parallel.mesh import ShardedBatch
from .align import fwd_dev, fwd_dev_sharded, fwd_likes
from .pack import (event_ref_indexes, fill_geometry, pack_events, place_full,
                   round_up, to_device_batch)
from .sw import map_alignments as _map_alignments
from .sw import swalign as _swalign
from .types import AlignData


class EngineError(RuntimeError):
    """A TorchEngine call failed; the cause is chained (``__cause__``)."""


def _engine_call(fn):
    """Re-raise what escapes ``fn`` as EngineError, except running out of
    memory."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (EngineError, torch.cuda.OutOfMemoryError, MemoryError):
            raise
        except Exception as e:
            raise EngineError(f"{fn.__name__}: {type(e).__name__}: {e}") \
                from e

    return call


class TorchEngine:
    """Engine of the port's ``api.PSAlign`` and lockstep drivers (and a
    drop-in for the JAX package's, which the tests use).  dtype float32 is the production type; float64 is the parity
    path held against the JAX engine and the exact oracle."""

    name = "torch"

    #: event-row budget per candidate-scoring fill (engine/multi.py chunks
    #: (region, candidate) snapshots up to this many rows per dispatch);
    #: chunking does not change results
    wave_rows = 512

    def __init__(self, device="cuda", dtype=torch.float32, seed: int = 0,
                 mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            if {d.type for r in mesh.devices for d in r} != {
                    self.device.type}:
                raise ValueError(f"TorchEngine: {mesh} is not all on "
                                 f"{self.device.type}")
            self.device = mesh.first
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchEngine(device='cuda'): CUDA is not "
                               "available")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"TorchEngine: unsupported device {device!r}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"TorchEngine: dtype {dtype} (need float32 or "
                             "float64)")
        self.dtype = dtype
        self.seed = seed
        # event level/model data is constant across engine calls (only
        # ref_align changes, host-side), so the batch upload happens once
        # per region set
        self._bcache: dict = {}
        self._bcache_order: list = []
        # deferred ref_like reads: id(ev) -> (ev, device rlk [E, T], row),
        # materialized at sync points (flush_ref_likes)
        self._rlk_pending: dict = {}

    # ---------------- packing / cache ----------------

    @staticmethod
    def _fingerprint(events):
        # prob_* participate: train iterations vary only the transition
        # probabilities while levels stay identical
        return (len(events),) + tuple(
            (len(ev.mean),
             float(ev.mean[0]) if len(ev.mean) else 0.0,
             float(ev.model.level_mean[0]),
             float(ev.model.prob_skip), float(ev.model.prob_stay),
             float(ev.model.prob_extend), float(ev.model.prob_insert))
            for ev in events)

    def _batch_for(self, events, ref_indexes):
        """Packed arrays + device batch for an event list (a ShardedBatch on
        a mesh), cached by content fingerprint; `active` refreshed from the
        given ref_indexes."""
        fp = self._fingerprint(events) + (repr(self.mesh),)
        hit = self._bcache.get(fp)
        if hit is not None:
            batch, arrays = hit
            E_pad = len(arrays["n0"])
            ref_indexes = list(ref_indexes)
            ref_indexes += [np.zeros(0)] * (E_pad - len(ref_indexes))
            active = np.array([len(r) > 0 for r in ref_indexes])
            if not np.array_equal(active, arrays["active"]):
                arrays = dict(arrays, active=active)
                batch = self._with_active(batch, active)
                self._bcache[fp] = (batch, arrays)
        else:
            if self.mesh is not None:
                arrays, ref_indexes = pack_events(events,
                                                  e_div=self.mesh.n_ev)
                batch = ShardedBatch.upload(self.mesh, arrays, self.dtype)
            else:
                arrays, ref_indexes = pack_events(events)
                batch = to_device_batch(arrays, self.dtype, self.device)
            self._bcache[fp] = (batch, arrays)
            self._bcache_order.append(fp)
            if len(self._bcache_order) > 4:
                self._bcache.pop(self._bcache_order.pop(0), None)
        return batch, arrays, ref_indexes

    def _with_active(self, batch, active: np.ndarray):
        if self.mesh is not None:
            return batch.with_active(active)
        return batch._replace(
            active=torch.as_tensor(active, device=self.device))

    def _prepare_multi(self, datas: list[AlignData], participate=None):
        """Combined context for R regions: one packed batch, per-event
        states [C, E], per-event sequence lengths, region ids."""
        events = [ev for d in datas for ev in d.events]
        ris = [event_ref_indexes(ev) for ev in events]
        batch, arrays, ref_indexes = self._batch_for(events, ris)
        n0 = arrays["n0"]
        E = len(n0)

        ev_region = np.full(E, -1, dtype=np.int32)
        ev_region[: len(events)] = np.repeat(
            np.arange(len(datas), dtype=np.int32),
            [len(d.events) for d in datas])

        states_list = [seq_to_states(d.sequence) for d in datas]
        S_list = [len(s) for s in states_list]
        # at least one dead (all-zero) padding column past each S: the
        # mutation scorer reads it for rab=0 (no-suffix) joins
        C = round_up(max(S_list) + 8, 64)
        S_e = np.zeros(E, dtype=np.int64)
        states2 = np.full((C, E), -1, dtype=np.int32)
        for e in range(len(events)):
            r = ev_region[e]
            S_e[e] = S_list[r]
            states2[: S_list[r], e] = states_list[r]

        if participate is not None:
            mask = np.array([participate[r] if r >= 0 else False
                             for r in ev_region])
            active = arrays["active"] & mask
            arrays = dict(arrays, active=active)
            batch = self._with_active(batch, active)

        return dict(batch=batch, arrays=arrays, ref_indexes=ref_indexes,
                    n0=n0, E=E, ev_region=ev_region, S_list=S_list,
                    S_e=S_e, C=C, states2=states2)

    # ---------------- deferred ref_like ----------------

    def _defer_rlk(self, ev, rlk_dev, row: int):
        self._rlk_pending[id(ev)] = (ev, rlk_dev, row)
        # bound the device memory pinned by pending fills: paths without a
        # sync point would otherwise pin one [E, T] buffer per call
        if len({id(dev) for _, dev, _ in self._rlk_pending.values()}) > 4:
            self.flush_ref_likes()

    @_engine_call
    def flush_ref_likes(self):
        """Materialize pending ref_like rows (one device read per distinct
        fill output).  Called at sync points (before AlignData.sync_back)."""
        by_arr: dict = {}
        for ev, dev, row in self._rlk_pending.values():
            by_arr.setdefault(id(dev), (dev, []))[1].append((ev, row))
        for dev, items in by_arr.values():
            h = dev.to(torch.float64).cpu().numpy()
            for ev, row in items:
                ev.ref_like = place_full(ev, h[row])
        self._rlk_pending.clear()

    @staticmethod
    def _likes_slice(vals_row, S_r: int, n_bases: int) -> np.ndarray:
        """Place the device-selected values (vals[k] = score of the last
        aligned level at/before ref index k+1) into the per-base likes
        layout."""
        out = np.zeros(n_bases, dtype=np.float64)
        lim = min(S_r + 3, n_bases - 1)
        if lim >= 2:
            out[2 : lim + 1] = vals_row[: lim - 1]
        return out

    # ---------------- engine primitives ----------------

    def score_alignments(self, data: AlignData, likes=None):
        return self.score_alignments_multi([data], [likes])[0]

    @_engine_call
    def score_alignments_multi(self, datas: list[AlignData], likes_list=None,
                               participate=None, likes_only=False,
                               defer=False):
        """ScoreAlignments for R regions in one fill + backtrace: realign all
        events (updating them in place), return per-region score lists,
        optionally accumulate per-region per-base likes.

        participate: optional [R] bools; regions marked False are skipped.
        likes_only: candidate scoring; events are NOT updated and only
        scores and likes values are read back.
        defer: return a zero-arg finish() that performs the reads."""
        if likes_list is None:
            likes_list = [None] * len(datas)
        if participate is None:
            participate = [True] * len(datas)
        ctx = self._prepare_multi(datas, participate=participate)
        arrays = ctx["arrays"]
        p = datas[0].params
        fi = fill_geometry(arrays, ctx["ref_indexes"], ctx["S_e"], ctx["C"],
                           p.realign_width)
        T = arrays["mean"].shape[1]
        geom = (ctx["states2"], fi["i0"], fi["i1"], fi["is_pad"])
        if self.mesh is None:
            geom = tuple(torch.as_tensor(x, device=self.device) for x in geom)
        args = (ctx["batch"], *geom, float(p.lik_offset), p.realign_width, T,
                int(ctx["C"] + 2 * T + 8), int(ctx["C"]))
        ral = rlk = None
        if self.mesh is not None:
            out = fwd_dev_sharded(self.mesh, *args, likes_only=likes_only)
            if likes_only:
                best, vals = out
            else:
                best, ral, rlk, vals = out
        elif likes_only:
            best, vals = fwd_likes(*args)
        else:
            best, ral, rlk, vals = fwd_dev(*args)

        def finish():
            ral_h = (ral.to(torch.float64).cpu().numpy()
                     if ral is not None else None)
            best_h = best.to(torch.float64).cpu().numpy()
            any_likes = any(l is not None for l in likes_list)
            vals_h = (vals.to(torch.float64).cpu().numpy() if any_likes
                      else None)
            out = []
            e = 0
            for r, data in enumerate(datas):
                if not participate[r]:
                    e += len(data.events)
                    out.append(None)
                    continue
                scores = []
                S_r = ctx["S_list"][r]
                n_bases = len(data.sequence)
                for ev in data.events:
                    if ral_h is not None and arrays["active"][e]:
                        ev.ref_align = place_full(ev, ral_h[e])
                        self._defer_rlk(ev, rlk, e)
                    scores.append(float(best_h[e]))
                    if likes_list[r] is not None:
                        likes_list[r] += self._likes_slice(vals_h[e], S_r,
                                                           n_bases)
                    e += 1
                out.append(scores)
            return out

        return _engine_call(finish) if defer else finish()

    @_engine_call
    def map_alignments(self, data: AlignData, newseq: str):
        # host Smith-Waterman remap (csrc/psq_exact.cpp)
        return _map_alignments(data, newseq)

    def score_mutations(self, data: AlignData, muts):
        return self.score_mutations_multi([data], [muts])[0]

    @_engine_call
    def score_mutations_multi(self, datas, muts_list):
        from .mutscore import score_mutations_multi

        p = datas[0].params
        if p.verbose:
            sys.stderr.write("Scoring[torch] ({})".format(p.scoring_width))
        out = score_mutations_multi(self, datas, muts_list)
        if p.verbose:
            sys.stderr.write("\n")
        return out

    def viterbi_mutate(self, events, nkeep, skip_prob, stay_prob, mut_min,
                       mut_max, verbose=False):
        return self.viterbi_mutate_multi([events], nkeep, skip_prob,
                                         stay_prob, mut_min, mut_max,
                                         verbose)[0]

    @_engine_call
    def viterbi_mutate_multi(self, events_lists, nkeep, skip_prob, stay_prob,
                             mut_min, mut_max, verbose=False):
        """ViterbiMutate for R regions in one batched sweep; the draws are
        counter-based on the engine's seed, so a region's candidates do not
        depend on the other regions of the call."""
        from .viterbi import viterbi_mutate_multi

        return viterbi_mutate_multi(events_lists, nkeep, skip_prob,
                                    stay_prob, mut_min, mut_max, self.device,
                                    self.dtype, self.seed)

    @staticmethod
    def swalign(seq1: str, seq2: str):
        return _swalign(seq1, seq2)
