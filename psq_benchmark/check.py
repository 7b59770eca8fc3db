"""What decides ``correct``, and the residual errors against the truth.

The reference is ``reference/``: a frozen copy of the port's host layer
and plain PyTorch twins (``TwinEngine``), with a NumPy Smith-Waterman.  It
loads each checked region from the run's files itself and works out every
alignment again; it reads the port's outputs only to judge them.

- ``score_gap`` (variant cells): every score the port printed for a
  checked region against the reference's score of the same mutation, in
  float64: the widest absolute difference, in log-likelihood units.
- ``call_gap`` (consensus cells): one ``score_mutations_multi`` call of
  the port's TorchEngine in the window, drawn from the seed, is recorded
  as it is made (the regions' sequences, their events with the alignment
  the port's earlier rounds left, the mutations, the widths) with the
  scores it returned; the reference scores the same mutations from that
  state in float64.  The widest absolute difference.  This follows the
  port from its own state; the loader it starts from and the rounds it
  skips are judged by ``score_gap``'s cell and by ``optimum_gap``.
- ``optimum_gap`` (consensus cells): the port's polished sequence is
  judged by the rule that ends the polishing: no single-base change should
  raise the reads' likelihood.  The reference realigns the region's reads
  to the polished sequence (flanked by the draft where the output was
  trimmed), scores every single-base mutation of it in float64 as
  ``Refine`` does, and reads, at each position of the judged span, the gap
  by which the kept base lies below the best change there (0 where none
  is better).  The number compared is the largest, over the checked
  regions, of a region's gaps summed per judged kb; the gaps summed over
  all regions and the widest gap are printed beside it.  (The widest gap
  of a sound run swings from seed to seed: the polishing stops after
  ``-i`` rounds and drops conflicting changes, so a few positions of a
  sound output may still gain.)

The control puts the reference in the port's place in bfloat16
(``control=True``): its scores, or at each position its first choice, are
judged by the same float64 reference.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .reference.api import PSAlign
from .reference.core.events import Event, Model
from .reference.core.regions import MutationInfo, RegionInfo
from .reference.engine import TwinEngine
from .reference.engine.driver import find_point_mutations
from .reference.engine.sw import swfull
from .reference.engine.types import AlignData, AlignParams
from .reference.io.load import load_aligned_events

#: positions this far inside the polished output's ends are judged: the
#: flanks outside it are the draft's, not the port's
MARGIN = 30


# ----------------------------------------------------------------- truth


def residual_errors(polished: str, truth_window: str) -> int:
    """Errors of a polished sequence against its truth window: the bases
    of the local alignment that do not match (substitutions and
    insertions), the truth bases it skips inside (deletions), and the
    polished bases outside the local alignment."""
    if not polished:
        return 0
    _, pairs, _ = swfull(polished, truth_window)
    if len(pairs) == 0:
        return len(polished)
    a = np.frombuffer(polished.encode(), dtype=np.uint8)
    b = np.frombuffer(truth_window.encode(), dtype=np.uint8)
    both = (pairs[:, 0] > 0) & (pairs[:, 1] > 0)
    matches = int((a[pairs[both, 0] - 1] == b[pairs[both, 1] - 1]).sum())
    deletions = int((pairs[:, 0] == 0).sum())
    return len(polished) - matches + deletions


# ------------------------------------------------------------- reference


def _load(run: dict, region: str, params: dict) -> PSAlign:
    return load_aligned_events(run["fasta"], run["bam"], run["reads"],
                               RegionInfo(region), dict(params))


def reference_scores(engine, sessions: list, muts_list: list,
                     width: int) -> list:
    """Scores [np.ndarray] of each session's mutations at scoring width
    ``width`` in one batched ScoreMutations of the engine."""
    datas = []
    for pa in sessions:
        d = AlignData.from_session(pa)
        d.params.scoring_width = int(width)
        datas.append(d)
    out = engine.score_mutations_multi(datas, muts_list)
    return [np.array([m.score for m in ms], dtype=np.float64) for ms in out]


def parse_scores(lines: list, region_start: int) -> tuple:
    """(mutations as (start in the region, orig, mut), scores) of one
    region's printed lines ``start orig mut score``."""
    keys, scores = [], []
    for line in lines:
        s, o, m, v = line.split("\t")
        keys.append((int(s) - region_start, "" if o == "." else o,
                     "" if m == "." else m))
        scores.append(float(v))
    return keys, np.array(scores, dtype=np.float64)


def score_gap(run: dict, params: dict, printed: dict, device,
              block: int, control: bool = False) -> float:
    """Widest |port score - reference score| over every printed mutation
    of the checked regions ({region: printed lines}); with ``control`` the
    bfloat16 reference's scores take the port's place."""
    ref = TwinEngine(device, torch.float64)
    low = TwinEngine(device, torch.bfloat16) if control else None
    width = params.get("point_width", params.get("scoring_width"))
    worst = 0.0
    names = sorted(printed)
    for at in range(0, len(names), block):
        part = names[at : at + block]
        sessions, muts_list, port = [], [], []
        for region in part:
            pa = _load(run, region, params)
            keys, scores = parse_scores(printed[region],
                                        RegionInfo(region).start)
            d = AlignData.from_session(pa)
            muts = find_point_mutations(d)
            want = [(m.start, m.orig, m.mut) for m in muts]
            if keys != want:
                return float("inf")        # a mutation missing or altered
            sessions.append(pa)
            muts_list.append(muts)
            port.append(scores)
        ref_s = reference_scores(ref, [p.Copy() for p in sessions],
                                 muts_list, width)
        if control:
            port = reference_scores(low, sessions, muts_list, width)
        for p, r in zip(port, ref_s):
            gap = np.abs(p - r)
            if not np.all(np.isfinite(gap)):
                return float("inf")
            worst = max(worst, float(gap.max()) if len(gap) else 0.0)
    return worst


def _event(ev):
    """A reference Event with the values of an event of the port."""
    model = Model(**{f.name: copy.deepcopy(getattr(ev.model, f.name))
                     for f in dataclasses.fields(Model)})
    return Event(**{f.name: copy.deepcopy(getattr(ev, f.name))
                    for f in dataclasses.fields(Event) if f.name != "model"},
                 model=model)


def snapshot(datas, muts_list) -> dict:
    """What a ``score_mutations_multi`` call of the port is given, copied
    before the call (it realigns the events in place)."""
    return dict(
        regions=[(d.sequence, [_event(ev) for ev in d.events],
                  dict(lik_offset=d.params.lik_offset,
                       scoring_width=d.params.scoring_width,
                       realign_width=d.params.realign_width))
                 for d in datas],
        muts=[[(m.start, m.orig, m.mut) for m in muts] for muts in muts_list])


def call_gap(state: dict, scores: list, device,
             control: bool = False) -> float:
    """Widest |port score - reference score| of one recorded call (see
    ``snapshot``); with ``control`` the bfloat16 reference's scores take
    the port's place."""
    def scored(dtype):
        datas, muts_list = [], []
        for (seq, events, params), muts in zip(state["regions"],
                                               state["muts"]):
            datas.append(AlignData(seq, copy.deepcopy(events),
                                   AlignParams(**params)))
            ms = []
            for start, orig, mut in muts:
                m = MutationInfo()
                m.start, m.orig, m.mut = start, orig, mut
                ms.append(m)
            muts_list.append(ms)
        out = TwinEngine(device, dtype).score_mutations_multi(datas,
                                                             muts_list)
        return [np.array([m.score for m in ms]) for ms in out]

    ref = scored(torch.float64)
    port = scored(torch.bfloat16) if control else [np.asarray(s, float)
                                                    for s in scores]
    if sum(len(r) for r in ref) == 0:
        return float("inf")
    gaps = [np.abs(p - r) for p, r in zip(port, ref) if len(r)]
    if not all(np.all(np.isfinite(g)) for g in gaps):
        return float("inf")
    return float(max(g.max() for g in gaps))


def judged_sequence(draft_region: str, polished: str):
    """The polished output placed in its draft region: (sequence, start,
    end of the judged span in it) or None when the two do not align."""
    _, pairs, _ = swfull(draft_region, polished)
    both = np.nonzero((pairs[:, 0] > 0) & (pairs[:, 1] > 0))[0] \
        if len(pairs) else []
    if len(both) == 0:
        return None
    (d0, o0), (d1, o1) = pairs[both[0]], pairs[both[-1]]
    core = polished[o0 - 1 : o1]
    seq = draft_region[: d0 - 1] + core + draft_region[d1:]
    lo = d0 - 1 + MARGIN
    hi = d0 - 1 + len(core) - MARGIN
    return (seq, lo, hi) if hi > lo else None


def optimum_gap(run: dict, params: dict, outputs: dict, device,
                block: int, control: bool = False) -> dict:
    """The gap at each judged position of every checked region ({region:
    polished output}): how far, under the float64 reference, the kept base
    lies below the best single-base change there (0 where none is
    better); with ``control`` the kept base is replaced by the bfloat16
    reference's first choice at each position.  Returns {"region_per_kb":
    the largest, over the regions, of a region's gaps summed per judged
    kb; "per_kb": all the gaps summed per judged kb; "widest": the largest
    gap}."""
    ref = TwinEngine(device, torch.float64)
    low = TwinEngine(device, torch.bfloat16) if control else None
    width = params.get("point_width", params.get("scoring_width"))
    bad = {"region_per_kb": float("inf"), "per_kb": float("inf"),
           "widest": float("inf")}
    total, widest, judged, worst = 0.0, 0.0, 0, 0.0
    names = sorted(outputs)
    for at in range(0, len(names), block):
        part = names[at : at + block]
        sessions, muts_list = [], []
        for region in part:
            pa = _load(run, region, params)
            placed = judged_sequence(pa.sequence, outputs[region])
            if placed is None:
                return bad
            seq, lo, hi = placed
            pa.RealignTo(seq)
            d = AlignData.from_session(pa)
            muts = [m for m in find_point_mutations(d) if lo <= m.start < hi]
            sessions.append(pa)
            muts_list.append(muts)
        ref_s = reference_scores(ref, [p.Copy() for p in sessions],
                                 muts_list, width)
        low_s = (reference_scores(low, sessions, muts_list, width)
                 if control else None)
        for j, (muts, r) in enumerate(zip(muts_list, ref_s)):
            if not np.all(np.isfinite(r)) or (
                    control and not np.all(np.isfinite(low_s[j]))):
                return bad
            pos = np.array([m.start for m in muts])
            region_total, n = 0.0, 0
            for p in np.unique(pos):
                at_p = pos == p
                best = max(float(r[at_p].max()), 0.0)
                chosen = 0.0
                if control and low_s[j][at_p].max() > 0:
                    chosen = float(r[at_p][int(np.argmax(low_s[j][at_p]))])
                gap = best - chosen
                region_total += gap
                widest = max(widest, gap)
                n += 1
            if not n:
                return bad
            total += region_total
            judged += n
            worst = max(worst, 1000.0 * region_total / n)
    if not judged:
        return bad
    return {"region_per_kb": worst, "per_kb": 1000.0 * total / judged,
            "widest": widest}
