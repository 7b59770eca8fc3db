"""Aligned-event loading: BAM fetch/filter/sort/dedup + fast5 strand loading.

Mirrors PoreSeq's poreseq/LoadData.py exactly: overlap filtering and
descending-overlap sort, unique-read selection up to max_coverage, hard-clip
offset fix, region-start shift, reverse-strand flip, and the mapaligns seed
remap.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..api import PSAlign
from ..core.regions import RegionInfo
from .bam import CHARD_CLIP, AlignmentFile
from .fasta import load_reference
from .fast5 import load_event_cached


def load_aligned_events(
    fastafile: str,
    bamfile: str,
    eventdir: str,
    reginfo: RegionInfo,
    params: dict,
) -> PSAlign:
    """LoadAlignedEvents (LoadData.py:10-52)."""
    refseq = load_reference(fastafile, reginfo.name)
    if reginfo.start is None and reginfo.end is None:
        reginfo.start = 0
        reginfo.end = len(refseq)
    events = events_from_bam(eventdir, bamfile, reginfo, params)
    if len(params) > 0:
        for x in events:
            x.setparams(params)
    refseq = refseq[reginfo.start : reginfo.end]
    pa = PSAlign()
    pa.sequence = refseq
    pa.events = events
    pa.params = params
    return pa


def _set_trim_hint(ev, reginfo: RegionInfo, params: dict) -> None:
    """Band-reachable level range from the seed alignment (Event.trim).

    A read overhanging a short region carries thousands of levels that can
    never fall inside any banded-DP column (the band centers on the
    interpolated alignment, half-width realign_width — Alignment.cpp:127-148)
    — they pad the device batch time axis for nothing.  Levels outside every
    band are never visited and stay unaligned either way, so slicing them is
    exact-equivalent; the slack absorbs band drift across realign rounds.
    PSQ_TRIM_EVENTS=0 disables."""
    if os.environ.get("PSQ_TRIM_EVENTS", "1") == "0":
        return
    if reginfo.start is None or reginfo.end is None:
        return
    n = len(ev.mean)
    S = (reginfo.end - reginfo.start) - 4          # region length in states
    if S <= 0 or n < 1024:
        return
    from ..core.events import update_refs

    width = int(params.get("realign_width", 300))
    pad = width + 256
    ri = update_refs(ev.ref_align)[0]
    if len(ri) == 0 or not np.all(np.isfinite(ri)):
        return
    # update_refs copies the RAW ref_align at anchor levels, so a
    # non-monotone BAM seed alignment (a real case — viterbi._position_stats
    # handles it explicitly) yields a non-monotone ri where searchsorted
    # results are undefined and the trim could cut genuinely aligned levels.
    # Trimming is an optimization only: skip it for such reads.
    if np.any(np.diff(ri) < 0):
        return
    lo = max(int(np.searchsorted(ri, 1)) - width - pad, 0)
    hi = min(int(np.searchsorted(ri, S, side="right")) + width + pad, n)
    if hi > lo and hi - lo < n - 256:   # only slice when it saves real rows
        ev.trim = (lo, hi)


def events_from_bam(eventdir: str, bamfile: str, reginfo: RegionInfo, params: dict):
    """EventsFromBAM (LoadData.py:67-153)."""
    bam = AlignmentFile.cached(bamfile)

    if reginfo.name is None:
        if bam.nreferences > 1:
            raise Exception("Multiple references in BAM, one must be specified!")
        reginfo.name = bam.references[0]

    bamevents = list(bam.fetch(reference=reginfo.name, start=reginfo.start,
                               end=reginfo.end))

    if "min_overlap" in params:
        bamevents = [
            x for x in bamevents
            if x.get_overlap(reginfo.start, reginfo.end) >= params["min_overlap"]
        ]
    bamevents.sort(key=lambda x: x.get_overlap(reginfo.start, reginfo.end),
                   reverse=True)

    if "min_coverage" in params and len(bamevents) < params["min_coverage"]:
        raise Exception("Insufficient coverage!")

    # unique reads up to max_coverage, most-overlapping first
    bamnames = []
    newevents = []
    for bamev in bamevents:
        if bamev.query_name not in bamnames:
            bamnames.append(bamev.query_name)
            newevents.append(bamev)
        if "max_coverage" in params and len(newevents) >= params["max_coverage"]:
            break
    bamevents = newevents

    events = []
    for bamev in bamevents:
        evfile = os.path.join(eventdir, bamev.query_name)
        aps = bamev.aligned_pairs_matched()
        # hard-clip offset fix (LoadData.py:132-134)
        cig0 = bamev.cigar[0]
        if cig0[0] == CHARD_CLIP:
            aps[:, 0] += cig0[1]
        if reginfo.start > 0:
            aps[:, 1] -= reginfo.start
        for loc in ("t", "c"):
            try:
                ev = load_event_cached(evfile, loc)
                if bamev.is_reverse:
                    ev.flip()
                ev.mapaligns(aps)
                _set_trim_hint(ev, reginfo, params)
                events.append(ev)
            except Exception as e:
                print(str(e), file=sys.stderr)

    if not events:
        raise Exception("No aligned reads found!")
    return events
