"""fasta/region splitting, merging and fast5 extraction utilities.

Mirrors PoreSeq's poreseq/split_fasta.py, merge_fasta.py and
extract_fasta.py.
"""

from __future__ import annotations

import functools
import os
import random
import sys

from ..core.regions import RegionInfo
from .fasta import read_fasta


def split_fasta(fastafile: str, nchunks=None, nseqs=None):
    """Shard sequences into N files / M-per-file (split_fasta.py:6-47).
    Chunk assignment is random, as in the reference."""
    refs = read_fasta(fastafile)
    if nchunks is None and nseqs is None:
        return
    fastabase = os.path.splitext(fastafile)[0]
    if nchunks is not None:
        chunks = [open(fastabase + ".{}.fasta".format(i + 1), "w")
                  for i in range(nchunks)]
        for name, seq in refs.items():
            chunks[random.randint(0, nchunks - 1)].write(
                ">{}\n{}\n".format(name, seq))
        for c in chunks:
            c.close()
    else:
        fileind = -1
        f = None
        nwritten = nseqs
        for name, seq in refs.items():
            if nwritten >= nseqs:
                fileind += 1
                f = open(fastabase + ".{}.fasta".format(fileind + 1), "w")
                nwritten = 0
            f.write(">{}\n{}\n".format(name, seq))
            nwritten += 1
        if f:
            f.close()


def split_regions(fastafile: str, region_length, nfiles=None, perfile=None,
                  userefs=None):
    """Overlapping region strings with stride region_length-1000
    (split_fasta.py:50-133)."""
    refs = read_fasta(fastafile)
    region_length = int(region_length)
    regions = []
    for refid, refseq in refs.items():
        if userefs is not None and refid not in userefs:
            continue
        dl = region_length - 1000
        istart = 0
        iend = min(region_length, len(refseq))
        while istart < iend:
            regions.append("{}:{}:{}".format(refid, istart, iend))
            iend = min(iend + dl, len(refseq))
            istart = min(istart + dl, len(refseq))

    if nfiles is None and perfile is None:
        return regions

    fastabase = os.path.splitext(fastafile)[0]
    if nfiles is not None:
        chunks = [open(fastabase + ".{}.region".format(i + 1), "w")
                  for i in range(nfiles)]
        for reg in regions:
            chunks[random.randint(0, nfiles - 1)].write(reg + "\n")
        for c in chunks:
            c.close()
    else:
        fileind = -1
        f = None
        nwritten = perfile
        for reg in regions:
            if nwritten >= perfile:
                fileind += 1
                f = open(fastabase + ".{}.region".format(fileind + 1), "w")
                nwritten = 0
            f.write(reg + "\n")
            nwritten += 1
        if f:
            f.close()


def merge_seqs(seq1: str, seq2: str, overlap: int) -> str:
    """SW-splice two overlapping fragments at the middle aligned pair
    (merge_fasta.py:8-39).  NB the reference compares percent accuracy
    against 0.70 — preserved."""
    from ..api import swalign

    i0 = -overlap
    i1 = overlap
    if len(seq1) < overlap:
        i0 = 0
    if len(seq2) < overlap:
        i1 = len(seq2) - 1
    acc, inds = swalign(seq1[i0:], seq2[:i1])
    if acc < 0.70:
        raise Exception("Insufficient accuracy for overlap")
    inds = [x for x in inds if x[0] > 0 and x[1] > 0]
    imid = inds[int(len(inds) / 2)]
    i0 += imid[0]
    i1 = imid[1]
    return seq1[:i0] + seq2[i1:]


def merge_fasta(fastafiles: list[str], fastaout: str):
    """Group corrected fragments by region name, sort by start, pairwise
    SW-splice (merge_fasta.py:42-81)."""
    fragments: dict[str, list] = {}
    for fasta in fastafiles:
        refs = read_fasta(fasta)
        for ref, seq in refs.items():
            reg = RegionInfo(ref)
            fragments.setdefault(reg.name, []).append((reg, seq))

    with open(fastaout, "w") as outfile:
        for ref, seqlist in fragments.items():
            seqlist.sort(key=lambda x: x[0].start)
            seq = functools.reduce(lambda x, y: merge_seqs(x, y, 1000),
                                   [x[1] for x in seqlist])
            outfile.write(">{}\n{}\n".format(ref, seq))


def extract_fasta(fast5files: list[str], fastafile=None, addpath=False,
                  force=False):
    """fast5 -> FASTA of 2D basecalls (extract_fasta.py:19-79)."""
    from .fast5 import get_fasta

    if not fast5files:
        raise Exception("No files specified!")

    if fastafile is None:
        fast5dir = fast5files[0]
        if os.path.isdir(fast5dir):
            fastafile = os.path.normpath(fast5dir)
        else:
            fastafile, _ = os.path.split(fast5dir)
        fastafile += ".fasta"

    if os.path.isfile(fastafile) and not force:
        sys.stderr.write("File exists, skipping...\n")
        return

    nwrote = 0
    with open(fastafile, "w") as fasta:
        print("Extracting fasta to " + fastafile + " ...")
        for i, f in enumerate(fast5files):
            try:
                seq = get_fasta(f)
            except Exception:
                continue
            fn = f
            if not addpath:
                _, fn = os.path.split(f)
            fasta.write(">" + fn + "\n" + seq + "\n")
            nwrote += 1
    print("Done, extracted " + str(nwrote) + " 2D fasta sequences")
