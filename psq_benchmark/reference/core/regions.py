"""Region strings and mutation value types.

Mirrors PoreSeq's poreseq/Util.py exactly (grammar, '.' placeholder
handling, and string formatting used by the variant CLI output).
"""

from __future__ import annotations


class RegionInfo:
    """Parses ``None | name | a:b | name:a:b`` (Util.py:5-30)."""

    def __init__(self, region: str | None = None):
        self.start: int | None = None
        self.end: int | None = None
        self.name: str | None = None
        if region is None:
            return
        rs = region.split(":")
        if len(rs) != 2:
            self.name = rs[0]
        if len(rs) > 1:
            self.start = int(rs[-2])
            self.end = int(rs[-1])

    def __repr__(self):
        return f"RegionInfo(name={self.name!r}, start={self.start}, end={self.end})"


class MutationInfo:
    """One mutation: start / orig / mut, parsed from a whitespace-delimited
    line with '.' meaning empty (Util.py:43-82)."""

    def __init__(self, info: str | None = None):
        self.start = 0
        self.orig = ""
        self.mut = ""
        if info is not None:
            if len(info) == 0 or info[0] == "#":
                self.start = -1
                return
            vals = info.split()
            if len(vals) != 3:
                self.start = -1
                return
            self.start = int(vals[0])
            self.orig = vals[1]
            self.mut = vals[2]
            if self.orig == ".":
                self.orig = ""
            if self.mut == ".":
                self.mut = ""

    def __str__(self):
        original = self.orig if self.orig else "."
        mutation = self.mut if self.mut else "."
        return "{}\t{}\t{}".format(self.start, original, mutation)


class MutationScore:
    """A scored mutation (Util.py:84-111)."""

    def __init__(self, start: int = 0, orig: str = "", mut: str = "", score: float = 0.0):
        self.start = start
        self.orig = orig
        self.mut = mut
        self.score = score

    def __str__(self):
        original = self.orig if self.orig else "."
        mutation = self.mut if self.mut else "."
        return "{}\t{}\t{}\t{}".format(self.start, original, mutation, self.score)
