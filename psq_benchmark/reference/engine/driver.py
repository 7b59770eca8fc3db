"""FindPointMutations (PoreSeq's cpp/FindMutations.cpp:191-234): the
port's ``engine/driver.py`` cut to the one driver the reference calls."""

from __future__ import annotations

from ..core.regions import MutationInfo
from .types import AlignData


def find_point_mutations(data: AlignData) -> list[MutationInfo]:
    """Enumerate every single-base deletion, substitution and insertion
    (9 per base; FindMutations.cpp:191-234)."""
    bases = "ACGT"
    muts: list[MutationInfo] = []
    n_states = max(len(data.sequence) - 4, 0)
    for i in range(n_states):
        b = data.sequence[i]
        m = MutationInfo()
        m.start, m.orig, m.mut = i, b, ""
        muts.append(m)
        for c in bases:
            if c == b:
                continue
            m = MutationInfo()
            m.start, m.orig, m.mut = i, b, c
            muts.append(m)
        for c in bases:
            m = MutationInfo()
            m.start, m.orig, m.mut = i, "", c
            muts.append(m)
    return muts
