"""Engine-generic mutation proposal and greedy acceptance.

These drivers implement the reference's control flow —
  FindMutations / FindPointMutations  (PoreSeq's cpp/FindMutations.cpp)
  MakeMutations                       (PoreSeq's cpp/MakeMutations.cpp:74-146)
— on top of an *engine* object providing the numeric primitives:

  engine.score_alignments(data, likes=None) -> list[float]
  engine.score_mutations(data, muts)        -> list[MutationScore]
  engine.map_alignments(data, newseq)       -> (accuracy, filled pairs[n,2])

so the same logic drives any engine (the port's TorchEngine and its exact
engine; a copy of the JAX package's ``engine/driver.py``).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.regions import MutationInfo, MutationScore
from ..core.sequence import apply_mutation
from .types import AlignData


def candidate_dlikes(seqreflike: np.ndarray, reflikes: np.ndarray,
                     pairs: np.ndarray):
    """Per-candidate CUSUM'd likelihood-difference track + its alignment index
    pair (FindMutations.cpp:51-94): the match-the-matlab -2 decrement, dropped
    invalid leading pairs, successive differences, CUSUM clamped at zero with
    exact-tie zeroing."""
    inds1 = pairs[:, 0].astype(np.int64) - 2
    inds2 = pairs[:, 1].astype(np.int64) - 2
    k = 0
    while k < len(inds1) and (inds1[k] < 0 or inds2[k] < 0):
        k += 1
    inds1, inds2 = inds1[k:], inds2[k:]

    alref1 = seqreflike[inds1].copy()
    alref2 = reflikes[inds2].copy()
    # successive differences (in place, back to front), first elt zeroed
    alref1[1:] = alref1[1:] - alref1[:-1]
    alref2[1:] = alref2[1:] - alref2[:-1]
    if len(alref1):
        alref1[0] = 0.0
        alref2[0] = 0.0

    dlikes = np.zeros(len(alref1), dtype=np.float64)
    cusum = 0.0
    for j in range(len(alref1)):
        cusum += alref2[j] - alref1[j]
        if cusum < 0:
            cusum = 0.0
        dlikes[j] = cusum
        if abs(alref1[j] - alref2[j]) < 1e-5:
            dlikes[j] = 0.0

    return dlikes, (inds1, inds2)


def find_mutations(engine, data: AlignData, seqs: list[str]) -> list[MutationInfo]:
    """Propose mutations by CUSUM of per-base likelihood differences between
    the consensus and each candidate sequence (FindMutations.cpp:24-186)."""
    seqreflike = np.zeros(len(data.sequence), dtype=np.float64)
    engine.score_alignments(data, likes=seqreflike)

    alllikes: list[np.ndarray] = []
    seqals: list[tuple[np.ndarray, np.ndarray]] = []

    if data.params.verbose:
        sys.stderr.write("Finding mutations")

    for seq in seqs:
        newdata = AlignData(
            sequence=data.sequence,
            events=[ev.light_copy() for ev in data.events],
            params=data.params,
        )
        _, pairs = engine.map_alignments(newdata, seq)
        reflikes = data.seqlikes.get(seq)
        if reflikes is None:
            reflikes = np.zeros(len(seq), dtype=np.float64)
            engine.score_alignments(newdata, likes=reflikes)
            data.seqlikes[seq] = reflikes

        dlikes, als = candidate_dlikes(seqreflike, reflikes, pairs)
        alllikes.append(dlikes)
        seqals.append(als)
        if data.params.verbose:
            sys.stderr.write(".")
            sys.stderr.flush()

    if data.params.verbose:
        sys.stderr.write("\n")

    return extract_mutations(data.sequence, seqs, alllikes, seqals)


def extract_mutations(sequence: str, seqs: list[str], alllikes, seqals):
    """Iterative peak extraction (FindMutations.cpp:112-183)."""
    mutations: list[MutationInfo] = []
    while len(mutations) < len(sequence) // 3:
        lmax = [dl[int(np.argmax(dl))] if len(dl) else 0.0 for dl in alllikes]
        if not lmax:
            break
        imax = int(np.argmax(np.asarray(lmax)))
        dlike = alllikes[imax]
        ind = int(np.argmax(dlike))
        if dlike[ind] < 0.25:
            break

        # next exact zero at/after the max; previous exact zero at/before it
        after = np.nonzero(dlike[ind:] == 0)[0]
        i1 = ind + int(after[0]) if len(after) else len(dlike)
        before = np.nonzero(dlike[: ind + 1] == 0)[0]
        i0 = int(before[-1]) if len(before) else -1
        if i0 < 0:
            i0 = 0
        if i1 < 0:
            i1 = 0
        if i0 >= len(dlike):
            i0 = len(dlike) - 1
        if i1 >= len(dlike):
            i1 = len(dlike) - 1

        inds1, inds2 = seqals[imax]
        start1 = int(inds1[i0])
        start2 = int(inds2[i0])
        end1 = int(inds1[ind])
        end2 = int(inds2[ind])

        mut = MutationInfo()
        mut.start = start1
        mut.orig = sequence[start1:end1]
        mut.mut = seqs[imax][start2:end2]
        # trim common prefix (advancing start) and common suffix
        while mut.orig and mut.mut and mut.orig[0] == mut.mut[0]:
            mut.orig = mut.orig[1:]
            mut.mut = mut.mut[1:]
            mut.start += 1
        while mut.orig and mut.mut and mut.orig[-1] == mut.mut[-1]:
            mut.orig = mut.orig[:-1]
            mut.mut = mut.mut[:-1]

        if mut.orig or mut.mut:
            mutations.append(mut)

        dlike[i0 : i1 + 1] = 0.0

    return mutations


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
    if data.params.verbose:
        sys.stderr.write("Point ")
    return muts


def _argsort_desc(scores: np.ndarray) -> np.ndarray:
    """Descending argsort replicating libstdc++ std::sort's (unstable) tie
    permutation, via the native core — exact score ties are common for point
    mutations, and the greedy accept order depends on them."""
    from .sw import argsort_desc

    return argsort_desc(scores)


def greedy_accept(data: AlignData, muts: list[MutationScore]):
    """One greedy acceptance pass with conflict deferral
    (MakeMutations.cpp:74-139): returns (accepted bases, deferred mutations).
    The descending sort reproduces std::sort's exact tie permutation (see
    _argsort_desc)."""
    mutspc = 10
    mutbases = 0

    order = _argsort_desc(np.array([m.score for m in muts], dtype=np.float64))
    muts = [muts[i] for i in order]
    while muts and muts[-1].score < 0:
        muts.pop()
    if not muts:
        return 0, []

    if data.params.verbose:
        sys.stderr.write("Testing {} mutations...\n".format(len(muts)))

    mutextra: list[MutationInfo] = []
    for i in range(len(muts)):
        if muts[i].score < 0:
            mi = MutationInfo()
            mi.start, mi.orig, mi.mut = muts[i].start, muts[i].orig, muts[i].mut
            mutextra.append(mi)
            continue
        data.sequence = apply_mutation(data.sequence, muts[i].start, muts[i].orig, muts[i].mut)
        if data.params.verbose > 1:
            sys.stderr.write(
                "Kept mutation {} at {} of {} to {} with score {}\n".format(
                    i, muts[i].start, len(muts[i].orig), len(muts[i].mut), muts[i].score
                )
            )
        mutbases += max(len(muts[i].orig), len(muts[i].mut))
        for j in range(i + 1, len(muts)):
            minind = max(muts[i].start, muts[j].start)
            maxind = min(muts[i].start + len(muts[i].mut), muts[j].start + len(muts[j].mut))
            if minind < maxind + mutspc and muts[j].score > 0:
                muts[j].score = -1
                continue
            if muts[j].start >= muts[i].start + len(muts[i].orig):
                muts[j].start += len(muts[i].mut) - len(muts[i].orig)

    return mutbases, mutextra


def make_mutations(engine, data: AlignData, muts: list[MutationScore]) -> int:
    """Greedy acceptance with conflict deferral and recursive re-scoring
    (MakeMutations.cpp:74-146).  The lockstep drivers use greedy_accept
    directly and batch the deferred re-score across regions instead
    (engine/multi.py make_mutations_multi)."""
    mutbases, mutextra = greedy_accept(data, muts)

    if len(mutextra) > 10:
        mutbases += make_mutations(engine, data, engine.score_mutations(data, mutextra))

    return mutbases
