"""Exact (CPU, f64 bit-faithful) engine backend of the port.

``--backend exact`` and ``PSAlign(backend="exact")``: this engine
reproduces the reference PoreSeq numerics exactly and is the oracle the
port's TorchEngine is held against.  A copy of the JAX package's
``engine/exact`` over the port's C++ core (``csrc/psq_exact.cpp``); it has
no device and needs no tensor.
"""

from __future__ import annotations

import sys

import numpy as np

from ...core.regions import MutationInfo, MutationScore
from ...core.sequence import seq_to_states
from ..types import AlignData, make_mutscores
from .align import NativeAligner, pack_mutations, score_alignments
from .sw import map_alignments, swalign, swfast, swfull
from .viterbi import viterbi_mutate


class ExactEngine:
    name = "exact"

    def score_alignments(self, data: AlignData, likes=None):
        return score_alignments(data, likes=likes)

    def map_alignments(self, data: AlignData, newseq: str):
        return map_alignments(data, newseq)

    def score_mutations(self, data: AlignData, muts: list[MutationInfo]) -> list[MutationScore]:
        """Score every mutation against every event (event-major, matching
        ScoreMutations, cpp/MakeMutations.cpp:23-69).  Updates data.events in
        place via the per-event realign + backtrace."""
        mutscores = make_mutscores(muts)
        if data.params.verbose:
            sys.stderr.write("Scoring ({})".format(data.params.scoring_width))
            sys.stderr.flush()

        states = seq_to_states(data.sequence)
        pack = pack_mutations(data.sequence, muts)
        # single running accumulator across events, seeded with the -1e-6
        # null-suppression init, so the f64 addition order matches the
        # reference's event-major `score += delta` exactly
        totals = np.full(len(muts), -1e-6, dtype=np.float64)

        for ev in data.events:
            al = NativeAligner(ev, data.params)
            al.reset(states)
            al.fill_forward()
            al.fill_backward()
            al.backtrace()
            al.pull_into(ev)
            al.score_mutations(pack, len(data.sequence), totals)
            del al
            if data.params.verbose:
                sys.stderr.write(".")
                sys.stderr.flush()

        if data.params.verbose:
            sys.stderr.write("\n")

        for ms, t in zip(mutscores, totals):
            ms.score = float(t)
        return mutscores

    def viterbi_mutate(self, events, nkeep, skip_prob, stay_prob, mut_min, mut_max,
                       verbose=False):
        return viterbi_mutate(events, nkeep, skip_prob, stay_prob, mut_min, mut_max,
                              verbose)

    @staticmethod
    def swalign(seq1: str, seq2: str):
        return swalign(seq1, seq2)
