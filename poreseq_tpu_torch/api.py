"""PSAlign — the session object tying reference sequence, events and params.

API-compatible with the reference's PSAlign
(PoreSeq's poreseq/_poreseqcpp.pyx:189-472).  Copy of the JAX package's
``api.py`` on the port's engine: a session computes on the ``TorchEngine``
its caller gives it, else on one shared ``TorchEngine("cuda")`` made at
first use.  There is no engine table.
"""

from __future__ import annotations

import copy

import numpy as np

from .core.regions import MutationInfo, MutationScore
from .engine import driver
from .engine.types import AlignData


_DEFAULT_ENGINE = None


def default_engine():
    """The shared ``TorchEngine("cuda")`` of sessions given no engine."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        from .engine import TorchEngine

        _DEFAULT_ENGINE = TorchEngine("cuda")
    return _DEFAULT_ENGINE


def swalign(seq1: str, seq2: str):
    """Smith-Waterman align two sequences; returns (accuracy %, index pairs)
    (pyx:155-174)."""
    from .engine.sw import swalign as _swalign

    return _swalign(seq1, seq2)


def seqtostates(seq: str):
    """Convert nucleotide sequence to 5-mer states [0,1023] (pyx:176-187)."""
    from .core.sequence import seq_to_states

    return seq_to_states(seq)


class PSAlign:
    """All data associated with reads aligned to a reference (pyx:189-213).

    Attributes:
        sequence (str): reference the events are currently aligned to
        events (list[Event]): aligned events
        params (dict): parameter dictionary
    """

    def __init__(self, engine=None):
        self.sequence = ""
        self.events = []
        self.params = {}
        self._engine = engine          # None: default_engine()

    @property
    def engine(self):
        if self._engine is not None:
            return self._engine
        return default_engine()

    def Copy(self) -> "PSAlign":
        # the engine (device caches) is shared, not copied
        eng, self._engine = self._engine, None
        try:
            new = copy.deepcopy(self)
        finally:
            self._engine = eng
        new._engine = eng
        return new

    def Coverage(self) -> np.ndarray:
        """Number of events aligned at each base of self.sequence (pyx:225-239)."""
        cov = np.zeros(len(self.sequence))
        for ev in self.events:
            nzs = ev.ref_align[ev.ref_align > 0]
            minind = int(nzs[0])
            maxind = int(np.minimum(nzs[-1], len(cov) - 1))
            cov[minind:maxind] += 1
        return cov

    def RealignTo(self, newseq: str) -> None:
        """Smith-Waterman realign all events to a new reference (pyx:241-261).
        NB the reference compares percent accuracy against 0.6 — preserved."""
        align = swalign(self.sequence, newseq)
        if align[0] < 0.6:
            raise Exception("Error rate too large for realignment!")
        for x in self.events:
            x.mapaligns(np.array(align[1]))
        self.sequence = newseq

    def ScoreEvents(self) -> list[float]:
        """Realign + total likelihood score per event (pyx:263-276).
        Does not write back into self.events (FFI-copy semantics)."""
        data = AlignData.from_session(self)
        return self.engine.score_alignments(data, likes=None)

    def ScorePoints(self) -> list[MutationScore]:
        """Score all single-base mutations (pyx:278-308)."""
        data = AlignData.from_session(self)
        if "point_width" in self.params:
            data.params.scoring_width = int(self.params["point_width"])
        muts = driver.find_point_mutations(data)
        return self.engine.score_mutations(data, muts)

    def ScoreMutations(self, muts: list[MutationInfo]) -> list[MutationScore]:
        """Score the given mutations (pyx:310-345)."""
        data = AlignData.from_session(self)
        return self.engine.score_mutations(data, muts)

    def ApplyMuts(self, pymuts: list[MutationScore]) -> None:
        """Greedy-apply pre-scored mutations (pyx:347-375)."""
        data = AlignData.from_session(self)
        if "point_width" in self.params:
            data.params.scoring_width = int(self.params["point_width"])
        muts = [MutationScore(m.start, m.orig, m.mut, m.score) for m in pymuts]
        driver.make_mutations(self.engine, data, muts)
        self._sync(data)

    def _sync(self, data) -> None:
        # deferred device reads (ref_like) materialize at sync points only
        getattr(self.engine, "flush_ref_likes", lambda: None)()
        data.sync_back(self)

    def Mutate(self, seqs="self", reps: int = 4) -> int:
        """Propose/score/accept mutations from candidate sequences
        (pyx:378-435)."""
        data = AlignData.from_session(self)

        if isinstance(seqs, str) and seqs == "self":
            # every other event: one strand per read (template+complement pairs)
            seqs = [x.sequence for x in self.events[::2]]
        elif isinstance(seqs, str) and seqs == "viterbi":
            seqs = self.engine.viterbi_mutate(
                data.events, 16, 0.05, 0.01, 0.33, 0.75, self.params["verbose"]
            )

        totbases = 0
        for _ in range(reps):
            mutations = driver.find_mutations(self.engine, data, seqs)
            scores = self.engine.score_mutations(data, mutations)
            nbases = driver.make_mutations(self.engine, data, scores)
            if nbases == 0:
                break
            totbases += nbases

        self._sync(data)
        return totbases

    def Refine(self) -> int:
        """Test all single-base mutations at point_width (pyx:437-472)."""
        data = AlignData.from_session(self)
        if "point_width" in self.params:
            data.params.scoring_width = int(self.params["point_width"])
        mutations = driver.find_point_mutations(data)
        scores = self.engine.score_mutations(data, mutations)
        nbases = driver.make_mutations(self.engine, data, scores)
        self._sync(data)
        return nbases
