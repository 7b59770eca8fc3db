"""PSAlign, the session object tying the reference sequence, events and
params (PoreSeq's poreseq/_poreseqcpp.pyx:189-261): the port's ``api.py``
cut to what the benchmark's reference uses, with the NumPy
Smith-Waterman."""

from __future__ import annotations

import copy

import numpy as np

from .engine.sw import swalign


class PSAlign:
    """All data associated with reads aligned to a reference (pyx:189-213).

    Attributes:
        sequence (str): reference the events are currently aligned to
        events (list[Event]): aligned events
        params (dict): parameter dictionary
    """

    def __init__(self):
        self.sequence = ""
        self.events = []
        self.params = {}

    def Copy(self) -> "PSAlign":
        return copy.deepcopy(self)

    def RealignTo(self, newseq: str) -> None:
        """Smith-Waterman realign all events to a new reference (pyx:241-261).
        NB the reference compares percent accuracy against 0.6 — preserved."""
        align = swalign(self.sequence, newseq)
        if align[0] < 0.6:
            raise Exception("Error rate too large for realignment!")
        for x in self.events:
            x.mapaligns(np.array(align[1]))
        self.sequence = newseq
