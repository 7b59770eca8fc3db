"""Main-thread seconds of the consensus rounds' own host work: the greedy
accept (``psq.accept``), ``AlignData.from_session`` / ``sync_back``
(``psq.sync``), the Refine's enumeration of every point mutation
(``psq.points``) and the final accuracy Smith-Waterman (``psq.final``),
per kb polished."""

from psq_benchmark.metrics._program import s_per_kb


def read(run):
    return s_per_kb(run, ("psq.accept", "psq.sync", "psq.points",
                          "psq.final"))
