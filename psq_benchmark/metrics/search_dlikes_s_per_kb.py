"""Main-thread seconds of the host search's per-candidate likelihood
deltas (``candidate_dlikes``, ``psq.search.dlikes``) per kb polished."""

from psq_benchmark.metrics._program import s_per_kb


def read(run):
    return s_per_kb(run, ("psq.search.dlikes",))
