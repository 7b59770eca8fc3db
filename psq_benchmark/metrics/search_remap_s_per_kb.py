"""Main-thread seconds of the host search's Smith-Waterman remaps of every
candidate on the host pool (``psq.search.remap``) per kb polished."""

from psq_benchmark.metrics._program import s_per_kb


def read(run):
    return s_per_kb(run, ("psq.search.remap",))
