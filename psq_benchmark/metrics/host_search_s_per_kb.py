"""Main-thread seconds in ``engine/multi.py find_mutations_multi`` (the
host search: the Smith-Waterman remaps of every candidate on the host
pool and ``candidate_dlikes``) less its TorchEngine calls, per kb
polished."""

from psq_benchmark.metrics._common import host_search_s_per_kb


def read(run):
    return host_search_s_per_kb(run)
