"""Main-thread seconds the port's CLI waits on its loader (``psq.load_wait``:
the prefetched batch's ``fut.result()``, and the first batch's own load)
per kb polished."""

from psq_benchmark.metrics._program import s_per_kb


def read(run):
    return s_per_kb(run, ("psq.load_wait",))
