"""The rounds' useful-work ratio: bases accepted (``psq.bases_accepted``)
per 1000 mutations scored (``psq.mutations_scored``, the re-scores of
deferred conflicts included), from the port's counters in the window."""

from psq_benchmark.metrics._program import counts


def read(run):
    c = counts(run)
    if not c or not c.get("psq.mutations_scored"):
        return None
    return 1000.0 * c.get("psq.bases_accepted", 0) / c["psq.mutations_scored"]
