"""Main-thread seconds of the TorchEngine's ``score_mutations_multi``
(``psq.mutscore``) less its read-back waits (``psq.mutscore.wait`` and a
``psq.flush`` inside it): the scorer's host work, self time, per kb
polished."""

from psq_benchmark.metrics._program import self_s_per_kb


def read(run):
    return self_s_per_kb(run, ("psq.mutscore",),
                         ("psq.mutscore.wait", "psq.flush"))
