"""Main-thread seconds the TorchEngine waits on the card's read-backs
(``psq.align.wait``, ``psq.mutscore.wait``, ``psq.viterbi.wait`` and
``psq.flush``, nested ones counted once) per kb polished."""

from psq_benchmark.metrics._program import s_per_kb

WAITS = ("psq.align.wait", "psq.mutscore.wait", "psq.viterbi.wait",
         "psq.flush")


def read(run):
    return s_per_kb(run, WAITS)
