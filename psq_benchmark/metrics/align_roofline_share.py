"""100 x the least time of the alignment work that reaches the
TorchEngine's ``score_alignments_multi`` calls (their event rows, levels,
columns and band width; ``psq_benchmark/roofline.py``) over the device
time of every kernel launched inside those calls."""

from psq_benchmark.metrics._common import roofline_share


def read(run):
    return roofline_share(run, "engine.score_alignments_multi")
