"""100 x the least time of the scoring work that reaches the TorchEngine's
``score_mutations_multi`` calls (their rows, levels, columns, band widths
and mutations; ``psq_benchmark/roofline.py``) over the device time of
every kernel launched inside those calls."""

from psq_benchmark.metrics._common import roofline_share


def read(run):
    return roofline_share(run, "engine.score_mutations_multi")
