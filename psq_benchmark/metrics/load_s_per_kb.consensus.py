"""Seconds in the port's loader (``io/``) per kb loaded: spans around
``pipeline.load_many`` (on the CLI's prefetch thread and,
for the first batch, the main thread)."""

from psq_benchmark.metrics._common import load_s_per_kb


def read(run):
    return load_s_per_kb(run, "io.load_many", main=None)
