"""Seconds in the port's loader (``io/``) per kb loaded: spans around
``pipeline.load_aligned_events`` (the loader call of
``pipeline.variant``, on the main thread)."""

from psq_benchmark.metrics._common import load_s_per_kb


def read(run):
    return load_s_per_kb(run, "io.load_aligned_events", main=True)
