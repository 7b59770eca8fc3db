"""Main-thread seconds in the TorchEngine (``engine/__init__.py``: packing,
uploads, read-backs, the Viterbi host side) per kb: its ``*_multi``
methods and ``flush_ref_likes``, nested calls counted once."""

from psq_benchmark.metrics._common import engine_s_per_kb


def read(run):
    return engine_s_per_kb(run)
