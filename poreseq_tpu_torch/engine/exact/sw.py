"""The exact engine's Smith-Waterman: the port's ``engine/sw.py``, which is
the copy of the JAX package's ``engine/exact/sw.py`` (one copy, two
names, as the JAX package has them)."""

from ..sw import fillinds, map_alignments, swalign, swfast, swfull

__all__ = ["fillinds", "map_alignments", "swalign", "swfast", "swfull"]
