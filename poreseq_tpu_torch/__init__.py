"""poreseq_tpu_torch — the PyTorch / CUDA port of poreseq_tpu.

The port stands alone: it imports nothing of ``poreseq_tpu`` and never
imports jax.  Its host layer (``core/``, ``io/``, ``api.py``, ``pipeline.py``,
``sim.py``, ``engine/{types,driver,multi,host,sw}.py``) is a copy of the JAX
package's, under the same names; the host Smith-Waterman core
(``csrc/host_sw.cpp``) is built with g++ on first use.  The device side is
``engine.TorchEngine`` with hand-written CUDA kernels for the banded fill,
the mutation group scorer and the backtrace (``csrc/*.cu``), each with a
plain PyTorch twin that runs on CPU tensors.

``api.PSAlign(engine=...)`` and the ``pipeline`` entry points run on the
TorchEngine they are given (default: one shared ``TorchEngine("cuda")``).
"""

from __future__ import annotations

from .engine import EngineError, TorchEngine

__all__ = ["EngineError", "TorchEngine"]
