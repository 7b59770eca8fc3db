"""poreseq_tpu_torch — the PyTorch / CUDA port of poreseq_tpu.

The port stands alone: it imports nothing of ``poreseq_tpu`` and never
imports jax.  Its host layer (``core/``, ``io/``, ``api.py``, ``pipeline.py``,
``sim.py``, ``engine/{types,driver,multi,host,sw}.py``) and its exact
engine (``engine/exact/``) are copies of the JAX package's, under the same
names; their C++ core (``csrc/psq_exact.cpp``, a copy of the JAX
package's) is built with g++ on first use.  The device side is
``engine.TorchEngine`` with hand-written CUDA kernels (``csrc/*.cu``), each
with a plain PyTorch twin that runs on CPU tensors.

``api.PSAlign(backend=..., engine=...)`` and the ``pipeline`` entry points
run on the engine they are given, else on their backend's shared engine:
``"torch"`` (the default) is one ``TorchEngine("cuda")``, ``"exact"`` one
``engine.exact.ExactEngine``, the CPU oracle.
"""

from __future__ import annotations

from .engine import EngineError, TorchEngine

__all__ = ["EngineError", "TorchEngine"]
