"""poreseq_tpu_torch — the PyTorch / CUDA port of poreseq_tpu.

The port owns the device side: ``engine.TorchEngine`` with hand-written
CUDA kernels for the banded fill, the mutation group scorer and the
backtrace (``csrc/``), each with a plain PyTorch twin that runs on CPU
tensors.  The host pipeline (regions, loading, the lockstep drivers, the
exact Smith-Waterman core) is imported from ``poreseq_tpu`` unchanged; the
port never imports jax.

Nothing is registered at import time: ``register_engine`` puts a
TorchEngine into ``poreseq_tpu.api``'s engine table under the backend name
"torch", after which ``PSAlign(backend="torch")`` and
``pipeline.mutate_many(..., backend="torch")`` run on it.
"""

from __future__ import annotations

import torch

from .engine import EngineError, TorchEngine

__all__ = ["EngineError", "TorchEngine", "register_engine"]


def register_engine(device="cuda", dtype=torch.float32,
                    seed: int = 0) -> TorchEngine:
    """Create a TorchEngine and register it as backend "torch"."""
    from poreseq_tpu import api

    engine = TorchEngine(device=device, dtype=dtype, seed=seed)
    api._ENGINES["torch"] = engine
    return engine
