"""Build and load the hand-written CUDA kernels and the host C++ core of
``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v

into ``_build/lib<name>.so`` (listed in .gitignore) and loaded with ctypes.
A library is rebuilt when its source or a shared ``csrc/*.cuh`` header is
newer than it.  ``--fmad=false`` keeps every kernel on the expression tree of
its plain PyTorch twin (no fused multiply-adds), so the twins can hold the
kernels to tight tolerances.  ``-Xptxas -v`` makes the build report each
kernel instance's registers and spills (kept as ``Kernel.build_log``).  A
failed build raises with the compiler's stderr; nothing falls back to a
twin.

``csrc/psq_exact.cpp`` (the host C++ core: the exact engine, the
Smith-Waterman aligners and the greedy accept's argsort) is compiled the
same way by ``build_host``, with g++ and the JAX package's flags for it:
``-O3 -std=c++17 -fPIC -shared -ffp-contract=off -fno-fast-math`` (no fused
multiply-adds, so its results equal the original's bit for bit).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off",
             "-fno-fast-math"]

def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(cmd: list[str], src: Path, deps: list[Path],
             lib: Path) -> tuple[float, str]:
    """Run ``cmd + [-o tmp, src]`` if lib is missing or older than src and
    deps; returns the seconds spent compiling and the compiler's stderr
    (0 and "" when up to date)."""
    newest = max(p.stat().st_mtime for p in [src, *deps])
    if lib.exists() and lib.stat().st_mtime >= newest:
        return 0.0, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib)      # atomic: concurrent builders never see
    finally:                      # a half-written library
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0, proc.stderr


def build(name: str) -> tuple[Path, float, str]:
    """Compile csrc/<name>.cu if its library is missing or stale; returns
    (library path, seconds spent compiling, nvcc's stderr: 0 and "" when
    up to date)."""
    lib = BUILD / f"lib{name}.so"
    secs, log = _compile([nvcc(), *NVCC_FLAGS, "-I", str(CSRC)],
                         CSRC / f"{name}.cu", list(CSRC.glob("*.cuh")), lib)
    return lib, secs, log


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with g++ if its library is missing or stale;
    returns the library path."""
    lib = BUILD / f"lib{name}.so"
    _compile(["g++", *GXX_FLAGS], CSRC / f"{name}.cpp", [], lib)
    return lib


#: every Kernel made, in the order their modules define them
KERNELS: list = []


class Kernel:
    """One csrc/<name>.cu library: built and loaded on first use, with a
    plain-integer ``launches`` count that its wrapper bumps once per kernel
    launch (never for a twin call).  Distinct kernels build concurrently."""

    def __init__(self, name: str, replaces: str, signatures: dict):
        KERNELS.append(self)
        self.name = name
        self.replaces = replaces
        self.source = f"poreseq_tpu_torch/csrc/{name}.cu"
        self._signatures = signatures
        self._lib = None
        self.launches = 0
        self.build_seconds = 0.0
        self.build_log = ""
        self._lock = threading.Lock()

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_seconds, self.build_log = build(self.name)
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in self._signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def call(self, fn: str, device: torch.device, *args) -> None:
        """Run one C entry point under ``device`` (its operands' card: the
        CUDA runtime's current device, so ``cudaFuncSetAttribute`` and the
        launch reach that card); the entry launches on the stream passed
        in ``args`` (``stream(device)``) and returns cudaGetLastError().
        Raise on a refused launch."""
        with torch.cuda.device(device):
            err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err}")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """The current stream of ``device`` (not of the current device)."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> torch.Tensor:
    """Validate a kernel operand before its pointer crosses into C."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain twin) or 'cuda' (kernel, all operands on one card) for
    a kernel wrapper's operands; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        cards = {t.device for t in tensors}
        if len(cards) > 1:
            raise ValueError(f"kernel operands on {sorted(map(str, cards))}: "
                             "need all on one CUDA device")
        return "cuda"
    raise ValueError(f"kernel operands on {sorted(kinds)}: need all-cpu "
                     "(plain twin) or all-cuda (kernel)")


def dtype_suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError(f"kernels take float32 or float64, not {dtype}")
