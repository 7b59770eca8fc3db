"""The import rule, top-level names compared whole (``poreseq_tpu_torch``
begins with ``poreseq_tpu``): nothing on the run path imports jax or the
JAX package, and the reference imports neither, nor the port."""

import ast
import os

from .conftest import ROOT

BENCH = os.path.join(ROOT, "psq_benchmark")
JAX = {"jax", "jaxlib", "flax", "poreseq_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(BENCH, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_the_run_path_imports_no_jax():
    for path in _files():
        bad = set(_imports(path)) & JAX
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    seen = set()
    for path in _files("reference"):
        names = set(_imports(path))
        seen |= names
        assert not names & (JAX | {"poreseq_tpu_torch"}), path
    assert "torch" in seen and "numpy" in seen


def test_check_and_generator_import_nothing_of_the_port():
    for name in ("check.py", "simulate.py", "roofline.py", "trace.py"):
        names = set(_imports(os.path.join(BENCH, name)))
        assert not names & (JAX | {"poreseq_tpu_torch"}), name


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    from psq_benchmark.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "poreseq_tpu_torch_x",
                        types.ModuleType("poreseq_tpu_torch_x"))
    assert forbidden_modules() == [m for m in ("flax", "jax", "jaxlib",
                                               "poreseq_tpu")
                                   if m in {k.split(".")[0]
                                            for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in forbidden_modules()
