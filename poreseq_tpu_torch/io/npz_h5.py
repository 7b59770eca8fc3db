"""An npz stand-in for the slice of h5py's File API that ``io/fast5.py``
uses (groups by path, datasets, structured fields, attrs), one npz per file.

A machine without h5py (the GPU machine has none) can still write and read
a synthetic run's fast5 files through the package's own ``write_fast5`` and
``load_event``, unchanged: ``use_where_missing()`` puts this module in
``sys.modules["h5py"]`` when h5py cannot be imported.  Files written through
it are read back only through it.
"""

from __future__ import annotations

import sys

import numpy as np


class _Node:
    def __init__(self, store, path):
        self._store, self._path = store, path.strip("/")

    def _join(self, name):
        if name.startswith("/"):
            return name.strip("/")
        return f"{self._path}/{name}".strip("/")

    @property
    def attrs(self):
        return self._store["attrs"].setdefault(self._path, {})

    def create_group(self, name):
        return _Node(self._store, self._join(name))

    def create_dataset(self, name, data):
        self._store["data"][self._join(name)] = np.asarray(data)

    def __getitem__(self, name):
        path = self._join(name)
        if path in self._store["data"]:
            return self._store["data"][path]
        return _Node(self._store, path)


class File(_Node):
    def __init__(self, filename, mode="r"):
        super().__init__({"data": {}, "attrs": {}}, "")
        self._filename, self._mode = filename, mode
        if mode == "r":
            with np.load(filename, allow_pickle=False) as z:
                for key in z.files:
                    kind, path, *name = key.split("|")
                    path = path.replace(":", "/")
                    if kind == "d":
                        self._store["data"][path] = z[key]
                    else:
                        self._store["attrs"].setdefault(path, {})[
                            name[0]] = z[key][()]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._mode == "w" and exc[0] is None:
            out = {f"d|{p.replace('/', ':')}": a
                   for p, a in self._store["data"].items()}
            for p, attrs in self._store["attrs"].items():
                for name, v in attrs.items():
                    out[f"a|{p.replace('/', ':')}|{name}"] = np.asarray(v)
            with open(self._filename, "wb") as fh:
                np.savez(fh, **out)


def use_where_missing() -> str:
    """Install this module as ``h5py`` where h5py cannot be imported; returns
    which of the two the fast5 reader and writer use."""
    try:
        import h5py  # noqa: F401
        return "h5py"
    except ImportError:
        sys.modules["h5py"] = sys.modules[__name__]
        return "npz stand-in for h5py"
