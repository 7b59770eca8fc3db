"""Spans and counters inside the port, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records on the calling
thread (the CLI's ``--profile DIR``, or any caller's own profiler); there
is no other switch.

- ``span(name)``: a context manager (``spanned(name)``, the same around
  every call of a function).  With tracing on it is a
  ``record_function(name)`` range, so the span's name, start, end and
  thread land in the profiler's trace on the device trace's clock, its
  parent being the enclosing span of the same thread.  With tracing off it
  makes one ``_profiler_enabled()`` check and returns a shared no-op
  context (an idle ``record_function`` still costs an enter and an exit
  into the profiler's C++).
- ``count(name, n)``: with tracing on, appends ``(name,
  time.perf_counter(), n)`` to this module's list; with it off, nothing.
  ``counts(t0, t1)`` totals the list inside an interval, ``take()``
  returns the list and clears it.

Every span and counter name starts with ``psq.``.  One lockstep batch is a
``psq.batch`` span (``cli.py``): the spans of one batch nest inside it.
Spans wrap whole steps (a read-back, a loop over candidates), never one
candidate or one event, so a batch makes a few hundred of them.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time

import torch
from torch.autograd.profiler import record_function

_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_records: list = []


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    return record_function(name) if _enabled() else _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Record ``n`` of ``name`` now, while a profiler records."""
    if _enabled():
        _records.append((name, time.perf_counter(), n))


def counts(t0: float = float("-inf"), t1: float = float("inf")) -> dict:
    """{name: total} of the records with t0 <= time <= t1."""
    return _totals(r for r in list(_records) if t0 <= r[1] <= t1)


def take() -> list:
    """The records so far, [(name, perf_counter time, n)]; clears them."""
    out = list(_records)
    del _records[: len(out)]
    return out


def write_counts(path: str) -> None:
    """Write the records so far as JSON (``totals`` and ``records``) and
    clear them."""
    records = take()
    with open(path, "w") as f:
        json.dump({"totals": _totals(records), "records": records}, f)


def _totals(records) -> dict:
    out: dict = {}
    for name, _, n in records:
        out[name] = out.get(name, 0) + n
    return out
