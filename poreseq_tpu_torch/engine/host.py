"""Shared host-side thread pool for GIL-releasing native work.

The host C core (csrc/host_sw.cpp) is called through ctypes, which drops
the GIL for the duration of each call — Smith-Waterman alignments, event
remaps and final accuracy checks are therefore genuinely parallel across
threads.  One process-wide pool serves every caller so thread count stays
bounded (PSQ_HOST_THREADS overrides; default 8)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

_POOL: ThreadPoolExecutor | None = None


def host_pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        n = int(os.environ.get("PSQ_HOST_THREADS", "8"))
        _POOL = ThreadPoolExecutor(max_workers=max(n, 1),
                                   thread_name_prefix="psq-host")
    return _POOL
