"""Multi-process runs: shared-nothing region dealing over a TCPStore.

Counterpart of ``poreseq_tpu/parallel/distributed.py``.  Processes correct
disjoint round-robin region shares and write their own outputs (``merge``
joins them).  No tensor crosses processes, so there is no process group:
a ``torch.distributed.TCPStore`` hosted by process 0 is the only link.  It
carries ``train``'s accuracy allgather (a handful of floats per iteration)
and the exit barrier that keeps process 0's store up until every process
is done with it.  Each process picks its own device (``--device cuda:N``);
nothing maps processes to cards.

``init_multihost`` returns the store with the process's place in the run;
the caller hands it to ``allgather_round_robin`` and ``finish_multihost``.
"""

from __future__ import annotations

import json
import os
from datetime import timedelta

#: seconds a store operation waits for a peer before the run fails
TIMEOUT_S = 600.0


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> tuple:
    """Join the run at ``coordinator`` (HOST:PORT, or $PSQ_COORDINATOR);
    returns (process_id, num_processes, store).  Without a coordinator and
    a process count this is a single-process run: (0, 1, None), nothing
    opened.  Process 0 hosts the store; every process waits (up to
    ``TIMEOUT_S``) until all have joined."""
    coordinator = coordinator or os.environ.get("PSQ_COORDINATOR")
    if coordinator is None and num_processes is None:
        return 0, 1, None
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator HOST:PORT "
                         "(or PSQ_COORDINATOR), --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is outside "
                         f"0..{num_processes - 1}")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r}: expected HOST:PORT")
    from torch.distributed import TCPStore

    store = TCPStore(host, int(port), world_size=num_processes,
                     is_master=process_id == 0,
                     timeout=timedelta(seconds=TIMEOUT_S),
                     wait_for_workers=True)
    return process_id, num_processes, store


def allgather_round_robin(local_vals, n_total: int, pid: int, nproc: int,
                          store) -> list:
    """Gather per-item values evaluated round-robin (items pid::nproc on
    each process) into the full [n_total] list, the same on every process.
    Every process must call this the same number of times in the same
    order: the call's round id is this process's own call count, kept in
    the store."""
    if nproc <= 1:
        return list(local_vals)
    rnd = store.add("psq_ag/round/{}".format(pid), 1)
    store.set("psq_ag/{}/{}".format(rnd, pid),
              json.dumps([float(v) for v in local_vals]))
    out = [None] * n_total
    for p in range(nproc):
        vals = json.loads(store.get("psq_ag/{}/{}".format(rnd, p)))
        for i, v in zip(range(p, n_total, nproc), vals):
            out[i] = v
    return out


def finish_multihost(pid: int, nproc: int, store) -> None:
    """Exit barrier: process 0, which hosts the store, waits until every
    process has finished with it."""
    if nproc <= 1:
        return
    store.set("psq_exit/{}".format(pid), "1")
    if pid == 0:
        store.wait(["psq_exit/{}".format(p) for p in range(nproc)])


def shard_regions(regions: list[str], pid: int, nproc: int) -> list[str]:
    """This process's round-robin region share (the CLI's
    --shard-index/--num-shards dealing)."""
    return regions[pid::nproc]
