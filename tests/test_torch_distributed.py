"""Multi-process region sharding on the port (CPU): a 2-process
`consensus --coordinator` run against single-process --shard-index runs,
the TCPStore allgather, the coordinator arguments, and --profile."""

import json
import os
import socket
import subprocess
import sys
import threading
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed import TCPStore

from poreseq_tpu.io.fasta import read_fasta
from poreseq_tpu.sim import write_run
from poreseq_tpu_torch.parallel import distributed as dist

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REGIONS = ["synthref:0:100", "synthref:100:200", "synthref:200:300"]
CONF = ("realign_width = 16\nscoring_width = 8\npoint_width = 6\n"
        "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
        "max_length = 10000\nlik_offset = 4.5\n")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_consensus_matches_shard_runs(tmp_path):
    """Two processes joined through --coordinator deal the regions
    round-robin (.p0 holds regions 0 and 2 in one batch, .p1 region 1);
    each shard equals, byte for byte, a single-process run of the same
    batch (--shard-index/--num-shards)."""
    from poreseq_tpu_torch import cli

    _, _, reads, bam, fasta = write_run(
        str(tmp_path), np.random.default_rng(11), ref_len=300, n_reads=4,
        draft_error=0.03)
    conf = tmp_path / "params.conf"
    conf.write_text(CONF)
    rf = tmp_path / "regions.txt"
    rf.write_text("\n".join(REGIONS) + "\n")
    base = ["consensus", fasta, bam, reads, "-R", str(rf), "-p", str(conf),
            "-i", "1", "--region-batch", "2", "--device", "cpu"]

    multi = tmp_path / "multi.fasta"
    port = _free_port()
    # every run on one thread, as this module sets it: a CPU reduction's
    # order may depend on its thread count
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "poreseq_tpu_torch.cli", *base, "-o",
         str(multi), "--coordinator", "127.0.0.1:{}".format(port),
         "--num-processes", "2", "--process-id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    try:
        single = []
        for pid in range(2):
            out = tmp_path / "shard{}.fasta".format(pid)
            cli.main([*base, "-o", str(out), "--shard-index", str(pid),
                      "--num-shards", "2"])
            single.append(out.read_bytes())
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert list(read_fasta("{}.p0".format(multi))) == [REGIONS[0],
                                                       REGIONS[2]]
    assert list(read_fasta("{}.p1".format(multi))) == [REGIONS[1]]
    for pid in range(2):
        assert Path("{}.p{}".format(multi, pid)).read_bytes() == single[pid]


def test_profile_writes_a_chrome_trace(tmp_path):
    """--profile DIR writes one Chrome trace holding the run's batch span
    (-i 0 keeps the run, and so the trace, small)."""
    from poreseq_tpu_torch import cli

    _, _, reads, bam, fasta = write_run(
        str(tmp_path), np.random.default_rng(12), ref_len=100, n_reads=4)
    conf = tmp_path / "params.conf"
    conf.write_text(CONF)
    cli.main(["consensus", fasta, bam, reads, "-r", "synthref:0:100", "-p",
              str(conf), "-i", "0", "--device", "cpu", "-o",
              str(tmp_path / "out.fasta"), "--profile",
              str(tmp_path / "prof")])
    traces = list((tmp_path / "prof").glob("*.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert "psq.batch" in names
    assert list(read_fasta(str(tmp_path / "out.fasta"))) == ["synthref:0:100"]


def test_trace_summary_counts_kernels_and_busy_time(tmp_path, capsys):
    """trace_summary on a synthetic trace: overlapping device intervals
    count once toward busy time, host events only toward the wall."""
    from poreseq_tpu_torch import trace_summary

    ev = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts,
                                          dur=dur)
    path = tmp_path / "t.trace.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("cpu_op", "host", 0, 1000),
        ev("kernel", "fill_kernel", 100, 200),
        ev("kernel", "group_kernel", 250, 100),     # overlaps: +50 busy
        ev("gpu_memcpy", "Memcpy HtoD", 500, 50),
        ev("kernel", "fill_kernel", 900, 300),      # runs past the host
        {"ph": "i", "name": "marker", "ts": 5}]}))
    out = trace_summary.summarize(str(path))
    assert out["wall_ms"] == 1.2 and out["busy_ms"] == 0.6
    assert out["kernels"] == {
        "fill_kernel": {"launches": 2, "device_ms": 0.5},
        "group_kernel": {"launches": 1, "device_ms": 0.1}}
    trace_summary.main([str(path)])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_allgather_round_robin_over_a_tcp_store():
    """Two members over one TCPStore (process 0 hosts it): two rounds of
    round-robin values gather into the same full lists, then the exit
    barrier."""
    port = _free_port()
    got, errors = {}, []

    def member(pid):
        try:
            store = TCPStore("127.0.0.1", port, world_size=2,
                             is_master=pid == 0,
                             timeout=timedelta(seconds=60),
                             wait_for_workers=True)
            a = dist.allgather_round_robin(
                [10 * pid + j for j in range(len(range(pid, 5, 2)))], 5,
                pid, 2, store)
            b = dist.allgather_round_robin([pid + 0.5], 2, pid, 2, store)
            dist.finish_multihost(pid, 2, store)
            got[pid] = (a, b)
        except Exception as e:      # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=member, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert got[0] == got[1] == ([0.0, 10.0, 1.0, 11.0, 2.0], [0.5, 1.5])
    assert dist.allgather_round_robin([1, 2], 2, 0, 1, None) == [1, 2]


def test_coordinator_arguments(monkeypatch):
    monkeypatch.delenv("PSQ_COORDINATOR", raising=False)
    assert dist.init_multihost() == (0, 1, None)
    assert dist.shard_regions(list("abcde"), 1, 2) == ["b", "d"]
    for args in [("127.0.0.1:1", 2, None), (None, 2, 0),
                 ("127.0.0.1:1", 2, 2), ("nohostport", 2, 0)]:
        with pytest.raises(ValueError):
            dist.init_multihost(*args)
    monkeypatch.setenv("PSQ_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="--num-processes"):
        dist.init_multihost()
