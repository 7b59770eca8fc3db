"""The benchmark of the poreseq_tpu_torch port on NVIDIA GPUs.

    python3 -m psq_benchmark.run --workload NAME --seed N --seconds S \\
        --trace 0|1

One run of one cell of ``BENCHMARK.json``: it simulates the cell's region
pool and a warm-up batch from ``--seed`` (``simulate.py``, under
``$TMPDIR``), builds the port's kernels into the checkout's
``poreseq_tpu_torch/_build/`` (only a checkout's first run compiles),
warms up on the warm-up batch through the cell's own entry, then runs the
entry (the port's CLI, ``poreseq_tpu_torch.cli.main``, in this process)
over the pool and measures a window of whole batches: it closes at the
first batch (``consensus``) or region (``variant -a``) boundary at or
after ``--seconds``, or at the end of the pool.  After the window it
checks the outputs against the reference (``check.py``) and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, from
spans the benchmark puts around the port's layers and a torch.profiler
trace of the window), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last (each number compared with its limit, also printed as the
last lines on stderr).

Without a CUDA card, or with fewer than the cell asks for, it exits 2
and prints no result; it never runs on the CPU.  It exits 3 if jax,
jaxlib, flax or the JAX package poreseq_tpu is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import io
import json
import os
import shutil
import sys
import tempfile
import time

T_IMPORT = time.time()

FORBIDDEN = ("jax", "jaxlib", "flax", "poreseq_tpu")


class WindowClosed(BaseException):
    """Raised into the port's CLI at the first boundary past the window;
    a BaseException, so no per-region failure unit of the CLI takes it."""


def process_start() -> float:
    """The process's start on the wall clock (from /proc), else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return T_IMPORT


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------ the window


class Window:
    """Wraps the port's per-batch entry (``pipeline.mutate_many``) or
    per-region entry (``pipeline.variant``): records each completed call
    and raises WindowClosed at the first call that starts after the last
    completed one ended at or past the window's length."""

    def __init__(self, seconds: float | None, name: str):
        self.seconds = seconds
        self.name = name
        self.t0 = None
        self.t1 = None
        self.done: list = []          # (args, result or None if raised)

    def wrap(self, real):
        from torch.profiler import record_function

        def wrapped(*args, **kwargs):
            if (self.seconds is not None and self.t1 is not None
                    and self.t1 - self.t0 >= self.seconds):
                raise WindowClosed
            result = None
            try:
                with record_function(self.name):
                    result = real(*args, **kwargs)
            finally:
                self.t1 = time.perf_counter()
                self.done.append((args, result))
            return result

        return wrapped


class CallRecord:
    """Records one call of the port's ``TorchEngine.score_mutations_multi``
    in the window, the ``target``-th that scores any mutation: the state it
    is given and the scores it returns (``check.call_gap``).  A batch's
    rounds make such calls for the 'self' candidates and for every
    Refine (each of a region's positions), so a target below 3 is
    reached in the first batches of any window."""

    def __init__(self, target: int):
        self.target = target
        self.calls = 0
        self.state = None
        self.scores = None

    def wrap(self, real):
        from . import check

        def wrapped(engine, datas, muts_list):
            if not any(muts_list):
                return real(engine, datas, muts_list)
            i, self.calls = self.calls, self.calls + 1
            if i != self.target:
                return real(engine, datas, muts_list)
            state = check.snapshot(datas, muts_list)
            out = real(engine, datas, muts_list)
            self.state = state
            self.scores = [[m.score for m in ms] for ms in out]
            return out

        return wrapped


class Entry:
    """How the cell's traffic drives the port: its CLI argv, the pipeline
    function a boundary falls after, and what a completed call yields."""

    kind = ""
    boundary = ""

    def __init__(self, cell, workdir: str, params_path: str):
        self.cell = cell
        self.workdir = workdir
        self.params_path = params_path

    def regions_of(self, args) -> list:
        raise NotImplementedError


class Consensus(Entry):
    kind = "consensus"
    boundary = "mutate_many"

    def argv(self, run: dict, tag: str) -> list:
        t = self.cell.traffic
        out = os.path.join(self.workdir, tag + ".fasta")
        rf = os.path.join(self.workdir, tag + ".regions")
        with open(rf, "w") as f:
            f.write("\n".join(run["regions"]) + "\n")
        self.output = out
        return ["consensus", run["fasta"], run["bam"], run["reads"], "-R", rf,
                "-p", self.params_path, "-o", out,
                "-i", str(t["iterations"]),
                "--region-batch", str(t["region_batch"]),
                "--device", "cuda"]

    def regions_of(self, args) -> list:
        return list(args[3])

    def outputs(self) -> dict:
        from .reference.io.fasta import read_fasta

        return read_fasta(self.output) if os.path.exists(self.output) else {}


class VariantAll(Entry):
    kind = "variant_all"
    boundary = "variant"

    def argv(self, run: dict, tag: str) -> list:
        rf = os.path.join(self.workdir, tag + ".regions")
        with open(rf, "w") as f:
            f.write("\n".join(run["regions"]) + "\n")
        self.output = os.path.join(self.workdir, tag + ".scores")
        return ["variant", run["fasta"], run["bam"], run["reads"], "-a",
                "-R", rf, "-p", self.params_path, "--device", "cuda"]

    def regions_of(self, args) -> list:
        return [args[5]]


ENTRIES = {"consensus": Consensus, "variant_all": VariantAll}


def params_text(params: dict) -> str:
    return "".join(f"{k} = {v}\n" for k, v in params.items())


def simulate(cell, seed: int, workdir: str, stream: int, n_regions: int,
             workers: int = 1):
    from .simulate import write_run

    c = cell.config
    return write_run(os.path.join(workdir, f"run{stream}"), seed, stream,
                     n_regions=n_regions, workers=workers,
                     region_length=c["region_length"],
                     read_length=c["read_length"],
                     reads_per_region=c["reads_per_region"],
                     draft_error=c["draft_error"],
                     basecall_error=c["basecall_error"])


def call_cli(argv: list) -> str:
    """The port's CLI in this process; returns what it printed (the
    variant scores), kept in memory as a pipe would carry it, so that this
    process's own stdout carries only the result."""
    from poreseq_tpu_torch import cli

    sink = io.StringIO()
    try:
        with contextlib.redirect_stdout(sink):
            cli.main(argv)
    except WindowClosed:
        pass
    return sink.getvalue()


def build_kernels():
    """Build (or load from the checkout's cache) every kernel library and
    the host C++ core, all builds at once."""
    from concurrent.futures import ThreadPoolExecutor

    import poreseq_tpu_torch.engine.align  # noqa: F401  (defines kernels)
    import poreseq_tpu_torch.engine.mutscore  # noqa: F401
    import poreseq_tpu_torch.engine.viterbi  # noqa: F401
    from poreseq_tpu_torch._build import KERNELS
    from poreseq_tpu_torch.engine import _native

    _native.lib()
    with ThreadPoolExecutor(max(len(KERNELS), 1)) as pool:
        list(pool.map(lambda k: k.lib(), KERNELS))
    return sum(k.build_seconds for k in KERNELS)


def fixed_caches(root: str):
    """Compiler caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".psq_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


class RunView:
    """What a per-layer metric's reader gets: the window, the work done in
    it, the recorder's spans and the trace (None when not traced)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def sample(names: list, k: int | None, seed: int) -> list:
    from .simulate import rng_for

    if k is None or k >= len(names):
        return list(names)
    pick = rng_for(seed, 7).choice(len(names), size=k, replace=False)
    return [names[i] for i in sorted(pick)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    from . import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        sys.stderr.write(
            "psq_benchmark: the cell needs {} CUDA card(s); torch sees {}\n"
            .format(cell.chips, torch.cuda.device_count()
                    if torch.cuda.is_available() else 0))
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, control: bool = False):
    """One run; returns the result dict, or None where a forbidden module
    was loaded.  ``device`` "cpu" runs the kernels' twins, for the tests
    at small sizes only.  ``control`` also reads the control (the
    reference in bfloat16 in the port's place) on the checked regions,
    under the result's "control" key; the benchmark's runs never do.  The
    run's files live in a directory under $TMPDIR, removed at the end."""
    from . import spec

    fixed_caches(spec.ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    workdir = tempfile.mkdtemp(prefix="psq_benchmark_")
    try:
        return _run_cell(cell, seed, seconds, traced, device, t_start,
                         control, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run_cell(cell, seed, seconds, traced, device, t_start, control,
              workdir):
    import torch

    from . import check, spans as spans_mod, spec
    from . import trace as trace_mod
    from .simulate import rng_for

    conf, traffic = cell.config, cell.traffic
    params_path = os.path.join(workdir, "params.conf")
    with open(params_path, "w") as f:
        f.write(params_text(conf["params"]))
    entry_cls = ENTRIES[traffic["entry"]]

    # ---- set-up: data, kernels, warm-up
    pool = simulate(cell, seed, workdir, 0, traffic["pool_regions"],
                    workers=min(8, os.cpu_count() or 1))
    warm = simulate(cell, seed, workdir, 1, traffic.get("region_batch", 1))
    from poreseq_tpu_torch.io import npz_h5

    sys.modules["h5py"] = npz_h5      # the port reads the npz fast5 files
    from poreseq_tpu_torch import pipeline

    if device == "cuda":
        build_kernels()
    entry = entry_cls(cell, workdir, params_path)
    warm_argv = _device(entry.argv(warm, "warm"), device)
    call_cli(warm_argv)
    if device == "cuda":
        torch.cuda.synchronize()

    # ---- the window
    rec = spans_mod.Recorder()
    if traced:
        spans_mod.install(rec, conf["dtype"])
    window = Window(seconds, "pipeline." + entry.boundary)
    real = getattr(pipeline, entry.boundary)
    setattr(pipeline, entry.boundary, window.wrap(real))
    from poreseq_tpu_torch.engine import TorchEngine

    record = CallRecord(int(rng_for(seed, 8).integers(0, 3)))
    real_score = TorchEngine.score_mutations_multi
    if entry.kind == "consensus":
        TorchEngine.score_mutations_multi = record.wrap(real_score)
    argv = _device(entry.argv(pool, "pool"), device)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        win_range = record_function(trace_mod.WINDOW)
        win_range.__enter__()
    # the harness's own objects (the pool's truth, the warm-up's leftovers)
    # out of the collector's sight, as in a process that runs only the CLI
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start
    window.t0 = time.perf_counter()
    printed_text = call_cli(argv)
    gc.unfreeze()
    t_close = window.t1 if window.t1 is not None else time.perf_counter()
    regions = list(dict.fromkeys(r for a, _ in window.done
                                 for r in entry.regions_of(a)))
    exhausted = len(regions) >= len(pool["regions"])
    if traced:
        win_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    setattr(pipeline, entry.boundary, real)
    TorchEngine.score_mutations_multi = real_score
    rec.restore()
    wall = t_close - window.t0
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write("psq_benchmark: loaded in this process: {}\n"
                         .format(", ".join(bad)))
        return None
    if exhausted:
        sys.stderr.write(
            "psq_benchmark: the window reached the end of the pool ({} "
            "regions): grow pool_regions in the traffic file\n".format(
                len(pool["regions"])))

    kb_region = conf["region_length"] / 1000.0
    kb = len(regions) * kb_region
    if entry.kind == "consensus":
        outputs = entry.outputs()
        done = {r: outputs[r] for r in regions if r in outputs}
        failed = len(regions) - len(done)
        errs = 0
        for r in done:
            a, b = pool["truth_spans"][pool["regions"].index(r)]
            errs += check.residual_errors(
                done[r], pool["truth"][max(a - 400, 0) : b + 400])
        out_kb = sum(len(s) for s in done.values()) / 1000.0
        errors_per_kb = errs / out_kb if out_kb else float("inf")
        e2e = {"kb_per_hour": kb / wall * 3600.0}
    else:
        printed = _split_scores(printed_text, regions)
        failed = sum(1 for r in regions if not printed.get(r))
        n_scores = sum(len(v) for v in printed.values())
        errors_per_kb = None
        e2e = {"mutations_scored_per_s": n_scores / wall}
    e2e["setup_s"] = setup_s

    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- per-layer metrics from the spans and the trace
    breakdown = None
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        tr = None
        if device == "cuda":
            path = os.path.join(workdir, "window.trace.json")
            prof.export_chrome_trace(path)
            events = trace_mod.load(path)
            names = {*spans_mod.SPAN_NAMES, trace_mod.WINDOW, window.name}
            tr = trace_mod.Trace(events, names)
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s()
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": tr.idle_gaps(
                             trace_mod.main_tid(events))}
        view = RunView(entry=entry.kind, rec=rec, t0=window.t0, t1=t_close,
                       kb=kb, kb_region=kb_region, trace=tr,
                       dtype=conf["dtype"], errors_per_kb=errors_per_kb)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}

    sys.stderr.write("psq_benchmark: window {:.3f} s, {} regions, {:.3f} kb, "
                     "set-up {:.3f} s, errors/kb {!r}\n".format(
                         wall, len(regions), kb, setup_s, errors_per_kb))
    if device == "cuda":
        from poreseq_tpu_torch._build import KERNELS

        sys.stderr.write("psq_benchmark: launches {}\n".format(json.dumps(
            {k.name: [k.launches, dict(k.instances)] for k in KERNELS})))

    # ---- correctness, after the window, with the program's state freed
    t_check = time.perf_counter()
    lim = cell.limits
    block = lim.get("block_regions", 8)
    inf = float("inf")
    readings, ctrl = {}, {}
    if entry.kind == "consensus":
        picked = sample(sorted(done), lim.get("check_regions"), seed)
        judged = {r: done[r] for r in picked}
        readings["call_gap"] = (check.call_gap(record.state, record.scores,
                                               device)
                                if record.state is not None else inf)
        gaps = (check.optimum_gap(pool, conf["params"], judged, device,
                                  block) if picked else
                {"region_per_kb": inf, "per_kb": inf, "widest": inf})
        readings["optimum_gap"] = gaps["region_per_kb"]
        sys.stderr.write("psq_benchmark: optimum gap per kb {!r}, widest "
                         "{!r}\n".format(gaps["per_kb"], gaps["widest"]))
        if control:
            ctrl["call_gap"] = (check.call_gap(record.state, record.scores,
                                               device, control=True)
                                if record.state is not None else inf)
            ctrl["optimum_gap"] = check.optimum_gap(
                pool, conf["params"], judged, device, block,
                control=True)["region_per_kb"]
    else:
        picked = sample([r for r in regions if printed.get(r)],
                        lim.get("check_regions"), seed)
        judged = {r: printed[r] for r in picked}
        readings["score_gap"] = (check.score_gap(pool, conf["params"], judged,
                                                 device, block)
                                 if picked else inf)
        if control:
            ctrl["score_gap"] = check.score_gap(pool, conf["params"], judged,
                                                device, block, control=True)
    # a number the limits file leaves out is printed, not compared
    checks = {k: {"value": v, "limit": lim[k]} for k, v in readings.items()
              if k in lim}
    checks["regions_checked"] = {"value": len(picked),
                                 "limit": lim.get("min_checked", 1)}
    correct = (failed == 0 and len(picked) >= lim.get("min_checked", 1)
               and all(v["value"] <= v["limit"] for k, v in checks.items()
                       if k != "regions_checked"))
    sys.stderr.write("psq_benchmark: checked {} regions in {:.3f} s\n".format(
        len(picked), time.perf_counter() - t_check))
    for k, v in readings.items():
        if k not in checks:
            sys.stderr.write("reading {} {!r} (not compared)\n".format(k, v))
    for k, v in checks.items():
        sys.stderr.write("check {} {!r} limit {!r}\n".format(
            k, v["value"], v["limit"]))
    result = {"correct": bool(correct), "attempted": len(regions),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = readings
    if control:
        result["control"] = ctrl
    result["checks"] = checks
    return result


def _device(argv: list, device: str) -> list:
    return argv if device == "cuda" else [
        device if a == "cuda" else a for a in argv]


def _split_scores(text: str, regions: list) -> dict:
    """The printed score lines of each region: those whose start lies in
    it (the pool's regions do not overlap)."""
    from .reference.core.regions import RegionInfo

    spans = sorted((RegionInfo(r).start, RegionInfo(r).end, r)
                   for r in regions)
    starts = [a for a, _, _ in spans]
    out = {r: [] for r in regions}
    for line in text.splitlines():
        if not line.strip():
            continue
        pos = int(line.split("\t", 1)[0])
        i = bisect.bisect_right(starts, pos) - 1
        if i >= 0 and pos < spans[i][1]:
            out[spans[i][2]].append(line)
    return out


if __name__ == "__main__":
    sys.exit(main())
