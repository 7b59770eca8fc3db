"""Top-level consensus and variant drivers.

Mirror PoreSeq's poreseq/Mutate.py and Variant.py.  Copy of the JAX
package's ``pipeline.py`` on the port's engines: every entry point takes the
engine to run on, else its ``backend``'s shared engine (``api.get_engine``:
"torch", the default, or "exact", the CPU oracle).
"""

from __future__ import annotations

import sys

import numpy as np

from . import obs
from .api import PSAlign, swalign
from .core.regions import RegionInfo
from .io.fasta import read_fasta
from .io.load import load_aligned_events


def mutate(
    fastafile: str,
    bamfile: str,
    fast5dir: str,
    region: str | None = None,
    params: dict | None = None,
    verbose: int = 0,
    test: bool = False,
    reps: int = 4,
    backend: str = "torch",
    engine=None,
):
    """Consensus error correction of one region (Mutate.py:8-101).

    Returns (sequence, accuracy-vs-loaded-reference)."""
    import os as _os

    fake = _os.environ.get("PSQ_FAKE_MUTATE_S")
    if fake:
        # scaling-bench hook: replaces the region's compute with a fixed
        # sleep so a measured multi-process scaling efficiency isolates the
        # DISTRIBUTED path (coordinator init, shard dealing, output IO) from
        # host CPU contention.  Never set in production.
        import time as _time

        from .io.fasta import load_reference

        _time.sleep(float(fake))
        ri = RegionInfo(region)
        refseq = load_reference(fastafile, ri.name)
        if ri.start is None:
            ri.start, ri.end = 0, len(refseq)
        return (refseq[ri.start : ri.end], 0.0)
    params = dict(params or {})
    if "verbose" not in params:
        params["verbose"] = 0

    pa = load_aligned_events(fastafile, bamfile, fast5dir, RegionInfo(region),
                             params, backend=backend,
                             engine=engine)
    refseq = pa.sequence

    if test and verbose == 0:
        verbose = 1

    # short-circuit when coverage is too thin to help (Mutate.py:48-53)
    if len(pa.events) < 5:
        if verbose > 0:
            sys.stderr.write("Coverage is 1 or 2, not mutating...\n")
        return (refseq, 100)

    if verbose > 0:
        sys.stderr.write(
            "Mutating {} bases using {} events\n".format(len(refseq), len(pa.events))
        )

    if test:
        # seed from the longest-spanning raw 2D read (Mutate.py:59-65)
        seq = ""
        for ev in pa.events:
            pairs = swalign(ev.sequence, refseq)[1]
            if pairs[-1][1] - pairs[0][1] > len(seq):
                seq = ev.sequence[pairs[0][0] : pairs[-1][0]]
        pa.sequence = seq
        sys.stderr.write(
            "Starting accuracy: "
            + str(round(swalign(pa.sequence, refseq)[0], 1)) + "%\n"
        )

    _consensus_rounds(pa, refseq, reps, verbose)

    if "end_trim" in params and len(pa.sequence) > 2 * params["end_trim"]:
        pa.sequence = pa.sequence[int(params["end_trim"]) : -int(params["end_trim"])]

    acc, inds = swalign(pa.sequence, refseq)

    if verbose > 0:
        errs = np.sum(np.array(inds) == 0, 0)
        sys.stderr.write("Final accuracy: " + str(round(acc, 1)) + "%\n")
        sys.stderr.write("Insertions: {}, Deletions: {}\n".format(errs[0], errs[1]))
        sys.stderr.write(
            "Final coverage: " + str(round(np.mean(pa.Coverage()), 1)) + "X\n"
        )

    return (pa.sequence, acc)


def _consensus_rounds(pa, refseq, reps, verbose):
    """One session's Mutate(reps) / (Mutate('viterbi') + Refine) schedule
    (Mutate.py:70-85), each call on the session's engine."""
    pa.Mutate(reps=reps)

    if verbose > 0:
        acc = swalign(pa.sequence, refseq)[0]
        sys.stderr.write("Accuracy: " + str(round(acc, 1)) + "%\n")

    for _ in range(reps):
        pa.Mutate(seqs="viterbi")
        nbases = pa.Refine()
        if verbose > 0:
            acc = swalign(pa.sequence, refseq)[0]
            sys.stderr.write("Accuracy: " + str(round(acc, 1)) + "%\n")
        if nbases == 0:
            break


def load_many(
    fastafile: str,
    bamfile: str,
    fast5dir: str,
    regions: list[str],
    params: dict | None = None,
    backend: str = "torch",
    engine=None,
):
    """Load several regions' sessions, one failure unit per region: returns
    [(pa | None, error | None)] in region order.  Split out of mutate_many so
    the CLI can PREFETCH the next chunk's loads on a thread while the device
    computes the current chunk (host IO was serial with device work)."""
    out = []
    with obs.span("psq.load"):
        for region in regions:
            try:
                pa = load_aligned_events(fastafile, bamfile, fast5dir,
                                         RegionInfo(region),
                                         dict(params or {}),
                                         backend=backend, engine=engine)
                out.append((pa, None))
            except Exception as e:
                out.append((None, str(e)))
    return out


def mutate_many(
    fastafile: str,
    bamfile: str,
    fast5dir: str,
    regions: list[str],
    params: dict | None = None,
    verbose: int = 0,
    test: bool = False,
    reps: int = 4,
    backend: str = "torch",
    engine=None,
    loaded: list | None = None,
):
    """Lockstep consensus of SEVERAL regions: one device program per round
    serves every region (engine/multi.py), the host control flow per region
    is identical to mutate().  Returns [(sequence, accuracy)] per region.

    This is the lockstep replacement for the reference's one-job-per-region
    cluster splitting (split_fasta.py, README.md:48-62).

    loaded: optional pre-loaded [(pa | None, error | None)] from load_many
    (the CLI prefetches the next chunk while the current one computes)."""
    from .engine.multi import mutate_datas, refine_datas
    from .engine.types import AlignData

    params = dict(params or {})
    if "verbose" not in params:
        params["verbose"] = 0
    if test and verbose == 0:
        verbose = 1

    if loaded is None:
        loaded = load_many(fastafile, bamfile, fast5dir, regions, params,
                           backend=backend, engine=engine)

    n = len(regions)
    results: list = [None] * n
    sessions = []          # (slot, pa, refseq)
    for i, region in enumerate(regions):
        # failure unit = one region, like the sequential CLI loop
        # (cmdline.py:182-188); a failed load skips only that region
        pa, err = loaded[i]
        if pa is None:
            sys.stderr.write("Skipping {}: {}\n".format(region, err))
            continue
        refseq = pa.sequence
        if len(pa.events) < 5:
            if verbose > 0:
                sys.stderr.write("Coverage is 1 or 2, not mutating...\n")
            results[i] = (refseq, 100)
            continue
        if verbose > 0:
            sys.stderr.write("Mutating {} bases using {} events [{}]\n".format(
                len(refseq), len(pa.events), region))
        if test:
            seq = ""
            for ev in pa.events:
                pairs = swalign(ev.sequence, refseq)[1]
                if pairs[-1][1] - pairs[0][1] > len(seq):
                    seq = ev.sequence[pairs[0][0] : pairs[-1][0]]
            pa.sequence = seq
            sys.stderr.write(
                "Starting accuracy: "
                + str(round(swalign(pa.sequence, refseq)[0], 1)) + "%\n")
        sessions.append((i, pa, refseq))

    for slot, result in _lockstep_consensus(sessions, params, reps,
                                            verbose).items():
        results[slot] = result
    obs.count("psq.regions", sum(r is not None for r in results))
    return results


def _lockstep_consensus(sessions, params, reps, verbose):
    """The Mutate(reps) / (viterbi-Mutate + Refine) schedule of mutate()
    (Mutate.py:70-85) for SEVERAL loaded sessions in lockstep: one device
    program per propose/score round serves every session.  Sessions may be
    different regions (mutate_many) or the same region under different
    parameter candidates (train_candidates) — per-event likelihood params
    ride in the device batch either way.

    ``sessions`` is [(slot, pa, refseq)]; returns {slot: (seq, acc)} with the
    end-trim and final-accuracy bookkeeping of Mutate.py:88-99.  On an
    engine without batched calls (the exact oracle) the sessions run one
    after another on mutate()'s schedule, so each result, and the libc
    rand() draws of each Viterbi call, are those of a sequential run."""
    from .engine.multi import mutate_datas, refine_datas
    from .engine.types import AlignData

    results = {}
    engine = sessions[0][1].engine if sessions else None
    if sessions and not hasattr(engine, "score_mutations_multi"):
        for _, pa, refseq in sessions:
            _consensus_rounds(pa, refseq, reps, verbose)
    elif sessions:
        # ---- phase 1: Mutate(reps) from the reads' own 2D basecalls ----
        with obs.span("psq.sync"):
            datas = [AlignData.from_session(pa) for _, pa, _ in sessions]
        seqs_list = [[x.sequence for x in pa.events[::2]]
                     for _, pa, _ in sessions]
        mutate_datas(engine, datas, seqs_list, reps)
        getattr(engine, "flush_ref_likes", lambda: None)()
        with obs.span("psq.sync"):
            for (_, pa, _), data in zip(sessions, datas):
                data.sync_back(pa)
        if verbose > 0:
            for _, pa, refseq in sessions:
                acc = swalign(pa.sequence, refseq)[0]
                sys.stderr.write("Accuracy: " + str(round(acc, 1)) + "%\n")

        # ---- phase 2: reps x (Mutate(viterbi), Refine) per live region ----
        done = [False] * len(sessions)
        point_width = params.get("point_width")
        for _ in range(reps):
            if all(done):
                break
            live = [not d for d in done]
            with obs.span("psq.sync"):
                datas = [AlignData.from_session(pa) for _, pa, _ in sessions]
            vm_multi = getattr(engine, "viterbi_mutate_multi", None)
            if vm_multi is not None:
                # one device round-trip for ALL live regions' candidate
                # generation (equal per-region outputs to the solo calls)
                seqs_list = vm_multi(
                    [datas[j].events if live[j] else []
                     for j in range(len(sessions))],
                    16, 0.05, 0.01, 0.33, 0.75, params["verbose"])
            else:
                seqs_list = [
                    engine.viterbi_mutate(datas[j].events, 16, 0.05, 0.01,
                                          0.33, 0.75, params["verbose"])
                    if live[j] else []
                    for j in range(len(sessions))]
            mutate_datas(engine, datas, seqs_list, reps, live=live)
            getattr(engine, "flush_ref_likes", lambda: None)()
            with obs.span("psq.sync"):
                for j, (_, pa, _) in enumerate(sessions):
                    if live[j]:
                        datas[j].sync_back(pa)
                datas = [AlignData.from_session(pa) for _, pa, _ in sessions]
            nbases = refine_datas(engine, datas, live=live,
                                  point_width=point_width)
            getattr(engine, "flush_ref_likes", lambda: None)()
            with obs.span("psq.sync"):
                for j, (_, pa, _) in enumerate(sessions):
                    if live[j]:
                        datas[j].sync_back(pa)
            for j, (_, pa, refseq) in enumerate(sessions):
                if not live[j]:
                    continue
                if verbose > 0:
                    acc = swalign(pa.sequence, refseq)[0]
                    sys.stderr.write("Accuracy: " + str(round(acc, 1)) + "%\n")
                if nbases[j] == 0:
                    done[j] = True

    # final accuracy SW per region, parallel on the host pool (the C core
    # releases the GIL; these are independent and were ~serial seconds per
    # batch between the last device call and emit)
    from .engine.host import host_pool

    def _final(args):
        i, pa, refseq = args
        seq = pa.sequence
        if "end_trim" in params and len(seq) > 2 * params["end_trim"]:
            seq = seq[int(params["end_trim"]) : -int(params["end_trim"])]
        return seq, swalign(seq, refseq)

    with obs.span("psq.final"):
        finals = list(host_pool().map(_final, sessions))
    for (i, pa, refseq), (seq, (acc, inds)) in zip(sessions, finals):
        if verbose > 0:
            errs = np.sum(np.array(inds) == 0, 0)
            sys.stderr.write("Final accuracy: " + str(round(acc, 1)) + "%\n")
            sys.stderr.write("Insertions: {}, Deletions: {}\n".format(
                errs[0], errs[1]))
            sys.stderr.write("Final coverage: "
                             + str(round(np.mean(pa.Coverage()), 1)) + "X\n")
        results[i] = (seq, acc)
    return results


def train_candidates(
    fastafile: str,
    bamfile: str,
    fast5dir: str,
    region: str | None,
    paramlist: list[dict],
    descend: bool = False,
    reps: int = 10,
    backend: str = "torch",
    engine=None,
    verbose: int = 1,
):
    """One training iteration's parameter candidates (Params.py:31-57) run as
    ONE lockstep batch: the batched replacement for the reference's
    `multiprocessing.Pool(threads).map(trainhelper)` (cmdline.py:258-259).

    The candidates differ only in the `*_t`/`*_c` emission/transition
    probabilities (vary_params), which live per-event in the device batch —
    so the region is loaded once, events are cloned per candidate with that
    candidate's `setparams`, and all candidates share every device program.
    Returns [(sequence, accuracy)] in paramlist order, like mapping
    trainhelper over the pool."""
    base_params = dict(paramlist[0])
    base_params.setdefault("verbose", 0)
    pa0 = load_aligned_events(fastafile, bamfile, fast5dir,
                              RegionInfo(region), base_params,
                              backend=backend, engine=engine)
    refseq = pa0.sequence
    if len(pa0.events) < 5:
        if verbose > 0:
            sys.stderr.write("Coverage is 1 or 2, not mutating...\n")
        return [(refseq, 100)] * len(paramlist)

    test = not descend
    seed = refseq
    if test:
        # the seed read does not depend on params: pick it once
        seed = ""
        for ev in pa0.events:
            pairs = swalign(ev.sequence, refseq)[1]
            if pairs[-1][1] - pairs[0][1] > len(seed):
                seed = ev.sequence[pairs[0][0] : pairs[-1][0]]
        sys.stderr.write(
            "Starting accuracy: "
            + str(round(swalign(seed, refseq)[0], 1)) + "%\n")

    sessions = []
    for i, p in enumerate(paramlist):
        p = dict(p)
        p.setdefault("verbose", 0)
        pa = PSAlign(backend=backend, engine=engine)
        pa.sequence = seed
        pa.events = (pa0.events if i == 0
                     else [ev.light_copy() for ev in pa0.events])
        if len(p) > 0:
            for ev in pa.events:
                ev.setparams(p)
        pa.params = p
        sessions.append((i, pa, refseq))

    results = _lockstep_consensus(sessions, base_params, reps, verbose)
    return [results[i] for i in range(len(paramlist))]


def variant(
    ref_fasta: str,
    bamfile: str,
    fast5dir: str,
    var_fasta: str | None = None,
    muts=None,
    region: str | None = None,
    params: dict | None = None,
    verbose: int = 0,
    backend: str = "torch",
    engine=None,
):
    """Variant scoring (Variant.py:11-95): either whole candidate sequences
    from var_fasta (RealignTo + ScoreEvents deltas) or a list of mutations
    (ScoreMutations / ScorePoints)."""
    params = dict(params or {})
    reginfo = RegionInfo(region)
    pa = load_aligned_events(ref_fasta, bamfile, fast5dir, reginfo, params,
                             backend=backend, engine=engine)
    pa.params["verbose"] = verbose

    if var_fasta is not None:
        variants = read_fasta(var_fasta)
        if verbose > 0:
            sys.stderr.write(
                "Variant calling {} variant sequences with {} bases using {}"
                " events\n".format(len(variants), len(pa.sequence), len(pa.events))
            )
        basescore = np.sum(pa.ScoreEvents())
        variantscores = {}
        for vid, varseq in variants.items():
            pav = pa.Copy()
            pav.RealignTo(varseq)
            dscore = np.sum(pav.ScoreEvents()) - basescore
            sys.stdout.write("{}, {}\n".format(vid, dscore))
            variantscores[vid] = dscore
        return variantscores

    if muts is not None:
        if verbose > 0:
            sys.stderr.write(
                "Variant calling {} using {} events\n".format(region, len(pa.events))
            )
        for m in muts:
            m.start -= reginfo.start
        if len(muts) > 0:
            mutscores = pa.ScoreMutations(muts)
        else:
            mutscores = pa.ScorePoints()

        npos = 0
        ntot = 0
        for ms in mutscores:
            if (ms.start > params["end_trim"]
                    and ms.start < len(pa.sequence) - params["end_trim"]):
                ntot += 1
                if ms.score > 0:
                    npos += 1
            ms.start += reginfo.start
            sys.stdout.write(str(ms) + "\n")

        if verbose > 0:
            sys.stderr.write(
                "{}% positive variants\n".format(100 * float(npos) / ntot)
            )
            sys.stderr.write(
                "Final coverage: " + str(round(np.mean(pa.Coverage()), 1)) + "X\n"
            )
        return mutscores
