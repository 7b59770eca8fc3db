"""The traffic generator: a simulated nanopore run on disk (draft FASTA,
BAM of 2D basecalls, one fast5 file a read) over contiguous regions of one
genome, made from a seed.

A vectorised copy of the port's ``sim.write_run`` (the same generative
model: a synthetic 5-mer model a strand, Gaussian levels, inverse-Gaussian
level noise, skip / stay / insert moves, a 2D basecall with substitutions,
insertions and deletions, a 2D alignment table that seeds the loader),
changed in three ways so that every seed gives the same amount of work in
another order:

- the draft has exactly ``round(draft_error * region_length)`` errors in
  every region, as many insertions as deletions, so that a region keeps
  the truth's length (``write_run`` draws each base);
- the reads lie on a fixed lattice, ``reads_per_region`` starts a region,
  each ``read_length`` long and starting ``(read_length - region_length) /
  2`` before its slot, so every region overlaps the same reads;
- the genome has one region of flank on each side, so the first and last
  regions of the pool see the same reads as the others.

The files use the fast5 layout of the port's reader in its npz form
(``reference/io/npz_h5.py``, the stand-in the port installs where h5py is
missing); the harness has the port read them through that stand-in.
"""

from __future__ import annotations

import os

import numpy as np

from .reference.core.sequence import revcomp, seq_to_states
from .reference.io.bam import CDEL, CINS, CMATCH, CSOFT_CLIP, write_bam
from .reference.io.fast5 import write_fast5
from .reference.io.fasta import write_fasta

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
REF_NAME = "synthref"


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's seed (any integer)."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def random_seq(rng: np.random.Generator, n: int) -> str:
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


def _build(seq: np.ndarray, kind: np.ndarray, new: np.ndarray):
    """Apply per-base edits: kind 0 keep, 1 substitute by ``new``, 2 insert
    ``new`` after the base, 3 delete.  Returns (codes, source map: the
    truth index of each output base, -1 for an insertion)."""
    n = len(seq)
    counts = np.where(kind == 3, 0, np.where(kind == 2, 2, 1))
    src = np.repeat(np.arange(n), counts)
    first = np.ones(len(src), dtype=bool)
    first[1:] = src[1:] != src[:-1]
    out = seq[src].copy()
    out[(kind[src] == 1)] = new[src][(kind[src] == 1)]
    ins = (kind[src] == 2) & ~first
    out[ins] = new[src][ins]
    srcs = np.where(ins, -1, src)
    return out, srcs


def mutate_with_map(rng: np.random.Generator, seq: str, error_rate: float):
    """A copy of seq with each base independently substituted, followed by
    an insertion or deleted at error_rate (a third each): (str, source
    map), as ``sim.mutate_seq_with_map``."""
    codes = np.frombuffer(seq.encode(), dtype=np.uint8)
    n = len(codes)
    err = rng.random(n) < error_rate
    kind = np.where(err, rng.integers(1, 4, n), 0)
    new = BASES[rng.integers(0, 4, n)]
    out, srcs = _build(codes, kind, new)
    return out.tobytes().decode(), srcs


def mutate_exact(rng: np.random.Generator, seq: str, error_rate: float,
                 block: int):
    """A copy of seq with exactly round(error_rate * block) errors in every
    block of ``block`` bases, as many insertions as deletions (a third of
    the errors each, rounded) and substitutions (to another base) for the
    rest: (str, source map)."""
    codes = np.frombuffer(seq.encode(), dtype=np.uint8)
    n = len(codes)
    kind = np.zeros(n, dtype=np.int64)
    per = int(round(error_rate * block))
    for a in range(0, n, block):
        m = min(block, n - a)
        k = min(per, m)
        n_indel = int(round(k / 3))
        pos = a + rng.choice(m, size=k, replace=False)
        kind[pos] = np.repeat([1, 2, 3], [k - 2 * n_indel, n_indel, n_indel])
    shift = rng.integers(1, 4, n)
    sub = BASES[(np.searchsorted(BASES, codes) + shift) % 4]
    ins = BASES[rng.integers(0, 4, n)]
    new = np.where(kind == 1, sub, ins)
    out, srcs = _build(codes, kind, new)
    return out.tobytes().decode(), srcs


def make_model(rng: np.random.Generator) -> dict:
    """A synthetic 1024-entry 5-mer model (``sim.make_model``)."""
    return dict(
        level_mean=rng.permutation(np.linspace(40.0, 90.0, 1024))
        + rng.normal(0, 0.3, 1024),
        level_stdv=rng.uniform(0.8, 1.6, 1024),
        sd_mean=rng.uniform(0.8, 1.8, 1024),
        sd_stdv=rng.uniform(0.3, 0.7, 1024))


def simulate_levels(rng: np.random.Generator, seq: str, model: dict,
                    p_skip: float = 0.1, p_stay: float = 0.08,
                    p_insert: float = 0.01):
    """Levels emitted along seq's 5-mer states (``sim.simulate_levels``):
    a state is skipped with p_skip, else emits 1 + Geometric(p_stay) levels
    and then an inserted level with p_insert.  Returns (mean, stdv, truth
    alignment: the 1-based state of each level, -1 for an insert)."""
    st = seq_to_states(seq)
    n = len(st)
    kept = rng.random(n) >= p_skip
    emit = rng.geometric(1.0 - p_stay, n)
    ins = rng.random(n) < p_insert
    counts = np.where(kept, emit + ins, 0)
    idx = np.repeat(np.arange(n), counts)
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(idx)) - starts[idx]
    is_ins = ins[idx] & (pos == emit[idx])
    s = st[idx]
    lam = model["sd_mean"] ** 3 / model["sd_stdv"] ** 2
    mean = np.where(is_ins, rng.uniform(40.0, 90.0, len(idx)),
                    rng.normal(model["level_mean"][s],
                               model["level_stdv"][s]))
    stdv = np.where(is_ins, rng.wald(1.2, 4.0, len(idx)),
                    rng.wald(model["sd_mean"][s], lam[s]))
    align = np.where(is_ins, -1, idx + 1).astype(np.float64)
    return mean, stdv, align


def cigar_from_map(srcs: np.ndarray):
    """CIGAR ops and reference start from a per-base source map
    (``sim._cigar_from_map``)."""
    aligned = np.nonzero(srcs >= 0)[0]
    first, last = int(aligned[0]), int(aligned[-1])
    ops = []
    if first > 0:
        ops.append([CSOFT_CLIP, first])
    prev = int(srcs[first]) - 1
    for q in range(first, last + 1):
        p = int(srcs[q])
        if p < 0:
            op = CINS
        else:
            if p > prev + 1:
                ops.append([CDEL, p - prev - 1])
            prev = p
            op = CMATCH
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    if last < len(srcs) - 1:
        ops.append([CSOFT_CLIP, len(srcs) - 1 - last])
    return [tuple(o) for o in ops], int(srcs[first])


def _alignment_rows(seq2d: str, srcs: np.ndarray, L: int, al_t, al_c):
    """The 2D alignment table of a read (``sim.write_run``): every third
    level of each strand mapped through the truth 5-mer it came from to the
    first 2D base of that 5-mer; a later level overwrites an earlier one.
    Returns (2D positions, template level or -1, complement level or -1)."""
    n2 = len(seq2d)
    src_to_q = np.full(L, -1, dtype=np.int64)
    ok = srcs >= 0
    vals, first = np.unique(srcs[ok], return_index=True)
    src_to_q[vals] = np.nonzero(ok)[0][first]

    def rows(p):                          # p: 0-based truth 5-mer starts
        js = np.arange(0, len(p) * 3, 3)[: len(p)]
        good = (p >= 0) & (p < L)
        q = np.where(good, src_to_q[np.clip(p, 0, L - 1)], -1)
        good &= (q >= 0) & (q + 5 <= n2)
        out = np.full(n2, -1, dtype=np.int64)
        np.maximum.at(out, q[good], js[good])
        return out

    t = al_t[::3].astype(np.int64)
    pt = np.where(t > 0, t - 1, -1)
    c = al_c[::3].astype(np.int64)
    pc = np.where(c > 0, L - (c - 1) - 5, -1)
    rt, rc = rows(pt), rows(pc)
    qs = np.nonzero((rt >= 0) | (rc >= 0))[0]
    return qs, rt[qs], rc[qs]


def write_read(path: str, rng: np.random.Generator, sub: str,
               basecall_error: float):
    """One read's fast5 file; returns (2D basecall, source map)."""
    seq2d, srcs = mutate_with_map(rng, sub, basecall_error)
    mt = make_model(rng_from(rng))
    mean_t, stdv_t, al_t = simulate_levels(rng, sub, mt)
    mc = make_model(rng_from(rng))
    mean_c, stdv_c, al_c = simulate_levels(rng, revcomp(sub), mc)
    qs, it, ic = _alignment_rows(seq2d, srcs, len(sub), al_t, al_c)
    kmers = [seq2d[q : q + 5] for q in qs]
    strands = {}
    for loc, mean, stdv, m, inds in (("template", mean_t, stdv_t, mt, it),
                                     ("complement", mean_c, stdv_c, mc, ic)):
        strands[loc] = dict(mean=mean, stdv=stdv, align_inds=list(inds),
                            align_kmers=kmers, **m)
    write_fast5(path, seq2d, strands)
    return seq2d, srcs


def rng_from(rng: np.random.Generator) -> np.random.Generator:
    return np.random.default_rng(rng.integers(1 << 31))


def _write_reads(job):
    """Worker: the reads (k, start, end) of one share, each from its own
    stream of the seed, so the files do not depend on the sharing."""
    reads_dir, seed, stream, truth, basecall_error, reads = job
    out = []
    for k, s, e in reads:
        path = os.path.join(reads_dir, "read_{:05d}.fast5".format(k))
        out.append(write_read(path, rng_for(seed, stream, 1, k), truth[s:e],
                              basecall_error))
    return out


def write_run(outdir: str, seed: int, stream: int, n_regions: int,
              region_length: int, read_length: int, reads_per_region: int,
              draft_error: float, basecall_error: float,
              workers: int = 1) -> dict:
    """Write a run whose pool is ``n_regions`` contiguous regions of the
    draft, after one region of flank, from stream ``stream`` of ``seed``
    (the reads over ``workers`` spawned processes; the files are the same
    for any number).  Returns the paths, the region names (draft
    coordinates) and, for each region, its truth span."""
    L = region_length
    reads_dir = os.path.join(outdir, "reads")
    os.makedirs(reads_dir, exist_ok=True)
    G = (n_regions + 2) * L
    rng = rng_for(seed, stream, 0)
    truth = random_seq(rng, G)
    draft, dsrc = mutate_exact(rng, truth, draft_error, L)
    # the draft index of the first draft base at or after each truth index
    t2d = np.searchsorted(_monotone(dsrc), np.arange(G + 1))
    fasta = os.path.join(outdir, "ref.fasta")
    write_fasta(fasta, {REF_NAME: draft})

    spacing = L / reads_per_region
    lead = (read_length - L) / 2
    reads = []
    for k in range(int(round(G / spacing))):
        s = int(round(k * spacing - lead))
        s, e = max(s, 0), min(s + read_length, G)
        if e - s >= L // 2:
            reads.append((k, s, e))
    workers = workers if len(reads) >= 64 * workers else 1
    shares = [reads[i::workers] for i in range(workers)]
    jobs = [(reads_dir, seed, stream, truth, basecall_error, sh)
            for sh in shares if sh]
    if workers > 1 and len(jobs) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(len(jobs), mp_context=ctx) as pool:
            done = list(pool.map(_write_reads, jobs))
    else:
        done = [_write_reads(j) for j in jobs]
    made = {}
    for sh, outs in zip([j[-1] for j in jobs], done):
        for (k, s, e), o in zip(sh, outs):
            made[k] = (s, o)
    records = []
    for k, s, e in reads:
        _, (seq2d, srcs) = made[k]
        cigar, pos = cigar_from_map(srcs)
        records.append(dict(query_name="read_{:05d}.fast5".format(k), flag=0,
                            ref_id=0, pos=int(t2d[pos + s]), mapq=60,
                            cigar=cigar, seq=seq2d))
    bam = os.path.join(outdir, "reads.bam")
    write_bam(bam, [(REF_NAME, len(draft))], records)

    regions, spans = [], []
    for r in range(1, n_regions + 1):
        a, b = int(t2d[r * L]), int(t2d[(r + 1) * L])
        regions.append("{}:{}:{}".format(REF_NAME, a, b))
        spans.append((r * L, (r + 1) * L))
    return dict(dir=outdir, fasta=fasta, bam=bam, reads=reads_dir,
                truth=truth, draft=draft, regions=regions, truth_spans=spans,
                n_reads=len(records))


def _monotone(dsrc: np.ndarray) -> np.ndarray:
    """The truth index of each draft base, insertions taking their
    predecessor's, as a non-decreasing array for searchsorted."""
    return np.maximum.accumulate(np.where(dsrc >= 0, dsrc, -1))
