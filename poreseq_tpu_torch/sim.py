"""Synthetic nanopore squiggle simulator.

Generates 5-mer models, reference sequences, and event traces consistent with
the reference's generative assumptions (Gaussian level mean, inverse-Gaussian
level noise, skip/stay/insert transitions — cpp/Alignment.cpp:167-174 and
Appendix A of SURVEY.md), so the full consensus/variant pipeline can be
exercised and benchmarked without real fast5 data.
"""

from __future__ import annotations

import numpy as np

from .core.events import Event, Model
from .core.sequence import revcomp, seq_to_states

_BASES = np.array(list("ACGT"))


def random_seq(rng: np.random.Generator, n: int) -> str:
    return "".join(_BASES[rng.integers(0, 4, n)])


def make_model(rng: np.random.Generator, complement: bool = False) -> Model:
    """A synthetic but ONT-shaped 1024-entry 5-mer model: distinct current
    levels per kmer, modest spread, positive noise scales."""
    m = Model()
    m.level_mean = rng.permutation(np.linspace(40.0, 90.0, 1024)) + rng.normal(
        0, 0.3, 1024
    )
    m.level_stdv = rng.uniform(0.8, 1.6, 1024)
    m.sd_mean = rng.uniform(0.8, 1.8, 1024)
    m.sd_stdv = rng.uniform(0.3, 0.7, 1024)
    m.complement = complement
    m.name = "synthetic"
    return m


def mutate_seq_with_map(rng: np.random.Generator, seq: str, error_rate: float):
    """Mutated copy plus per-output-base source map (source index or -1 for
    inserted bases)."""
    out = []
    srcs = []
    for i, c in enumerate(seq):
        r = rng.random()
        if r < error_rate:
            kind = rng.integers(0, 3)
            if kind == 0:  # substitution
                out.append(str(_BASES[rng.integers(0, 4)]))
                srcs.append(i)
            elif kind == 1:  # insertion
                out.append(c)
                srcs.append(i)
                out.append(str(_BASES[rng.integers(0, 4)]))
                srcs.append(-1)
            # kind == 2: deletion -> skip
        else:
            out.append(c)
            srcs.append(i)
    return "".join(out), np.asarray(srcs, dtype=np.int64)


def mutate_seq(rng: np.random.Generator, seq: str, error_rate: float) -> str:
    """Introduce random substitutions/insertions/deletions at error_rate."""
    return mutate_seq_with_map(rng, seq, error_rate)[0]


def simulate_levels(
    rng: np.random.Generator,
    seq: str,
    model: Model,
    p_skip: float = 0.1,
    p_stay: float = 0.08,
    p_insert: float = 0.01,
):
    """Walk the sequence's 5-mer states emitting noisy current levels.

    Returns (mean, stdv, truth_align) where truth_align[i] is the 1-based
    sequence state index each level was emitted from (-1 for inserts)."""
    states = seq_to_states(seq)
    lam = model.sd_mean**3 / model.sd_stdv**2
    means, stdvs, align = [], [], []
    for k, st in enumerate(states):
        if rng.random() < p_skip:
            continue
        n_emit = 1
        while rng.random() < p_stay:
            n_emit += 1
        for _ in range(n_emit):
            means.append(rng.normal(model.level_mean[st], model.level_stdv[st]))
            stdvs.append(rng.wald(model.sd_mean[st], lam[st]))
            align.append(k + 1)
        if rng.random() < p_insert:
            means.append(rng.uniform(40.0, 90.0))
            stdvs.append(rng.wald(1.2, 4.0))
            align.append(-1)
    return (
        np.asarray(means, dtype=np.float64),
        np.asarray(stdvs, dtype=np.float64),
        np.asarray(align, dtype=np.float64),
    )


def simulate_event(
    rng: np.random.Generator,
    true_seq: str,
    model: Model,
    seed_subsample: float = 0.25,
    seed_jitter: int = 2,
    basecall_error: float = 0.12,
    **kw,
) -> Event:
    """One synthetic strand: noisy levels from true_seq, a degraded 2D
    'basecalled' sequence, and a deliberately-imperfect seed ref_align
    (mimicking the BAM-derived seed the real loader produces)."""
    mean, stdv, truth = simulate_levels(rng, true_seq, model, **kw)
    n = len(mean)
    # degrade the truth alignment into a seed: subsample + jitter
    ref_align = np.zeros(n, dtype=np.float64)
    keep = (rng.random(n) < seed_subsample) & (truth > 0)
    jit = rng.integers(-seed_jitter, seed_jitter + 1, n)
    vals = np.clip(truth + jit, 1, max(len(true_seq) - 4, 1))
    ref_align[keep] = vals[keep]
    ev = Event(
        mean=mean,
        stdv=stdv,
        length=np.ones(n),
        start=np.arange(n, dtype=np.float64),
        ref_align=ref_align,
        ref_like=np.zeros(n),
        model=model,
        sequence=mutate_seq(rng, true_seq, basecall_error),
    )
    return ev


def simulate_session(
    rng: np.random.Generator,
    ref_len: int = 1000,
    coverage: int = 10,
    draft_error: float = 0.0,
    engine=None,
    params: dict | None = None,
    **kw,
):
    """Build a PSAlign session over a synthetic region.

    draft_error > 0 degrades the loaded reference so the consensus loop has
    real errors to correct (truth is returned for accuracy checks)."""
    from .api import PSAlign

    truth = random_seq(rng, ref_len)
    draft = mutate_seq(rng, truth, draft_error) if draft_error > 0 else truth
    pa = PSAlign(engine=engine)
    pa.sequence = draft
    pa.params = dict(params or {})
    pa.params.setdefault("verbose", 0)
    events = []
    for _ in range(coverage):
        model = make_model(np.random.default_rng(rng.integers(1 << 31)))
        ev = simulate_event(rng, truth, model, **kw)
        events.append(ev)
    pa.events = events
    return pa, truth


# ---------------------------------------------------------------------------
# Full synthetic runs on disk (fast5 + BAM + FASTA) for CLI / loader tests
# ---------------------------------------------------------------------------


def _cigar_from_map(srcs: np.ndarray):
    """CIGAR ops + reference start from a per-base source map (S/M/I/D)."""
    from .io.bam import CMATCH, CINS, CDEL, CSOFT_CLIP

    aligned = np.nonzero(srcs >= 0)[0]
    first, last = int(aligned[0]), int(aligned[-1])
    pos = int(srcs[first])
    ops = []
    if first > 0:
        ops.append([CSOFT_CLIP, first])
    prev = pos - 1
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
    return [tuple(o) for o in ops], pos


def write_run(
    outdir: str,
    rng: np.random.Generator,
    ref_len: int = 1000,
    n_reads: int = 8,
    read_len: int | None = None,
    basecall_error: float = 0.1,
    draft_error: float = 0.0,
    ref_name: str = "synthref",
    **level_kw,
):
    """Write a complete synthetic run: <outdir>/ref.fasta (draft reference),
    reads/read_NNN.fast5 (template+complement strands + 2D basecall +
    alignment table), and reads.bam (2D basecalls aligned to the reference).

    Returns (truth, draft, fast5_dir, bam_path, fasta_path)."""
    import os

    from .core.sequence import revcomp, seq_to_states
    from .io.bam import write_bam
    from .io.fast5 import write_fast5
    from .io.fasta import write_fasta

    os.makedirs(outdir, exist_ok=True)
    reads_dir = os.path.join(outdir, "reads")
    os.makedirs(reads_dir, exist_ok=True)

    truth = random_seq(rng, ref_len)
    draft = mutate_seq(rng, truth, draft_error) if draft_error > 0 else truth
    fasta_path = os.path.join(outdir, "ref.fasta")
    write_fasta(fasta_path, {ref_name: draft})

    read_len = read_len or ref_len
    bam_records = []
    for i in range(n_reads):
        if read_len >= ref_len:
            s, e = 0, ref_len
        else:
            s = int(rng.integers(0, ref_len - read_len + 1))
            e = s + read_len
        sub = truth[s:e]
        L = len(sub)
        seq2d, srcs = mutate_seq_with_map(rng, sub, basecall_error)

        strands = {}
        align_rows = {}  # q -> [t_idx, c_idx]
        # template strand over the forward span
        mt = make_model(np.random.default_rng(rng.integers(1 << 31)))
        mean_t, stdv_t, al_t = simulate_levels(rng, sub, mt, **level_kw)
        # complement strand over the reverse complement (stored raw)
        mc = make_model(np.random.default_rng(rng.integers(1 << 31)),
                        complement=True)
        mean_c, stdv_c, al_c = simulate_levels(rng, revcomp(sub), mc, **level_kw)

        # 2D-alignment rows: sample aligned levels, map truth 5-mer ->
        # 2D-sequence position via the source map
        src_to_q = {}
        for q, p in enumerate(srcs):
            if p >= 0 and p not in src_to_q:
                src_to_q[int(p)] = q
        rows = {}
        for j in range(0, len(al_t), 3):
            p = int(al_t[j])
            if p <= 0:
                continue
            q = src_to_q.get(p - 1)
            if q is None or q + 5 > len(seq2d):
                continue
            rows.setdefault(q, [-1, -1])[0] = j
        for j in range(0, len(al_c), 3):
            k = int(al_c[j])  # 1-based revcomp 5-mer start
            if k <= 0:
                continue
            p0 = L - (k - 1) - 5  # forward 0-based 5-mer start
            if p0 < 0:
                continue
            q = src_to_q.get(p0)
            if q is None or q + 5 > len(seq2d):
                continue
            rows.setdefault(q, [-1, -1])[1] = j
        qs = sorted(rows)
        align_inds_t = [rows[q][0] for q in qs]
        align_inds_c = [rows[q][1] for q in qs]
        kmers = [seq2d[q : q + 5] for q in qs]

        name = "read_{:03d}.fast5".format(i)
        write_fast5(
            os.path.join(reads_dir, name),
            seq2d,
            {
                "template": dict(
                    mean=mean_t, stdv=stdv_t,
                    level_mean=mt.level_mean, level_stdv=mt.level_stdv,
                    sd_mean=mt.sd_mean, sd_stdv=mt.sd_stdv,
                    align_inds=align_inds_t, align_kmers=kmers,
                ),
                "complement": dict(
                    mean=mean_c, stdv=stdv_c,
                    level_mean=mc.level_mean, level_stdv=mc.level_stdv,
                    sd_mean=mc.sd_mean, sd_stdv=mc.sd_stdv,
                    align_inds=align_inds_c, align_kmers=kmers,
                ),
            },
        )
        cigar, pos = _cigar_from_map(srcs)
        bam_records.append(dict(
            query_name=name, flag=0, ref_id=0, pos=pos + s, mapq=60,
            cigar=cigar, seq=seq2d,
        ))

    bam_path = os.path.join(outdir, "reads.bam")
    write_bam(bam_path, [(ref_name, len(draft))], bam_records)
    return truth, draft, reads_dir, bam_path, fasta_path
