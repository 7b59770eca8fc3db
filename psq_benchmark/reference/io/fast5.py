"""fast5 (HDF5) event loading — PSEvent-equivalent — plus a writer used by
the synthetic-data pipeline and tests.

Layout and semantics follow the reference loader
(PoreSeq's poreseq/EventData.py:100-224): ONT Basecall_2D_000 groups,
per-strand calibration (shift/scale/drift/var), the 2D-alignment kmer-search
seeding, and complement-model flipping.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.events import Event, Model

_GRP = "/Analyses/Basecall_2D_000"


def load_event(filename: str, typ: str) -> Event:
    """Load one strand ('t' or 'c') of a read (EventData.py:100-175)."""
    from . import npz_h5 as h5py

    loc = "complement" if typ[0] == "c" else "template"
    with h5py.File(filename, "r") as f:
        evdata = f[f"{_GRP}/BaseCalled_{loc}/Events"]
        modeldata = f[f"{_GRP}/BaseCalled_{loc}/Model"]
        attdata = f[f"{_GRP}/Summary/basecall_1d_{loc}"].attrs

        seqdata = f[f"{_GRP}/BaseCalled_2D/Fastq"][()]
        if isinstance(seqdata, bytes):
            seqdata = seqdata.decode()
        sequence = seqdata.split("\n")[1]

        aldata = f[f"{_GRP}/BaseCalled_2D/Alignment"]
        alinds = np.asarray(aldata[loc])
        kmers = [k.decode() if isinstance(k, bytes) else k for k in aldata["kmer"]]

        # rebuild the 2D-alignment seed by kmer search (EventData.py:132-138)
        seqinds = np.zeros_like(alinds)
        curind = 0
        for i in range(len(alinds)):
            curind = sequence.find(kmers[i], curind)
            seqinds[i] = curind

        shift = attdata["shift"]
        scale = attdata["scale"]
        scalesd = attdata["scale_sd"]
        drift = attdata["drift"]
        var = attdata["var"]
        varsd = attdata["var_sd"]

        mean = np.asarray(evdata["mean"], dtype=np.float64)
        stdv = np.asarray(evdata["stdv"], dtype=np.float64)
        length = np.asarray(evdata["length"], dtype=np.float64)
        start = np.asarray(evdata["start"], dtype=np.float64)
        mean = mean - drift * (start - start[0])

        ref_align = np.zeros_like(mean)
        lvlinds = alinds > 0
        ref_align[alinds[lvlinds]] = seqinds[lvlinds]

        model = Model(
            level_mean=np.asarray(modeldata["level_mean"], dtype=np.float64)
            * scale + shift,
            level_stdv=np.asarray(modeldata["level_stdv"], dtype=np.float64) * var,
            sd_mean=np.asarray(modeldata["sd_mean"], dtype=np.float64) * scalesd,
            sd_stdv=np.asarray(modeldata["sd_stdv"], dtype=np.float64)
            / np.sqrt(varsd),
            name=str(attdata.get("model_file", "")),
            complement=(loc == "complement"),
        )

        ev = Event(
            mean=mean, stdv=stdv, length=length, start=start,
            ref_align=ref_align, ref_like=np.zeros_like(mean),
            model=model, sequence=sequence,
        )
        # complement events are flipped to point with the template
        # (leaves .flipped True, as in EventData.py:174-175)
        if model.complement:
            ev.flip(False)
        return ev


_EVENT_CACHE: dict = {}


def load_event_cached(filename: str, typ: str) -> Event:
    """load_event through a process-level cache: reads spanning several
    regions of a --region-batch run parse their fast5 once.  Returns a
    light copy (fresh ref_align/ref_like and model scalars) since callers
    flip/remap/setparams the loaded event per region."""
    st = os.stat(filename)
    key = (os.path.abspath(filename), typ, st.st_mtime_ns, st.st_size)
    ev = _EVENT_CACHE.get(key)
    if ev is None:
        if len(_EVENT_CACHE) >= 256:
            _EVENT_CACHE.clear()
        ev = load_event(filename, typ)
        _EVENT_CACHE[key] = ev
    return ev.light_copy()


def load_events(filenames: list[str]) -> list[Event]:
    """Both strands of each file, skipping failures (EventData.py:30-43)."""
    events = []
    for fn in filenames:
        for typ in ("t", "c"):
            try:
                events.append(load_event(fn, typ))
            except Exception:
                pass
    return events


def get_fasta(filename: str) -> str:
    """2D basecall from one fast5 (extract_fasta.py:7-17)."""
    from . import npz_h5 as h5py

    with h5py.File(filename, "r") as f:
        seqdata = f[f"{_GRP}/BaseCalled_2D/Fastq"][()]
        if isinstance(seqdata, bytes):
            seqdata = seqdata.decode()
        return seqdata.split("\n")[1]


def write_fast5(
    filename: str,
    sequence_2d: str,
    strands: dict,
):
    """Write a minimal Basecall_2D_000 fast5 for tests/synthetic data.

    strands: {'template'|'complement': dict(mean, stdv, start, length,
    level_mean, level_stdv, sd_mean, sd_stdv, align_inds, align_kmers)}.
    Calibration attrs are written as identity (shift 0, scale 1, ...) since
    the synthetic levels are already in model space."""
    from . import npz_h5 as h5py

    with h5py.File(filename, "w") as f:
        g2d = f.create_group(f"{_GRP}/BaseCalled_2D")
        fq = "@synthetic\n{}\n+\n{}\n".format(sequence_2d, "!" * len(sequence_2d))
        g2d.create_dataset("Fastq", data=fq.encode())

        n_al = 0
        for s in strands.values():
            n_al = max(n_al, len(s.get("align_inds", [])))
        al_dtype = np.dtype(
            [("template", "<i8"), ("complement", "<i8"), ("kmer", "S5")]
        )
        al = np.zeros(n_al, dtype=al_dtype)
        al["template"] = -1
        al["complement"] = -1
        for loc, s in strands.items():
            inds = s.get("align_inds", [])
            al[loc][: len(inds)] = inds
            km = s.get("align_kmers", [])
            al["kmer"][: len(km)] = [k.encode() for k in km]
        g2d.create_dataset("Alignment", data=al)

        for loc, s in strands.items():
            g = f.create_group(f"{_GRP}/BaseCalled_{loc}")
            n = len(s["mean"])
            ev = np.zeros(
                n,
                dtype=np.dtype(
                    [("mean", "<f8"), ("stdv", "<f8"), ("start", "<f8"),
                     ("length", "<f8")]
                ),
            )
            ev["mean"] = s["mean"]
            ev["stdv"] = s["stdv"]
            ev["start"] = s.get("start", np.arange(n, dtype=np.float64))
            ev["length"] = s.get("length", np.ones(n))
            g.create_dataset("Events", data=ev)
            mt = np.zeros(
                1024,
                dtype=np.dtype(
                    [("level_mean", "<f8"), ("level_stdv", "<f8"),
                     ("sd_mean", "<f8"), ("sd_stdv", "<f8")]
                ),
            )
            mt["level_mean"] = s["level_mean"]
            mt["level_stdv"] = s["level_stdv"]
            mt["sd_mean"] = s["sd_mean"]
            mt["sd_stdv"] = s["sd_stdv"]
            g.create_dataset("Model", data=mt)
            att = f.create_group(f"{_GRP}/Summary/basecall_1d_{loc}")
            att.attrs["shift"] = 0.0
            att.attrs["scale"] = 1.0
            att.attrs["scale_sd"] = 1.0
            att.attrs["drift"] = 0.0
            att.attrs["var"] = 1.0
            att.attrs["var_sd"] = 1.0
            att.attrs["model_file"] = "synthetic"
