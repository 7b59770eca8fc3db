"""Minimal FASTA reading/writing (Biopython is not available here).

Provides the subset of behavior the reference uses via SeqIO.index:
ordered name -> sequence mapping, single-reference convenience lookup.
"""

from __future__ import annotations


def read_fasta(path: str) -> dict[str, str]:
    """Ordered {header-first-token: sequence} from a FASTA file."""
    seqs: dict[str, str] = {}
    name = None
    parts: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(parts)
                name = line[1:].split()[0] if len(line) > 1 else ""
                parts = []
            elif name is not None:
                parts.append(line.strip())
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs


def write_fasta(path: str, seqs: dict[str, str]) -> None:
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(">{}\n{}\n".format(name, seq))


def load_reference(fastafile: str, refname: str | None = None) -> str:
    """LoadReference semantics (PoreSeq's poreseq/LoadData.py:54-65):
    single-sequence files may omit the name; multi-sequence files require
    one."""
    refs = read_fasta(fastafile)
    if refname is None:
        if len(refs) == 1:
            refname = next(iter(refs))
        else:
            raise Exception("Multiple references in fasta, must specify one")
    return refs[refname]
