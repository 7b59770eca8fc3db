"""Pure-Python BAM reader/writer (pysam is not available in this image).

Implements the subset of pysam the reference loader uses
(PoreSeq's poreseq/LoadData.py:81-137): AlignmentFile(fetch),
references, record.query_name / is_reverse / cigar / get_aligned_pairs /
get_overlap.  Files are BGZF (multi-member gzip) per the SAM/BAM spec.

Pod-feeding behavior (many regions per process, multi-kb reads):
  * AlignmentFile.cached(path) keeps the parsed file across region loads —
    a --region-batch run decompresses and parses the BAM once, not once per
    region;
  * sequences decode lazily (numpy nibble unpack) — records rejected by the
    overlap filter never pay for their seq;
  * fetch() filters with vectorized pos/end arrays instead of per-record
    Python; aligned_pairs_matched() returns the (q, r) matched pairs as one
    int64 array (the per-base tuple list of get_aligned_pairs is kept only
    for pysam API compatibility).

The writer emits spec-compliant BGZF BAM for the synthetic-data pipeline and
round-trip tests.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np

# cigar op codes: MIDNSHP=X
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
_QUERY_OPS = {CMATCH, CINS, CSOFT_CLIP, CEQUAL, CDIFF}
_REF_OPS = {CMATCH, CDEL, CREF_SKIP, CEQUAL, CDIFF}
_ALIGNED_OPS = {CMATCH, CEQUAL, CDIFF}

_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_SEQ_LOOKUP = {c: i for i, c in enumerate(_SEQ_CODES)}
_SEQ_TRANS = bytes.maketrans(bytes(range(16)), _SEQ_CODES.encode())


class BamRecord:
    __slots__ = (
        "query_name", "flag", "ref_id", "pos", "mapq", "cigar", "qual",
        "reference_name", "_seq", "_seqsrc",
    )

    def __init__(self):
        self.query_name = ""
        self.flag = 0
        self.ref_id = -1
        self.pos = -1
        self.mapq = 0
        self.cigar = []  # list of (op, length)
        self.qual = b""
        self.reference_name = None
        self._seq = None
        self._seqsrc = None   # (data, offset, l_seq) for lazy decode

    @property
    def seq(self) -> str:
        if self._seq is None:
            if self._seqsrc is None:
                return ""
            data, p, l_seq = self._seqsrc
            nb = (l_seq + 1) // 2
            packed = np.frombuffer(data[p : p + nb], dtype=np.uint8)
            codes = np.empty(2 * nb, dtype=np.uint8)
            codes[0::2] = packed >> 4
            codes[1::2] = packed & 0xF
            self._seq = codes[:l_seq].tobytes().translate(_SEQ_TRANS).decode(
                "latin-1")
        return self._seq

    @seq.setter
    def seq(self, value: str):
        self._seq = value

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4)

    def reference_end(self) -> int:
        return self.pos + sum(l for op, l in self.cigar if op in _REF_OPS)

    def aligned_pairs_matched(self) -> np.ndarray:
        """Matched (query, ref) index pairs — the M/=/X columns of
        get_aligned_pairs — as one [n, 2] int64 array."""
        chunks = []
        q = 0
        r = self.pos
        for op, ln in self.cigar:
            if op in _ALIGNED_OPS:
                i = np.arange(ln, dtype=np.int64)
                chunks.append(np.stack([q + i, r + i], axis=1))
                q += ln
                r += ln
            elif op in (CINS, CSOFT_CLIP):
                q += ln
            elif op in (CDEL, CREF_SKIP):
                r += ln
        if not chunks:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(chunks, axis=0)

    def get_aligned_pairs(self):
        """pysam-compatible (qpos, rpos) pairs including gaps as None."""
        pairs = []
        q = 0
        r = self.pos
        for op, ln in self.cigar:
            if op in _ALIGNED_OPS:
                for _ in range(ln):
                    pairs.append((q, r))
                    q += 1
                    r += 1
            elif op in (CINS, CSOFT_CLIP):
                for _ in range(ln):
                    pairs.append((q, None))
                    q += 1
            elif op in (CDEL, CREF_SKIP):
                for _ in range(ln):
                    pairs.append((None, r))
                    r += 1
            # H/P consume nothing
        return pairs

    def get_overlap(self, start: int, end: int) -> int:
        """Number of aligned (M/=/X) bases overlapping [start, end)."""
        n = 0
        r = self.pos
        for op, ln in self.cigar:
            if op in _ALIGNED_OPS:
                lo = max(r, start)
                hi = min(r + ln, end)
                if hi > lo:
                    n += hi - lo
                r += ln
            elif op in _REF_OPS:
                r += ln
        return n


_FILE_CACHE: dict = {}


class AlignmentFile:
    """Read-only BAM file; fetch filters with vectorized pos/end arrays."""

    def __init__(self, path: str, mode: str = "rb"):
        raw = open(path, "rb").read()
        data = gzip.decompress(raw)  # BGZF = concatenated gzip members
        if data[:4] != b"BAM\x01":
            raise ValueError("not a BAM file")
        off = 4
        (l_text,) = struct.unpack_from("<i", data, off)
        off += 4 + l_text
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.references = []
        self.lengths = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", data, off)
            off += 4
            name = data[off : off + l_name - 1].decode()
            off += l_name
            (l_ref,) = struct.unpack_from("<i", data, off)
            off += 4
            self.references.append(name)
            self.lengths.append(l_ref)
        self.nreferences = n_ref
        self._records = []
        n = len(data)
        while off < n:
            (block_size,) = struct.unpack_from("<i", data, off)
            off += 4
            rec = self._parse(data, off)
            self._records.append(rec)
            off += block_size
        # vectorized fetch support
        self._pos = np.array([r.pos for r in self._records], dtype=np.int64)
        self._end = np.array([r.reference_end() for r in self._records],
                             dtype=np.int64)
        self._rid = np.array([r.ref_id for r in self._records],
                             dtype=np.int64)
        self._mapped = np.array([not r.is_unmapped for r in self._records])

    @classmethod
    def cached(cls, path: str) -> "AlignmentFile":
        """Parsed-file cache keyed by (path, mtime, size): region-batch runs
        decompress + parse the BAM once per file, not once per region."""
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
        hit = _FILE_CACHE.get(key)
        if hit is None:
            _FILE_CACHE.clear()   # one big parsed BAM at a time
            hit = cls(path)
            _FILE_CACHE[key] = hit
        return hit

    def _parse(self, data: bytes, off: int) -> BamRecord:
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, _nr, _np,
         _tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        rec = BamRecord()
        rec.ref_id = ref_id
        rec.pos = pos
        rec.mapq = mapq
        rec.flag = flag
        p = off + 32
        rec.query_name = data[p : p + l_rn - 1].decode()
        p += l_rn
        cig = struct.unpack_from("<%dI" % n_cig, data, p)
        rec.cigar = [(c & 0xF, c >> 4) for c in cig]
        p += 4 * n_cig
        nb = (l_seq + 1) // 2
        rec._seqsrc = (data, p, l_seq)   # lazy decode on .seq access
        p += nb
        rec.qual = data[p : p + l_seq]
        if 0 <= ref_id < len(self.references):
            rec.reference_name = self.references[ref_id]
        return rec

    def fetch(self, reference=None, start=None, end=None):
        keep = self._mapped.copy()
        if reference is not None:
            try:
                rid = self.references.index(reference)
            except ValueError:
                rid = -2
            keep &= self._rid == rid
        if start is not None:
            keep &= self._end > start
        if end is not None:
            keep &= self._pos < end
        for i in np.nonzero(keep)[0]:
            yield self._records[i]

    def close(self):
        pass


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25 + 1
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<HH", 2, bsize - 1)
    )
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + cdata + footer


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def write_bam(path: str, references: list[tuple[str, int]], records: list[dict]):
    """Write a BAM file.  Each record dict: query_name, flag, ref_id, pos,
    mapq, cigar [(op,len)], seq (str)."""
    body = b"BAM\x01"
    text = b""
    body += struct.pack("<i", len(text)) + text
    body += struct.pack("<i", len(references))
    for name, ln in references:
        nb = name.encode() + b"\x00"
        body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)

    for r in records:
        name = r["query_name"].encode() + b"\x00"
        cig = b"".join(
            struct.pack("<I", (ln << 4) | op) for op, ln in r["cigar"]
        )
        seq = r.get("seq", "")
        l_seq = len(seq)
        sb = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(seq):
            code = _SEQ_LOOKUP.get(c, 15)
            if i % 2 == 0:
                sb[i // 2] |= code << 4
            else:
                sb[i // 2] |= code
        qual = b"\xff" * l_seq
        rec = struct.pack(
            "<iiBBHHHiiii",
            r["ref_id"], r["pos"], len(name), r.get("mapq", 60),
            0, len(r["cigar"]), r.get("flag", 0), l_seq, -1, -1, 0,
        ) + name + cig + bytes(sb) + qual
        body += struct.pack("<i", len(rec)) + rec

    with open(path, "wb") as f:
        # split into <=60KB BGZF blocks
        for i in range(0, len(body), 60000):
            f.write(_bgzf_block(body[i : i + 60000]))
        f.write(_BGZF_EOF)
