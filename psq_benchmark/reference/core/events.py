"""Host-side event (squiggle read) and model data structures.

Re-implements the observable semantics of the reference's Python-side
PSEvent/PSModel (PoreSeq's poreseq/EventData.py) and the C++ EventData
helpers updaterefs/getrefstate/getrefstates (PoreSeq's cpp/EventData.h:
110-204), as numpy-first dataclasses that convert cleanly into padded JAX
pytrees for the TPU engine.

ref_align conventions (EventData.h:92-99):
   0  -> before first / after last aligned position
  -1  -> inserted level between aligned bases
  k>0 -> 1-based index of the aligned reference base
ref_index is the monotone, linearly-interpolated version of ref_align used
for band placement, regenerated by :func:`update_refs`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .sequence import flip_state_table, revcomp

_FLIPS = flip_state_table()


@dataclass
class Model:
    """Per-strand 1024-entry 5-mer model (EventData.py:46-75)."""

    level_mean: np.ndarray = field(default_factory=lambda: np.zeros(1024))
    level_stdv: np.ndarray = field(default_factory=lambda: np.ones(1024))
    sd_mean: np.ndarray = field(default_factory=lambda: np.ones(1024))
    sd_stdv: np.ndarray = field(default_factory=lambda: np.ones(1024))
    prob_skip: float = 0.1
    prob_stay: float = 0.1
    prob_extend: float = 0.1
    prob_insert: float = 0.01
    name: str = ""
    complement: bool = False

    def derived(self) -> dict:
        """Precomputed tables matching ModelData::setData / setParams
        (cpp/EventData.h:48-73): log_lev, inverse-Gaussian lambda and its log,
        and the log-space skip/stay/extend/insert likelihoods."""
        sd_lambda = self.sd_mean**3 / self.sd_stdv**2
        return {
            "log_lev": np.log(self.level_stdv),
            "sd_lambda": sd_lambda,
            "log_lambda": np.log(sd_lambda),
            "lik_skip": float(np.log(self.prob_skip)),
            "lik_stay": float(np.log(self.prob_stay)),
            "lik_extend": float(np.log(self.prob_extend)),
            "lik_insert": float(np.log(self.prob_insert)),
        }

    def flip(self) -> None:
        """Map each state's entries to its reverse complement via the
        bit-shuffle table (EventData.py:204-213)."""
        self.level_mean = self.level_mean[_FLIPS]
        self.level_stdv = self.level_stdv[_FLIPS]
        self.sd_mean = self.sd_mean[_FLIPS]
        self.sd_stdv = self.sd_stdv[_FLIPS]


@dataclass
class Event:
    """One strand (template or complement) of one read (EventData.py:77-312)."""

    mean: np.ndarray
    stdv: np.ndarray
    length: np.ndarray
    start: np.ndarray
    ref_align: np.ndarray
    ref_like: np.ndarray
    model: Model
    sequence: str = ""
    flipped: bool = False
    #: optional (lo, hi) level-range hint: only levels [lo, hi) can fall in
    #: any band of this event's region (computed at load from the BAM seed
    #: alignment + realign width + slack) — the TPU pack slices event arrays
    #: to it, cutting the batch time axis for reads overhanging short
    #: regions; unreachable levels are exact-equivalent (they stay unaligned)
    trim: tuple | None = None

    def __post_init__(self):
        for name in ("mean", "stdv", "length", "start", "ref_align", "ref_like"):
            setattr(self, name, np.ascontiguousarray(getattr(self, name), dtype=np.float64))

    def copy(self) -> "Event":
        import copy as _copy

        return _copy.deepcopy(self)

    def light_copy(self) -> "Event":
        """Copy owning fresh ref_align/ref_like but SHARING the immutable
        payload (mean/stdv/length/start and the model tables).

        The engines mirror the reference's copying FFI boundary (pyx:99-137)
        only for the arrays they actually write back: ref_align/ref_like are
        updated in place (NativeAligner.pull_into, AlignData.sync_back), while
        every other field is read-only inside engine calls (flip()/mapaligns()
        reassign rather than mutate, and setparams() only rebinds scalar model
        probabilities on the copied Model object) — so sharing them keeps the
        semantics while avoiding ~40 kB x 4 model-table copies per event per
        round."""
        import copy as _copy

        new = _copy.copy(self)
        new.ref_align = self.ref_align.copy()
        new.ref_like = self.ref_like.copy()
        new.model = _copy.copy(self.model)
        return new

    def flip(self, flip_sequence: bool = True) -> None:
        """In-place reverse the event and flip its model to the reverse
        complement read (EventData.py:182-224)."""
        self.mean = self.mean[::-1].copy()
        self.stdv = self.stdv[::-1].copy()
        self.length = self.length[::-1].copy()
        self.start = self.start[::-1].copy()
        self.ref_align = self.ref_align[::-1].copy()
        self.ref_like = self.ref_like[::-1].copy()
        self.model.flip()
        if flip_sequence:
            self.sequence = revcomp(self.sequence)
            ra0 = self.ref_align > 0
            self.ref_align[ra0] = len(self.sequence) - self.ref_align[ra0]
        self.flipped = not self.flipped

    def mapaligns(self, pairs: np.ndarray) -> None:
        """Remap ref_align through aligned index pairs by interpolation
        (EventData.py:226-256).  Clears everything (including -1 inserts) and
        rewrites only the previously-aligned levels."""
        pairs = np.asarray(pairs, dtype=np.float64)
        refal = self.ref_align
        ra0 = refal > 0
        self.ref_align = np.zeros_like(self.ref_align)
        _, uinds = np.unique(pairs[:, 0], return_index=True)
        pairs = pairs[uinds, :]
        self.ref_align[ra0] = np.round(
            np.interp(refal[ra0], pairs[:, 0], pairs[:, 1], 0, 0)
        )

    def getrefstats(self) -> tuple[float, float, float]:
        """Fractions of levels that are skips, stays, inserts
        (EventData.py:264-286)."""
        bins = np.bincount(np.int64(self.ref_align[self.ref_align >= 0]))
        skips = np.sum(bins[1:] == 0)
        stays = np.sum(np.maximum(0, bins[1:] - 1))
        inserts = np.sum(self.ref_align < 0)
        total = float(np.sum(self.ref_align != 0))
        return (skips / total, stays / total, inserts / total)

    def setparams(self, params: dict) -> None:
        """Copy strand-suffixed ``*_t`` / ``*_c`` probabilities into the model
        (EventData.py:288-312)."""
        for k in params:
            paramname = "prob_" + k[:-2]
            if not hasattr(self.model, paramname):
                continue
            if (k[-2:] == "_t" and not self.model.complement) or (
                k[-2:] == "_c" and self.model.complement
            ):
                setattr(self.model, paramname, params[k])


def update_refs(ref_align: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Rebuild the monotone interpolated ref_index from ref_align.

    Bitwise-faithful vectorization of EventData::updaterefs
    (cpp/EventData.h:110-169): anchors are levels with ref_align > 0; interior
    gaps use consecutive-anchor slopes ``m*(j-a) + ref_align[a]``; the flanks
    use the global first-to-last-anchor line ``al_m*i + al_b``.

    Returns (ref_index, refstart, refend); ref_index is empty and
    refstart = refend = -1 when nothing is aligned.
    """
    n = len(ref_align)
    anchors = np.nonzero(ref_align > 0)[0]
    if len(anchors) == 0:
        return np.zeros(0, dtype=np.float64), -1, -1

    ra0 = int(anchors[0])
    ra1 = int(anchors[-1])
    refstart = int(ref_align[ra0])
    refend = int(ref_align[ra1])

    ref_index = ref_align.astype(np.float64).copy()
    idx = np.arange(n, dtype=np.float64)

    # flanks: global extrapolation line (EventData.h:142-152)
    with np.errstate(divide="ignore", invalid="ignore"):
        al_m = (ref_align[ra1] - ref_align[ra0]) / float(ra1 - ra0)
    al_b = ref_align[ra0] - al_m * ra0
    flank = (np.arange(n) < ra0) | (np.arange(n) > ra1)
    ref_index[flank] = al_m * idx[flank] + al_b

    # interior gaps: per-gap slope between consecutive anchors.  NB the
    # reference's ``if (lastal > 0)`` guard (EventData.h:157) means a gap whose
    # left anchor sits at level index 0 is *not* interpolated — it keeps the
    # raw ref_align copy.  Replicated here by dropping left==0 positions.
    if len(anchors) > 1:
        interior = np.nonzero(~flank & ~(ref_align > 0))[0]
        if len(interior) > 0:
            left = anchors[np.searchsorted(anchors, interior, side="right") - 1]
            right = anchors[np.searchsorted(anchors, interior, side="left")]
            keep = left > 0
            interior, left, right = interior[keep], left[keep], right[keep]
            m = (ref_align[right] - ref_align[left]) / (right - left).astype(np.float64)
            ref_index[interior] = m * (interior - left) + ref_align[left]

    return ref_index, refstart, refend


def getrefstate(ref_index: np.ndarray, refind: int) -> int:
    """Index of first ref_index entry >= refind (lower_bound;
    cpp/EventData.h:172-183).  Empty ref_index -> 0."""
    if len(ref_index) == 0:
        return 0
    return int(np.searchsorted(ref_index, refind, side="left"))


def getrefstates(ref_index: np.ndarray, ref_align: np.ndarray, refind: int) -> np.ndarray:
    """All level indices lying within one reference index
    (cpp/EventData.h:187-204): starts at the first *exact* ref_index match,
    then walks forward while ref_align <= refind collecting aligned levels."""
    hits = np.nonzero(ref_index == refind)[0]
    if len(hits) == 0:
        return np.zeros(0, dtype=np.int64)
    i = int(hits[0])
    inds = [i]
    n = len(ref_align)
    i += 1
    while i < n and ref_align[i] <= refind:
        if ref_align[i] > 0:
            inds.append(i)
        i += 1
    return np.asarray(inds, dtype=np.int64)
