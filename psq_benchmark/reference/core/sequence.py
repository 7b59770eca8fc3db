"""DNA sequence <-> 5-mer state encoding, mutations, and complement tables.

Re-implements the observable behavior of the reference's Sequence struct
(PoreSeq's cpp/Sequence.h:21-101) and the model flip bit-trick
(PoreSeq's poreseq/EventData.py:204-207), designed TPU-first: sequences
are numpy uint8 code arrays convertible to JAX, states are int32 vectors.

Conventions (match reference):
  * ``states[k]`` is the 5-mer state of bases ``[k, k+4]``;
    ``len(states) == len(bases) - 4`` (Sequence.h:26-27).
  * state bit layout: base at offset 0 (leftmost) occupies the two most
    significant bits: state = sum(code[k+j] << (2*(4-j))).
  * Non-ACGT characters reproduce the reference's quirky behavior
    (Sequence.h:84-99): only the state whose window *starts* 4 bases after an
    invalid char is marked -1 (with the running state reset to 0); states whose
    windows merely overlap the invalid char are computed from the masked
    running-state arithmetic using the raw character value.
"""

from __future__ import annotations

import numpy as np

N_STATES = 1024

# ASCII -> base code lookup (A,C,G,T -> 0..3; everything else keeps its ASCII
# value, exactly like the reference's std::replace approach, Sequence.h:72-76).
_CODE_LUT = np.arange(256, dtype=np.int64)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i

_BASES = "ACGT"

# powers of 4 for the fast (pure-ACGT) state path, MSB-first
_POW4 = np.array([256, 64, 16, 4, 1], dtype=np.int64)


def seq_to_codes(seq: str) -> np.ndarray:
    """Return int64 array of per-character codes (A,C,G,T -> 0..3)."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _CODE_LUT[raw]


def codes_to_seq(codes: np.ndarray) -> str:
    return "".join(_BASES[c] for c in codes)


def seq_to_states(seq: str) -> np.ndarray:
    """Convert a base string to its int32 5-mer state vector.

    Matches Sequence::populateStates (Sequence.h:65-100) bit for bit,
    including the invalid-character quirks described in the module docstring.
    Returns an empty array for sequences shorter than 5 bases.
    """
    n = len(seq)
    if n < 5:
        return np.zeros(0, dtype=np.int32)
    codes = seq_to_codes(seq)
    if codes.max() < 4:
        # fast vectorized path (pure ACGT): sliding-window dot with powers of 4
        win = np.lib.stride_tricks.sliding_window_view(codes, 5)
        return (win @ _POW4).astype(np.int32)
    return _seq_to_states_slow(codes)


def _seq_to_states_slow(codes: np.ndarray) -> np.ndarray:
    """Reference-faithful stateful path for sequences with non-ACGT chars."""
    n = len(codes)
    states = np.empty(n - 4, dtype=np.int32)
    curstate = 0
    for i in range(4):
        curstate = (curstate << 2) + int(codes[i])
    for i in range(4, n):
        if codes[i - 4] < 4:
            curstate = (N_STATES - 1) & ((curstate << 2) + int(codes[i]))
            states[i - 4] = curstate
        else:
            curstate = 0
            states[i - 4] = -1
    return states


def apply_mutation(bases: str, start: int, orig: str, mut: str) -> str:
    """Apply one substring mutation, matching the reference's mutation
    constructor (Sequence.h:38-59): past-the-end starts are no-ops."""
    if start >= len(bases):
        return bases
    remind = start + len(orig)
    tail = bases[remind:] if remind < len(bases) else ""
    return bases[:start] + mut + tail


def revcomp(seq: str) -> str:
    """Reverse complement of an ACGT string (Bio.Seq equivalent)."""
    comp = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
    return seq.translate(comp)[::-1]


def flip_state_table() -> np.ndarray:
    """1024-entry permutation mapping each 5-mer state to its reverse
    complement, via the bit trick in the reference loader
    (PoreSeq's poreseq/EventData.py:204-207)."""
    flips = 1023 - np.arange(1024)
    flips = (
        ((flips & 0b11) << 8)
        | ((flips >> 8) & 0b11)
        | ((flips & 0b1100) << 4)
        | ((flips >> 4) & 0b1100)
        | (flips & 0b110000)
    )
    return flips


def complement_state(state: int) -> int:
    """Reverse-complement one 5-mer state (cpp/Viterbi.h:41-53)."""
    comp = 0
    for _ in range(5):
        comp = (comp << 2) + ((state & 3) ^ 3)
        state >>= 2
    return comp


def prev_state(state: int, ind: int, nsteps: int = 1) -> int:
    """Predecessor state after nsteps base advances (cpp/Viterbi.h:23-29)."""
    return (state >> (2 * nsteps)) + (ind << (10 - 2 * nsteps))


def next_state(state: int, ind: int, nsteps: int = 1) -> int:
    """Successor state after nsteps base advances (cpp/Viterbi.h:25-31)."""
    return ((state << (2 * nsteps)) & (N_STATES - 1)) + ind


def state_base(state: int, ind: int) -> str:
    """Base at position ind (0 leftmost .. 4 rightmost) of a 5-mer state
    (cpp/Viterbi.h:34-38)."""
    return _BASES[3 & (state >> (2 * (4 - ind)))]
