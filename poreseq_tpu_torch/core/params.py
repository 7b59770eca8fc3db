"""Parameter configuration: ``key = float`` .conf files and training proposals.

Mirrors PoreSeq's poreseq/Params.py and defaults.conf semantics:
  * ``load_params(None)`` returns an *empty* dict — the engine then falls back
    to the native-core defaults (lik_offset=4.5, scoring_width=150,
    realign_width=300; cpp/AlignUtil.h:57-66), which intentionally differ from
    defaults.conf (scoring_width=100).  This quirk is preserved.
  * Malformed lines are silently skipped (Params.py:12-21).
"""

from __future__ import annotations

import random

# The C++-side defaults that apply when a key is absent from the params dict
# (cpp/AlignUtil.h:57-66 + ModelData defaults via PSModel,
#  PoreSeq's poreseq/EventData.py:65-75).
ALIGN_DEFAULTS = {
    "lik_offset": 4.5,
    "scoring_width": 150,
    "realign_width": 300,
    "verbose": 0,
}

MODEL_PROB_DEFAULTS = {
    "prob_skip": 0.1,
    "prob_stay": 0.1,
    "prob_extend": 0.1,
    "prob_insert": 0.01,
}

# Contents of the reference's defaults.conf (shipped config, not implicit
# defaults) — used by our CLI when the user passes the packaged config.
PACKAGED_DEFAULTS = {
    "realign_width": 300.0,
    "scoring_width": 100.0,
    "point_width": 20.0,
    "min_coverage": 0.0,
    "max_coverage": 30.0,
    "min_overlap": 500.0,
    "max_length": 10000.0,
    "end_trim": 150.0,
    "lik_offset": 4.5,
    "skip_t": 0.141,
    "skip_c": 0.088,
    "stay_t": 0.043,
    "stay_c": 0.057,
    "extend_t": 0.072,
    "extend_c": 0.046,
    "insert_t": 0.020,
    "insert_c": 0.025,
}


def load_params(filename: str | None) -> dict:
    """Load a ``key = float`` .conf file (Params.py:4-23).

    None -> {} (which triggers the native-core default quirk, see module doc).
    Lines that do not parse as a float are skipped silently.
    """
    params: dict = {}
    if filename is None:
        return params
    with open(filename) as f:
        for line in f.readlines():
            sl = line.split("=")
            if len(sl) == 2:
                try:
                    params[sl[0].strip()] = float(sl[1])
                except ValueError:
                    pass
    return params


def save_params(filename: str, params: dict) -> None:
    """Write params back out (Params.py:25-29)."""
    with open(filename, "w") as f:
        for p in params:
            f.write("{} = {}\n".format(p, params[p]))


def vary_params(params: dict, n: int = 16, rng: random.Random | None = None) -> list[dict]:
    """Training proposals: n copies, each with 3 random strand-suffixed keys
    multiplied by gauss(1, 0.15) (Params.py:31-60)."""
    rng = rng or random
    pnames = [k for k in params if k[-2:] in ("_t", "_c")]
    out = []
    for _ in range(n):
        newp = dict(params)
        for k in rng.sample(pnames, 3):
            newp[k] *= rng.gauss(1.0, 0.15)
        out.append(newp)
    return out
