"""f32 whole-pipeline DECISION equivalence on the port: TorchEngine in
float32 (the dtype every card run uses) must reproduce the port's exact
engine's consensus sequence at every phase of the pipeline when both see
the same candidate proposals.  The twin of tests/test_f32_e2e.py (same
cases, widths and rule), on the port's own engines.

Both engines get the exact engine's Viterbi candidates (libc rand(),
seeded per case): candidates only seed proposals, and TorchEngine's own
draws come from a counter hash.  The decisions compared are phase 1
('self' 2D-read candidates), a shared-candidate Mutate round and Refine
(all 9 point mutations per base).  A divergence must be bounded
(equal-accuracy consensus) and is reported as xfail, so its rate is
visible; chip_smoke.py phase 8 runs the same protocol on the card at
production widths."""

import numpy as np
import pytest
import torch

from poreseq_tpu_torch.api import swalign
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.engine import _native
from poreseq_tpu_torch.engine.types import AlignData
from poreseq_tpu_torch.sim import simulate_session

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

PARAMS = dict(realign_width=48, scoring_width=24, point_width=12, verbose=0)

CASES = [
    (101, 200, 6, 0.03),
    (202, 260, 8, 0.05),
    (303, 320, 6, 0.02),
    (404, 200, 10, 0.04),
    (505, 240, 4, 0.03),
    (606, 280, 8, 0.06),
    (707, 220, 6, 0.00),
    (808, 300, 6, 0.04),
    (909, 180, 12, 0.05),
    (111, 260, 6, 0.03),
]


@pytest.mark.slow
@pytest.mark.parametrize("seed,ref_len,coverage,draft_error", CASES)
def test_f32_consensus_decisions_match_exact(seed, ref_len, coverage,
                                             draft_error):
    def mk(**engine):
        return simulate_session(
            np.random.default_rng(seed), ref_len=ref_len, coverage=coverage,
            draft_error=draft_error, params=dict(PARAMS), **engine)

    pT, truth = mk(engine=TorchEngine("cpu", torch.float32))
    pE, _ = mk(backend="exact")

    def check(phase):
        if pT.sequence != pE.sequence:
            aT = swalign(pT.sequence, truth)[0]
            aE = swalign(pE.sequence, truth)[0]
            assert abs(aT - aE) < 0.5 and aT >= 99.0, (
                f"f32 diverged AND degraded at {phase}: "
                f"torch {aT:.2f}% vs exact {aE:.2f}%")
            pytest.xfail(f"bounded f32 divergence at {phase} "
                         f"(torch {aT:.2f}% / exact {aE:.2f}% vs truth)")

    pT.Mutate(reps=2)
    pE.Mutate(reps=2)
    check("phase1-self")

    # shared candidates: generated ONCE by the exact engine from the (equal)
    # post-phase-1 state, fed to both engines
    _native.srand(seed)
    cands = pE.engine.viterbi_mutate(
        AlignData.from_session(pE).events, 16, 0.05, 0.01, 0.33, 0.75)
    pT.Mutate(seqs=list(cands), reps=2)
    pE.Mutate(seqs=list(cands), reps=2)
    check("viterbi-candidates")

    pT.Refine()
    pE.Refine()
    check("refine")
