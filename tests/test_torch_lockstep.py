"""Lockstep batches on the port equal their sequential runs (CPU, f64):
the multi-region Mutate/Refine drivers against the single-region driver
loop, and train's candidate batch against mutate() per candidate."""

import numpy as np
import pytest
import torch

from poreseq_tpu import api
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session, write_run
from poreseq_tpu_torch.engine import TorchEngine

# several pytest workers share the machine: one intra-op thread each keeps
# torch's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def torch_backend(monkeypatch):
    """A CPU f64 TorchEngine registered as the JAX package's backend
    "torch" for one test."""
    eng = TorchEngine(device="cpu", dtype=torch.float64)
    monkeypatch.setitem(api._ENGINES, "torch", eng)
    return eng


def test_lockstep_mutate_refine_matches_sequential():
    """mutate_datas/refine_datas (lockstep across two regions) give the
    per-region sequences of the sequential driver loop ('self' candidates,
    deterministic)."""
    from poreseq_tpu.engine import driver
    from poreseq_tpu.engine.multi import mutate_datas, refine_datas

    def make():
        rng = np.random.default_rng(55)
        pas = [simulate_session(rng, ref_len=n, coverage=5,
                                draft_error=0.05)[0] for n in (120, 170)]
        datas = [AlignData.from_session(pa) for pa in pas]
        for d in datas:
            d.params.realign_width = 24
            d.params.scoring_width = 8
        return datas

    REPS = 2
    datas_s = make()
    eng = TorchEngine("cpu", torch.float64)
    for d in datas_s:
        seqs = [x.sequence for x in d.events[::2]]
        for _ in range(REPS):
            muts = driver.find_mutations(eng, d, seqs)
            scores = eng.score_mutations(d, muts)
            if driver.make_mutations(eng, d, scores) == 0:
                break
        d.params.scoring_width = 6
        pmuts = driver.find_point_mutations(d)
        driver.make_mutations(eng, d, eng.score_mutations(d, pmuts))

    datas_m = make()
    eng2 = TorchEngine("cpu", torch.float64)
    mutate_datas(eng2, datas_m, [[x.sequence for x in d.events[::2]]
                                 for d in datas_m], REPS)
    refine_datas(eng2, datas_m, point_width=6)

    assert [d.sequence for d in datas_m] == [d.sequence for d in datas_s]
    assert datas_m[0].sequence != make()[0].sequence


def test_train_candidates_lockstep_matches_sequential(tmp_path, monkeypatch,
                                                      torch_backend):
    """train's lockstep batch of 2 parameter candidates gives each the
    sequence and accuracy of mutate() run on it alone: the Viterbi rounds
    sample each session's candidates as its solo call would.

    mutate() runs its Viterbi Mutate at PSAlign.Mutate's default 4 reps,
    the lockstep schedule at ``reps``; the sequential side is held to the
    lockstep schedule, so that only the batching differs."""
    from poreseq_tpu.pipeline import mutate, train_candidates

    real = api.PSAlign.Mutate
    monkeypatch.setattr(
        api.PSAlign, "Mutate",
        lambda self, seqs="self", reps=4: real(
            self, seqs, 1 if isinstance(seqs, str) and seqs == "viterbi"
            else reps))
    _, _, reads_dir, bam, fasta = write_run(
        str(tmp_path), np.random.default_rng(4), ref_len=120, n_reads=4,
        draft_error=0.0)
    base = dict(realign_width=16, scoring_width=8, point_width=6,
                min_coverage=0, max_coverage=30, min_overlap=50,
                max_length=10000, lik_offset=4.5)
    cands = [dict(base, skip_t=0.1 * f, stay_c=0.05 * f, insert_t=0.03 * f)
             for f in (1.0, 0.6)]
    seq_results = [mutate(fasta, bam, reads_dir, params=p, test=True,
                          reps=1, backend="torch") for p in cands]
    lock_results = train_candidates(fasta, bam, reads_dir, None, cands,
                                    reps=1, backend="torch", verbose=0)
    assert len(lock_results) == 2
    for (seq_s, acc_s), (seq_l, acc_l) in zip(seq_results, lock_results):
        assert seq_l == seq_s
        assert abs(acc_l - acc_s) < 1e-9


def test_wave_rows_budget_leaves_sequences_unchanged(monkeypatch):
    """PSQ_WAVE_ROWS sets TorchEngine's event-row budget a candidate-scoring
    fill, with the JAX engine's default (512): a Viterbi Mutate round on two
    regions ends in the same sequences at a budget of 16 rows
    (a fill for each candidate's events) and of 512 (one fill for all 32
    candidates), and the small budget dispatches more fills."""
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu_torch.engine.multi import mutate_datas
    from poreseq_tpu_torch.engine.types import AlignData as PortData
    from poreseq_tpu_torch.sim import simulate_session as port_session

    monkeypatch.delenv("PSQ_WAVE_ROWS", raising=False)
    assert TorchEngine("cpu").wave_rows == TpuEngine.wave_rows == 512
    out, fills = {}, {}
    for budget in (16, 512):
        monkeypatch.setenv("PSQ_WAVE_ROWS", str(budget))
        eng = TorchEngine("cpu", torch.float64)
        assert eng.wave_rows == budget
        score, calls = eng.score_alignments_multi, []

        def counted(*args, **kwargs):
            calls.append(kwargs.get("likes_only", False))
            return score(*args, **kwargs)

        eng.score_alignments_multi = counted
        rng = np.random.default_rng(55)
        datas = [PortData.from_session(port_session(
            rng, ref_len=n, coverage=5, draft_error=0.05)[0])
            for n in (120, 170)]
        for d in datas:
            d.params.realign_width = 24
            d.params.scoring_width = 8
        start = [d.sequence for d in datas]
        cands = eng.viterbi_mutate_multi([d.events for d in datas], 16, 0.05,
                                         0.01, 0.33, 0.75)
        mutate_datas(eng, datas, cands, 1)
        out[budget], fills[budget] = [d.sequence for d in datas], sum(calls)
    assert out[16] == out[512] != start
    assert fills[16] > fills[512] > 0
