"""A run with the timed path broken underneath comes out not correct:
the look for a card is skipped (the port's twins on the CPU, at a small
size) and the rest of the run is driven as on the card.  One test for
each fault a cell can have: a step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), an answer altered
where it is produced.  No cell runs across chips, so none has an exchange
to leave out."""

from .conftest import run_tiny, tiny_cell


def test_a_sound_consensus_run_is_correct():
    res = run_tiny(tiny_cell("consensus-1kb-10x"))
    assert res["correct"], res["checks"]


def test_a_sound_variant_run_is_correct():
    res = run_tiny(tiny_cell("variant-all-1kb-10x"))
    assert res["correct"], res["checks"]


def _draft_results(sessions, params):
    trim = int(params.get("end_trim", 0))
    return {slot: (pa.sequence[trim:-trim] if trim else pa.sequence, 100.0)
            for slot, pa, _ in sessions}


def test_consensus_rounds_return_the_draft_unchanged(monkeypatch):
    from poreseq_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "_lockstep_consensus",
                        lambda sessions, params, reps, verbose:
                        _draft_results(sessions, params))
    res = run_tiny(tiny_cell("consensus-1kb-10x"))
    assert not res["correct"], res["checks"]


def _patch_scores(monkeypatch, change):
    from poreseq_tpu_torch.engine import TorchEngine

    real = TorchEngine.score_mutations_multi

    def scored(self, datas, muts_list):
        return change(self, real, datas, muts_list)

    monkeypatch.setattr(TorchEngine, "score_mutations_multi", scored)


def test_variant_state_unchanged(monkeypatch):
    from poreseq_tpu_torch.engine.types import make_mutscores

    _patch_scores(monkeypatch, lambda self, real, datas, muts_list:
                  [make_mutscores(m) for m in muts_list])
    res = run_tiny(tiny_cell("variant-all-1kb-10x"))
    assert not res["correct"], res["checks"]


def _half_events(self, real, datas, muts_list):
    """Half of each region's event rows left out, the scores scaled to
    the whole."""
    for d in datas:
        d.events = d.events[: len(d.events) // 2]
    out = real(self, datas, muts_list)
    for ms in out:
        for m in ms:
            m.score *= 2.0
    return out


def _one_altered(self, real, datas, muts_list):
    """One score of the call altered: the sign of the first region's
    largest flipped."""
    out = real(self, datas, muts_list)
    scored = [ms for ms in out if ms]
    if scored:
        m = max(scored[0], key=lambda m: abs(m.score))
        m.score = -m.score
    return out


def test_variant_half_the_batch_left_out(monkeypatch):
    _patch_scores(monkeypatch, _half_events)
    res = run_tiny(tiny_cell("variant-all-1kb-10x"))
    assert not res["correct"], res["checks"]


def test_variant_answer_altered(monkeypatch):
    _patch_scores(monkeypatch, _one_altered)
    res = run_tiny(tiny_cell("variant-all-1kb-10x"))
    assert not res["correct"], res["checks"]


def test_the_variant_control_is_not_correct():
    """The reference in bfloat16 in the port's place fails the cell's
    limit (``psq_benchmark.control`` reads it on the card at the cell's
    own size)."""
    res = run_tiny(tiny_cell("variant-all-1kb-10x"), control=True)
    assert res["control"]["score_gap"] > res["checks"]["score_gap"]["limit"]


def test_the_consensus_call_control_is_not_correct():
    """The bfloat16 reference in the scorer's place on the recorded call
    fails the cell's limit."""
    res = run_tiny(tiny_cell("consensus-1kb-10x"), control=True)
    assert res["control"]["call_gap"] > res["checks"]["call_gap"]["limit"]


def test_consensus_scores_unchanged(monkeypatch):
    from poreseq_tpu_torch.engine.types import make_mutscores

    _patch_scores(monkeypatch, lambda self, real, datas, muts_list:
                  [make_mutscores(m) for m in muts_list])
    res = run_tiny(tiny_cell("consensus-1kb-10x"))
    assert not res["correct"], res["checks"]


def test_consensus_half_the_events_left_out(monkeypatch):
    _patch_scores(monkeypatch, _half_events)
    res = run_tiny(tiny_cell("consensus-1kb-10x"))
    assert not res["correct"], res["checks"]


def test_consensus_score_altered(monkeypatch):
    _patch_scores(monkeypatch, _one_altered)
    res = run_tiny(tiny_cell("consensus-1kb-10x"))
    assert not res["correct"], res["checks"]
