"""The banded pair-HMM fill with its running best: the port's
``engine/fill.get_fill`` on its twin route only (``dp.fill_reference`` +
``dp.finish_fill``), on the tensors' device."""

from __future__ import annotations

from .dp import EventBatch, FillResult, fill_reference, finish_fill


def get_fill(width: int, need_steps: bool = True):
    """fill(batch, states, i0, i1, is_pad, lik_offset, backward) ->
    FillResult at half-width ``width`` (W = 2*width+1)."""
    W = 2 * width + 1

    def fill(batch: EventBatch, states, i0, i1, is_pad, lik_offset,
             backward: bool) -> FillResult:
        raw = fill_reference(batch, states, i0, i1, is_pad, lik_offset,
                             backward, W, need_steps)
        return finish_fill(*raw, i0, i1, backward)

    return fill
