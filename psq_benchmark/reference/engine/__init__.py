"""TwinEngine: the port's TorchEngine (``engine/__init__.py``) cut to what
the benchmark's reference calls, ``score_mutations_multi``, with every stage
on the plain PyTorch twins, on any device and in bfloat16, float32 or
float64: it realigns the events (forward and backward fills, backtrace) and
scores the mutations (band geometry, windows, group scorer) with the
expressions the port's kernels are held to.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.sequence import seq_to_states
from .pack import pack_events, round_up, to_device_batch
from .types import AlignData


class TwinEngine:
    def __init__(self, device="cuda", dtype=torch.float64):
        self.device = torch.device(device)
        if dtype not in (torch.bfloat16, torch.float32, torch.float64):
            raise ValueError(f"TwinEngine: dtype {dtype} (need bfloat16, "
                             "float32 or float64)")
        self.dtype = dtype

    def _prepare_multi(self, datas: list[AlignData], participate=None):
        """Combined context for R regions: one packed batch, per-event
        states [C, E], per-event sequence lengths, region ids."""
        events = [ev for d in datas for ev in d.events]
        arrays, ref_indexes = pack_events(events)
        batch = to_device_batch(arrays, self.dtype, self.device)
        n0 = arrays["n0"]
        E = len(n0)

        ev_region = np.full(E, -1, dtype=np.int32)
        ev_region[: len(events)] = np.repeat(
            np.arange(len(datas), dtype=np.int32),
            [len(d.events) for d in datas])

        states_list = [seq_to_states(d.sequence) for d in datas]
        S_list = [len(s) for s in states_list]
        # at least one dead (all-zero) padding column past each S: the
        # mutation scorer reads it for rab=0 (no-suffix) joins
        C = round_up(max(S_list) + 8, 64)
        S_e = np.zeros(E, dtype=np.int64)
        states2 = np.full((C, E), -1, dtype=np.int32)
        for e in range(len(events)):
            r = ev_region[e]
            S_e[e] = S_list[r]
            states2[: S_list[r], e] = states_list[r]

        if participate is not None:
            mask = np.array([participate[r] if r >= 0 else False
                             for r in ev_region])
            active = arrays["active"] & mask
            arrays = dict(arrays, active=active)
            batch = batch._replace(
                active=torch.as_tensor(active, device=self.device))

        return dict(batch=batch, arrays=arrays, ref_indexes=ref_indexes,
                    n0=n0, E=E, ev_region=ev_region, S_list=S_list,
                    S_e=S_e, C=C, states2=states2)

    def score_mutations_multi(self, datas, muts_list):
        from .mutscore import score_mutations_multi

        return score_mutations_multi(self, datas, muts_list)
