"""The port's whole consensus loop against the JAX package's, each engine
drawing its own Viterbi candidates (no shared candidates): the port's
pipeline.mutate_many on TorchEngine float64 and the JAX package's on
TpuEngine float64 end in the same sequences and accuracies for two
regions batched in lockstep (phase 1 on the reads' basecalls, then a
Viterbi Mutate round and a Refine)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu import api
from poreseq_tpu import pipeline as jax_pipeline
from poreseq_tpu.engine.tpu import TpuEngine
from poreseq_tpu_torch import pipeline as port_pipeline
from poreseq_tpu_torch.engine import TorchEngine
from poreseq_tpu_torch.sim import write_run

torch.set_num_threads(1)

# narrower than test_torch_f32_e2e.py's 48/24/12: the JAX side's XLA
# compiles alone take about 20 s here, and the loop's result does not
# depend on the widths' size
CONF = dict(realign_width=24, scoring_width=12, point_width=8,
            min_coverage=0, max_coverage=30, min_overlap=50,
            max_length=10000, lik_offset=4.5)


def test_consensus_loop_equals_tpu_engine_f64(tmp_path, monkeypatch):
    """Two regions (150 and 210 b of a 360 b draft at 3 % error, 5 reads)
    through mutate_many with one rep: the same final sequences and
    accuracies on both engines, each changed from its draft."""
    _, draft, reads, bam, fasta = write_run(
        str(tmp_path), np.random.default_rng(5), ref_len=360, n_reads=5,
        draft_error=0.03)
    regions = ["synthref:0:150", "synthref:150:360"]
    port = port_pipeline.mutate_many(
        fasta, bam, reads, regions, params=dict(CONF), reps=1,
        engine=TorchEngine("cpu", torch.float64))
    jax.config.update("jax_enable_x64", True)
    try:
        monkeypatch.setitem(api._ENGINES, "tpu", TpuEngine(dtype=jnp.float64))
        want = jax_pipeline.mutate_many(fasta, bam, reads, regions,
                                        params=dict(CONF), reps=1,
                                        backend="tpu")
    finally:
        jax.config.update("jax_enable_x64", False)
    assert port == want
    assert [s for s, _ in port] != [draft[:150], draft[150:]]
