"""The benchmark of the poreseq_tpu_torch port: its harness, yardstick and reference."""
