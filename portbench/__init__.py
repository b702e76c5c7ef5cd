"""Benchmark of ``zstd_tpu_torch`` on one CUDA card: ``python -m portbench.run``."""
