"""The benchmark of diff_vits_tpu_torch on NVIDIA H100 cards: cells,
traffic, the plain reference, the work arithmetic and the metrics'
readers. ``python3 -m benchmark.run --help`` runs one cell."""
