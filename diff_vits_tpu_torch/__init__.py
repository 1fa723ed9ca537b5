"""PyTorch port of diff_vits_tpu for NVIDIA Hopper.

The JAX package ``diff_vits_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Entry points run on the card
unless the caller passes ``device="cpu"``; on the CPU every fused op runs
its plain PyTorch version, on the card its hand-written CUDA kernels
(``diff_vits_tpu_torch/csrc``, built with nvcc into ``build/`` at first
use).
"""
