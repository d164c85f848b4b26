"""Wrappers of the hand-written Hopper kernels in ``tfcgan_tpu_torch/csrc``."""
