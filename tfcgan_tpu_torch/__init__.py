"""PyTorch/CUDA port of ``tfcgan_tpu`` for NVIDIA Hopper (H100).

Module paths mirror the JAX package, whose ``tfcgan_tpu.config`` registry the
port reuses through ``tfcgan_tpu_torch.config`` (it imports only
dataclasses). The port imports ``torch`` and
never JAX. Hand-written kernels live in ``csrc/`` and are built with nvcc on
first use (``ops/kernels/_build.py``).
"""
