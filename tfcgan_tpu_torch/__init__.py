"""PyTorch/CUDA port of ``tfcgan_tpu`` for NVIDIA Hopper (H100).

Module paths mirror the JAX package. The port imports ``torch``, never JAX
and nothing of the JAX package: ``tfcgan_tpu_torch.config`` is its own copy of
the experiment registry. Hand-written kernels live in ``csrc/`` and are built with nvcc on
first use (``ops/kernels/_build.py``).
"""
