"""Primitive ops of the port, NHWC like ``tfcgan_tpu.ops``.

Hand-written CUDA kernels live in ``ops/kernels``; each op that has one sends
CUDA tensors there and CPU tensors to its plain PyTorch version.
"""
