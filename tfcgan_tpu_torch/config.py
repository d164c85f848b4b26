"""Experiment configs of the port: the JAX package's ``tfcgan_tpu.config``
registry, reused as it is (it imports only ``dataclasses``, never JAX).

Port modules and the scripts that drive the port take their configs from
here, so ``tfcgan_tpu.config`` is the one module of the JAX package that the
port loads.
"""

from tfcgan_tpu.config import ExperimentConfig, get_experiment

__all__ = ["ExperimentConfig", "get_experiment"]
