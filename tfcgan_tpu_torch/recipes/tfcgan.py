"""The TFC-GAN recipe, port of ``tfcgan_tpu.recipes.tfcgan``: so far only the
generator of the non-conditional, no-mask experiments (fft_glo and its
siblings). The losses, the discriminator and the train step come with the
training slice.
"""

from __future__ import annotations

import torch

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.unet import GeneratorUNet


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def build_generator(cfg: ExperimentConfig, device, generator: torch.Generator | None = None
                    ) -> GeneratorUNet:
    """The experiment's G on ``device`` in eval mode, weights normal(0, 0.02)
    drawn from ``generator`` (load a state dict over them for trained weights)."""
    if cfg.recipe != "tfcgan":
        raise NotImplementedError(f"recipe {cfg.recipe!r} is not ported yet")
    if cfg.loss.conditional or cfg.loss.use_mask:
        raise NotImplementedError(
            "the conditional (debiased) and saliency-mask generators are not ported yet")
    g = GeneratorUNet(in_channels=cfg.data.channels, out_channels=cfg.data.channels,
                      dtype=_dtype(cfg), device=device, generator=generator)
    return g.eval()
