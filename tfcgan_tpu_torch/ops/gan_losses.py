"""Adversarial losses, port of ``tfcgan_tpu.ops.gan_losses``: the relativistic
BCE-with-logits pair of the TFC-GAN family (label smoothing 0.9) and the
least-squares loss of NeMAR and CycleGAN."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean BCE-with-logits against a constant target, in float32."""
    x = logits.float()
    return (F.relu(x) - x * target + torch.log1p(torch.exp(-x.abs()))).mean()


def relativistic_g_loss(pred_fake: torch.Tensor, pred_real: torch.Tensor,
                        smooth: float = 0.9) -> torch.Tensor:
    """BCE(pred_fake - pred_real.detach(), smooth)."""
    return bce_with_logits(pred_fake - pred_real.detach(), smooth)


def relativistic_d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor,
                        smooth: float = 0.9, weight: float = 0.5) -> torch.Tensor:
    """weight * (BCE(real - fake, smooth) + BCE(fake - real, 0))."""
    return weight * (bce_with_logits(pred_real - pred_fake, smooth)
                     + bce_with_logits(pred_fake - pred_real, 0.0))


def lsgan_loss(pred: torch.Tensor, target: float) -> torch.Tensor:
    """Mean squared error against a constant target, in float32."""
    return (pred.float() - target).square().mean()
