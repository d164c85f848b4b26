"""Adversarial losses, port of ``tfcgan_tpu.ops.gan_losses``: the relativistic
BCE-with-logits pair of the TFC-GAN family (label smoothing 0.9), the
least-squares loss of NeMAR, ThermalGAN and CycleGAN, and NeMAR's other GAN
modes (vanilla, WGAN and its gradient penalty), which no registered recipe
calls.

With ``rows`` (the record of row-sharded logits on a spatial mesh) the
relativistic and least-squares losses return this rank's share of their mean over the whole
map (``parallel.spatial.share_mean``): the spatial group's shares sum to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.parallel.spatial import Rows, share_mean


def bce_with_logits(logits: torch.Tensor, target: float, rows: Rows | None = None
                    ) -> torch.Tensor:
    """Mean BCE-with-logits against a constant target, in float32 (this
    rank's share of it on row shards)."""
    x = logits.float()
    return share_mean(F.relu(x) - x * target + torch.log1p(torch.exp(-x.abs())), rows)


def relativistic_g_loss(pred_fake: torch.Tensor, pred_real: torch.Tensor,
                        smooth: float = 0.9, rows: Rows | None = None) -> torch.Tensor:
    """BCE(pred_fake - pred_real.detach(), smooth)."""
    return bce_with_logits(pred_fake - pred_real.detach(), smooth, rows)


def relativistic_d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor,
                        smooth: float = 0.9, weight: float = 0.5, rows: Rows | None = None
                        ) -> torch.Tensor:
    """weight * (BCE(real - fake, smooth) + BCE(fake - real, 0))."""
    return weight * (bce_with_logits(pred_real - pred_fake, smooth, rows)
                     + bce_with_logits(pred_fake - pred_real, 0.0, rows))


def lsgan_loss(pred: torch.Tensor, target: float, rows: Rows | None = None) -> torch.Tensor:
    """Mean squared error against a constant target, in float32 (this rank's
    share of it on row shards)."""
    return share_mean((pred.float() - target).square(), rows)


def vanilla_g_loss(pred_fake: torch.Tensor) -> torch.Tensor:
    """Non-relativistic saturating BCE generator loss (NeMAR's 'vanilla')."""
    return bce_with_logits(pred_fake, 1.0)


def wgan_g_loss(pred_fake: torch.Tensor) -> torch.Tensor:
    """WGAN generator loss: -mean(D(fake)), in float32."""
    return -pred_fake.float().mean()


def wgan_d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor) -> torch.Tensor:
    """WGAN critic loss: mean(D(fake)) - mean(D(real)), in float32."""
    return pred_fake.float().mean() - pred_real.float().mean()


def gradient_penalty(d_apply, real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor | None = None, mode: str = "mixed",
                     constant: float = 1.0, lambda_gp: float = 10.0) -> torch.Tensor:
    """WGAN-GP: lambda_gp * mean((||grad_x sum(D(x))||_2 - constant)^2) with x
    the real images, the fakes, or (``mode="mixed"``) alpha * real + (1 -
    alpha) * fake for the (N, 1, 1, 1) draw ``alpha`` (uniform on [0, 1) in
    the JAX function). The norm is sqrt(sum g^2 + 1e-16) in float32. The
    gradient is taken with ``create_graph=True``, so the penalty is
    differentiable in D's parameters and in the images."""
    if mode == "real":
        x = real
    elif mode == "fake":
        x = fake
    elif mode == "mixed":
        if alpha is None:
            raise ValueError("mode='mixed' needs the interpolation draw alpha")
        x = alpha * real + (1.0 - alpha) * fake
    else:
        raise ValueError(f"unknown gradient penalty mode {mode!r}")
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    g = grads.reshape(grads.shape[0], -1).float()
    norm = torch.sqrt(g.square().sum(dim=-1) + 1e-16)
    return lambda_gp * (norm - constant).square().mean()
