"""Triplet margin loss with ``nn.TripletMarginLoss`` semantics and a chosen
norm axis, port of ``tfcgan_tpu.ops.triplet``."""

from __future__ import annotations

import torch


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                        margin: float = 1.0, eps: float = 1e-6, axis: int = -1) -> torch.Tensor:
    """mean(relu(|a - p + eps| - |a - n + eps| + margin)), L2 norms along
    ``axis``, in float32. torch reduces along its last dim, which for the
    reference's NCHW images is W: NHWC callers pass axis=2."""
    a = anchor.float()

    def dist(other: torch.Tensor) -> torch.Tensor:
        d = a - other.float() + eps
        return torch.sqrt((d * d).sum(dim=axis))

    return torch.relu(dist(positive) - dist(negative) + margin).mean()
