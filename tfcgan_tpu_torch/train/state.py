"""The training state of the port, after ``tfcgan_tpu.train.state``.

A plain dataclass: the step count, the ``torch.Generator`` the step's draws
come from, the recipe's modules (their float32 parameters and the spectral
u/v buffers) and the two Adams. ``torch.optim.Adam(lr, betas=(b1, b2),
eps=1e-8)`` computes optax's ``adam`` update: lr * m_hat / (sqrt(v_hat) +
eps), eps outside the root.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig


@dataclasses.dataclass
class TrainState:
    step: int
    generator: torch.Generator
    G: nn.Module
    D: nn.Module
    lpips: nn.Module | None
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam


def make_optimizers(cfg: ExperimentConfig, recipe) -> tuple[torch.optim.Adam, torch.optim.Adam]:
    """Adam on G's and on D's parameters; only the constant schedule so far."""
    o = cfg.optim
    if o.schedule != "constant":
        raise NotImplementedError(
            f"lr schedule {o.schedule!r} is not ported yet (it comes with the recipes "
            "that use it: CycleGAN and NeMAR)")
    return tuple(torch.optim.Adam(m.parameters(), lr=o.lr, betas=(o.b1, o.b2), eps=1e-8)
                 for m in (recipe.G, recipe.D))


def create_state(cfg: ExperimentConfig, recipe, seed: int) -> TrainState:
    """Weights drawn on the CPU from ``seed`` (the same on every device), step
    draws from a generator on the recipe's device seeded with ``seed``, fresh
    Adams."""
    recipe.init(torch.Generator().manual_seed(seed))
    opt_g, opt_d = make_optimizers(cfg, recipe)
    return TrainState(step=0, generator=torch.Generator(recipe.device).manual_seed(seed),
                      G=recipe.G, D=recipe.D, lpips=recipe.lpips, opt_g=opt_g, opt_d=opt_d)
