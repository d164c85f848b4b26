"""The recipe protocol of the port, after ``tfcgan_tpu.recipes.base``.

A recipe owns its modules on one device: ``G``, everything the G optimizer
steps, and ``D``, everything the D optimizer steps (a single network, or an
``nn.ModuleDict`` of several, as the STN family's G1, G2, STN and D1, D2),
and any frozen loss network. It exposes the two losses; the trainer (``train/trainer.py``)
differentiates them and steps the optimizers. Every random draw of a step
comes in as one argument (``draws``), made by ``draw`` from a
``torch.Generator`` or handed in by a caller that needs other draws (the
tests rebuild the JAX package's). ``g_loss`` returns the generated images
detached in ``aux``, and ``d_loss`` reuses them: G runs once per step.

A recipe whose discriminator is updated first (``update_order = "d_first"``,
see ``DFirstRecipe``) also exposes the generator side's forward on its own,
so that the trainer can run it once, feed its detached outputs to ``d_loss``
and, after D's update, hand the same forward to ``g_loss``.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch
import torch.nn as nn

Batch = dict[str, torch.Tensor]


class GANRecipe(Protocol):
    name: str
    device: torch.device
    G: nn.Module
    D: nn.Module

    def init(self, generator: torch.Generator) -> None:
        """Draw every module's weights from ``generator``."""
        ...

    def draw(self, generator: torch.Generator, batch: Batch) -> Any:
        """Every random draw of one step."""
        ...

    def g_loss(self, batch: Batch, draws: Any) -> tuple[torch.Tensor, dict, dict]:
        """(loss_G, aux, metrics)."""
        ...

    def d_loss(self, batch: Batch, aux: dict) -> tuple[torch.Tensor, dict]:
        """(loss_D, metrics)."""
        ...


class DFirstRecipe(GANRecipe, Protocol):
    """What the trainer's D-first order needs on top of ``GANRecipe``."""

    update_order: str  # "d_first"

    def forward(self, batch: Batch, draws: Any) -> dict:
        """The generator side's forward, with its graph."""
        ...

    def d_aux(self, forward: dict) -> dict:
        """``d_loss``'s ``aux``: the detached outputs of ``forward``."""
        ...

    def g_loss(self, batch: Batch, draws: Any, forward: dict | None = None
               ) -> tuple[torch.Tensor, dict, dict]:
        """(loss_G, aux, metrics) on ``forward`` (run here when None)."""
        ...
