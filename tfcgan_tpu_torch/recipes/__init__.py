"""Recipes of the port: the modules and losses of each experiment family."""

from __future__ import annotations

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.recipes.tfcgan import TFCGANRecipe


def build_recipe(cfg: ExperimentConfig, device):
    """The recipe named by ``cfg.recipe``, its modules on ``device``."""
    if cfg.recipe != "tfcgan":
        raise NotImplementedError(f"recipe {cfg.recipe!r} is not ported yet (ROADMAP Queue 1)")
    return TFCGANRecipe(cfg, device)
