"""Recipes of the port: the modules and losses of each experiment family."""

from __future__ import annotations

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.recipes.cyclegan import CycleGANRecipe
from tfcgan_tpu_torch.recipes.diffusion import DiffusionRecipe
from tfcgan_tpu_torch.recipes.nemar import NeMARRecipe
from tfcgan_tpu_torch.recipes.stn import STNRecipe
from tfcgan_tpu_torch.recipes.tfcgan import TFCGANRecipe
from tfcgan_tpu_torch.recipes.thermalgan import ThermalGANRecipe

_RECIPES = {"tfcgan": TFCGANRecipe, "stn": STNRecipe, "nemar": NeMARRecipe,
            "diffusion": DiffusionRecipe, "cyclegan": CycleGANRecipe,
            "thermalgan": ThermalGANRecipe}


def build_recipe(cfg: ExperimentConfig, device="cuda"):
    """The recipe named by ``cfg.recipe``, its modules on ``device`` (the
    card, unless the caller names another)."""
    if cfg.recipe not in _RECIPES:
        raise ValueError(f"unknown recipe {cfg.recipe!r}; known: {sorted(_RECIPES)}")
    return _RECIPES[cfg.recipe](cfg, device)
