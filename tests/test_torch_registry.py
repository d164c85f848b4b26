"""Every registry entry builds in the port: ``build_recipe`` on the CPU for
each of the 36 experiments, whose recipe family, G and D exist. The modules
are built without drawing their weights (``layers.without_draws``), as the
CLI builds them before a checkpoint fills them."""

import pytest
import torch

from tfcgan_tpu_torch.config import EXPERIMENTS
from tfcgan_tpu_torch.models.layers import without_draws
from tfcgan_tpu_torch.recipes import build_recipe


def test_the_registry_has_36_entries():
    assert len(EXPERIMENTS) == 36
    assert {cfg.recipe for cfg in EXPERIMENTS.values()} == {
        "tfcgan", "stn", "nemar", "diffusion", "cyclegan", "thermalgan"}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_build_recipe_builds_every_entry(name):
    cfg = EXPERIMENTS[name]
    with without_draws():
        recipe = build_recipe(cfg, "cpu")
    assert recipe.name == cfg.recipe and recipe.device == torch.device("cpu")
    assert isinstance(recipe.G, torch.nn.Module) and isinstance(recipe.D, torch.nn.Module)
    assert sum(p.numel() for p in recipe.G.parameters()) > 0
