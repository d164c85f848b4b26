"""Every registry entry runs on the port's spatial axis: ``Trainer`` builds
each of the 36 on a (1 data x 2 spatial) mesh, and no recipe carries a
``supports_spatial`` switch; the recipe docstring of the tfcgan family
names each of its 26 entries. What is still refused: a device batch whose
rows are not this rank's share of ``cfg.data.image_size``-row images. And
``--spatial`` and ``--tensor`` set the experiment's ``cfg.mesh`` alike. The
mesh record is made by hand (no process group: the checks come before any
collective) and the recipes are built on the meta device.
"""

import re
from unittest import mock

import pytest
import torch

from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.config import EXPERIMENTS
from tfcgan_tpu_torch.parallel.mesh import Mesh
from tfcgan_tpu_torch.parallel.spatial import SpatialAxis
from tfcgan_tpu_torch import recipes
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes import tfcgan
from tfcgan_tpu_torch.train.trainer import Trainer

ENTRIES = sorted(EXPERIMENTS)


def _spatial_pair() -> Mesh:
    return Mesh(("data", "spatial"), {"data": 1, "spatial": 2}, 0, 2, None,
                torch.device("cpu"), 0, 1, None, None, SpatialAxis(None, 0, 2), None)


@pytest.mark.parametrize("name", ENTRIES)
def test_the_stn_and_diffusion_entries_run_on_a_spatial_mesh(name):
    """Every entry of the registry (the stn, diffusion, nemar, cyclegan and
    thermalgan families' and the 26 tfcgan ones, the debiased chain and the
    saliency mask among them) runs on a spatial mesh."""
    cfg = EXPERIMENTS[name]
    trainer = Trainer(cfg, build_recipe(cfg, "meta"), mesh=_spatial_pair())
    assert trainer.mesh.spatial.size == 2


def test_the_row_shard_entries_are_the_recipe_docstrings_list():
    tfcgan_entries = sorted(n for n in ENTRIES if EXPERIMENTS[n].recipe == "tfcgan")
    assert len(ENTRIES) == 36 and len(tfcgan_entries) == 26
    for name in tfcgan_entries:
        assert re.search(rf"\b{name}\b", tfcgan.__doc__), name
    assert {EXPERIMENTS[n].recipe for n in ENTRIES} == set(recipes._RECIPES)
    for recipe in recipes._RECIPES.values():
        assert not hasattr(recipe, "supports_spatial"), recipe


def test_a_device_batch_of_another_height_is_refused():
    cfg = EXPERIMENTS["fft_glo"]
    trainer = Trainer(cfg, build_recipe(cfg, "meta"), mesh=_spatial_pair())
    own = cfg.data.image_size // 2  # rank 0's rows of the run's images
    for rows in (own - 1, cfg.data.image_size):
        batch = {k: torch.empty((2, rows, cfg.data.image_size, 3), device="meta")
                 for k in ("A", "B")}
        with pytest.raises(ValueError, match=f"{own} rows"):
            trainer.step(None, batch)


@pytest.mark.parametrize("flags, want", [([], (1, 1)), (["--spatial", "2"], (2, 1)),
                                         (["--tensor", "2"], (1, 2)),
                                         (["--spatial", "2", "--tensor", "3"], (2, 3))])
def test_cli_mesh_flags_set_the_experiment_mesh(flags, want):
    seen = []
    with mock.patch.object(cli, "cmd_train", lambda args: seen.append(cli._cfg_from_args(args))):
        cli.main(["train", "--experiment", "fft_glo", *flags])
    assert (seen[0].mesh.spatial, seen[0].mesh.tensor) == want
