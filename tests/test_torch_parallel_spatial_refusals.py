"""The recipes that do not run on row shards refuse the port's spatial
axis: the seven debiased entries and the saliency mask (8) raise
``NotImplementedError`` in ``Trainer`` on a (1 data x 2 spatial) mesh,
naming ROADMAP.md 7c; the 28 that run there are the 18 of the tfcgan recipe
docstring's list, the three stn and three tfc_diff entries, nemar,
cyclegan, thermalgan and thermalgan_bn, each of which says
``supports_spatial`` and is accepted by ``Trainer`` on that mesh. A device
batch whose rows are not this rank's share of ``cfg.data.image_size``-row
images is refused too, and
``--spatial`` and ``--tensor`` set the experiment's ``cfg.mesh`` alike. The
mesh record is made by hand (no process group: the refusal comes before any
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
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes import tfcgan
from tfcgan_tpu_torch.train.trainer import Trainer

# the tfcgan entries that build ConditionalGeneratorUNet (the debiased chain)
# or the saliency mask
REFUSED = sorted(n for n, c in EXPERIMENTS.items()
                 if c.recipe == "tfcgan" and (c.loss.conditional or c.loss.use_mask))
ROW_SHARD_FAMILIES = sorted(n for n, c in EXPERIMENTS.items() if c.recipe != "tfcgan")


def _spatial_pair() -> Mesh:
    return Mesh(("data", "spatial"), {"data": 1, "spatial": 2}, 0, 2, None,
                torch.device("cpu"), 0, 1, None, None, SpatialAxis(None, 0, 2), None)


@pytest.mark.parametrize("name", REFUSED)
def test_recipes_without_row_shards_refuse_a_spatial_mesh(name):
    cfg = EXPERIMENTS[name]
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 7c"):
        Trainer(cfg, build_recipe(cfg, "meta"), mesh=_spatial_pair())


@pytest.mark.parametrize("name", ROW_SHARD_FAMILIES)
def test_the_stn_and_diffusion_entries_run_on_a_spatial_mesh(name):
    """Every entry of the families other than tfcgan (stn, diffusion, nemar,
    cyclegan, thermalgan) runs on a spatial mesh."""
    cfg = EXPERIMENTS[name]
    recipe = build_recipe(cfg, "meta")
    assert recipe.supports_spatial, name
    trainer = Trainer(cfg, recipe, mesh=_spatial_pair())
    assert trainer.mesh.spatial.size == 2


def test_the_row_shard_entries_are_the_recipe_docstrings_list():
    running = sorted(set(EXPERIMENTS) - set(REFUSED))
    assert len(REFUSED) == 8 and len(running) == 28 and len(ROW_SHARD_FAMILIES) == 10
    for name in running:
        if EXPERIMENTS[name].recipe == "tfcgan":
            assert re.search(rf"\b{name}\b", tfcgan.__doc__), name
        assert build_recipe(EXPERIMENTS[name], "meta").supports_spatial, name


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
