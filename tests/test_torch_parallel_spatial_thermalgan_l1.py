"""ThermalGAN with the three-scale stage-1 discriminator on the port's
spatial axis, on the CPU: thermalgan with ``d_vae_mode="multi_l1"`` (so that
the ``MultiDiscriminator`` and its 2x average pools on rows have gradients)
on two gloo ranks as a (1 data x 2 spatial) mesh against one process, at
256², global batch 1, ``deterministic_g``, one step from the port's own
init from seed 0 (no JAX oracle here: the JAX step is
``test_torch_parallel_spatial_thermalgan.py``'s, for the batch-norm
variant). Instance norms throughout; the checks and bounds of
``test_torch_parallel_spatial_thermalgan.py`` (metrics rel 1e-5 / abs 1e-6,
float64 gradients within 1e-4 of max|g|, G2's 1-row conv on the whole map),
in float64 only: a float64 step of the family takes 15 s on one CPU thread,
and ``test_torch_parallel_spatial_thermalgan.py`` holds the float32 path.
"""

import torch

from test_torch_parallel_spatial_nemar import pair_and_one, pair_failures
from test_torch_parallel_spatial_thermalgan import check_pair, thermal_cfg
from tfcgan_tpu_torch.recipes import build_recipe


def test_thermalgan_multi_l1_spatial_pair_matches_world_one(tmp_path):
    cfg = thermal_cfg("thermalgan", d_vae_mode="multi_l1")
    recipe = build_recipe(cfg, "cpu")
    recipe.init(torch.Generator().manual_seed(0))
    torch.save({"G": recipe.G.state_dict(), "D": recipe.D.state_dict()}, tmp_path / "l1.pt")
    pair, one, grads = pair_and_one(tmp_path, {"l1": cfg}, float32=())
    (tmp_path / "l1.pt").unlink()
    check_pair(pair, one, pair_failures(grads, "l1"), "l1")
