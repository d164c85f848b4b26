"""tfc_diff_hybrid (64²) on the port's spatial axis, on the CPU: four gloo
ranks as a (2 data x 2 spatial) mesh against one process, global batch 8,
float32, one step from the JAX state of ``test_torch_diffusion._jax_state``
carried over by the bridge, with the recipe's own draws (the noise cut to
each rank's rows, the generator's keep-masks to its blocks' rows). The
generator and LPIPS run on the rows, as in the ``tfcgan`` recipes.

- Every metric rel 1e-5 / abs 1e-6 of world 1's, equal on the four ranks;
  the G gradients (the U-Net, the class embedding and the generator) of a
  float64 pair of runs within 1e-4 of each tensor's max|g|
  (``test_torch_parallel_spatial_diffusion.spatial_against_world_one``).
- Layers on the whole map: the generator's 1-row down6 maps at 64² (its
  conv and blur-pool), 2 layers a step; the denoiser and LPIPS run none.
"""

from test_torch_diffusion import _cfg as diff_cfg
from test_torch_parallel_spatial_diffusion import diffusion_modules, spatial_against_world_one


def test_tfc_diff_hybrid_on_the_spatial_mesh_matches_world_one(tmp_path):
    cfg = diff_cfg("hybrid", batch=8)
    diffusion_modules(cfg, tmp_path / "modules.pt")
    w4, w1 = spatial_against_world_one(cfg, tmp_path)
    assert all(w["replicated"] == 2 for w in w4), [w["replicated"] for w in w4]
    assert w1["replicated"] == 0
