"""tfc_diff on the port's spatial axis, on the CPU: four gloo ranks as a (2
data x 2 spatial) mesh, spawned by ``torch_dist_ranks.spawn``, against one
process and against the JAX ``Trainer`` on ``make_mesh(8, spatial=2)``.

tfc_diff (condA), global batch 8 at 32², float32, one step from the JAX state
of ``test_torch_diffusion._jax_state`` carried over by the bridge, with the
JAX step's noise and timesteps (``test_torch_diffusion.jax_step_draws``), cut
to each rank's samples and rows. Each rank holds 4 samples' rows 0-15 or
16-31; the U-Net's 16² and 8² maps split 8 + 8 and 4 + 4, and its 7
attention blocks attend each rank's queries (128 and 32) to the gathered
map's keys (256 and 64).

- Against the port's world 1: every metric rel 1e-5 / abs 1e-6, equal on
  the four ranks; no layer on the whole map.
- The gradients against world 1's, from a second pair of runs in float64,
  each within 1e-4 of its tensor's max|g| (the rule of
  ``test_torch_parallel_spatial_stn.close_grads`` for the gradients that are
  zero in exact arithmetic).
- Against the JAX Trainer's step on its (4 x 2) mesh: ``loss_G`` and
  ``g_noise_mse`` within rtol 2e-4, every metric within rel 2e-3 / abs 1e-5
  (the bounds of ``test_torch_parallel_spatial.py``).
"""

import jax
import torch

import torch_dist_ranks as ranks
from test_torch_diffusion import _cfg as diff_cfg
from test_torch_diffusion import _jax_state, jax_step_draws
from test_torch_parallel_spatial import _close_metrics
from test_torch_parallel_spatial_stn import close_grads
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.parallel.mesh import place_state as jax_place_state
from tfcgan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.recipes import build_recipe


def diffusion_modules(cfg, path):
    """The JAX test state, bridged, saved as the port recipe's modules."""
    recipe, state = _jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    train_state_from_flax(state, port, torch.Generator())
    saved = {"G": port.G.state_dict()}
    if port.lpips is not None:
        saved["lpips"] = port.lpips.state_dict()
    torch.save(saved, path)
    return recipe, state


def spatial_against_world_one(cfg, tmp_path, draws=None):
    """(world 4's results, world 1's): one float32 step each, and a float64
    pair whose G gradients are compared here."""
    modules = tmp_path / "modules.pt"
    kw = dict(cfg=cfg, modules=str(modules), draws=draws)
    kw64 = dict(kw, tmp=str(tmp_path), float64=True)
    # the ranks' float32 and float64 steps in one spawn, world 1's here meanwhile
    with ranks.start("calls", 4, tmp_path, deadline=300.0,
                     jobs=[("family_spatial_steps", dict(kw, spatial=2)),
                           ("family_spatial_steps", dict(kw64, spatial=2))]) as job:
        w1 = ranks.family_spatial_steps(0, 1, **kw)
        ranks.family_spatial_steps(0, 1, **kw64)
        w4 = [r[0] for r in job.join()]
    grads = {w: torch.load(tmp_path / f"g_grads_{w}_f64.pt") for w in "41"}
    for name in ("modules.pt", "g_grads_4_f64.pt", "g_grads_1_f64.pt"):
        (tmp_path / name).unlink()
    assert all(w["metrics"] == w4[0]["metrics"] for w in w4)
    assert sorted(w4[0]["metrics"]) == sorted(w1["metrics"])
    _close_metrics(w4[0]["metrics"], w1["metrics"], 1e-5, 1e-6)
    close_grads(grads["4"], grads["1"], cfg.name)
    return w4, w1


def test_tfc_diff_spatial_mesh_matches_world_one_and_the_jax_spatial_mesh(tmp_path):
    cfg = diff_cfg("condA", batch=8)
    recipe, state = diffusion_modules(cfg, tmp_path / "modules.pt")
    d = jax_step_draws(state.rng, 0, (8, 32, 32, 1), 500)
    draws = {"noise": d.noise.numpy(), "t": d.t.numpy()}
    w4, _ = spatial_against_world_one(cfg, tmp_path, draws)
    assert all(w["replicated"] == 0 for w in w4)

    c = cfg.replace(mesh=cfg.mesh.__class__(num_devices=8, spatial=2))
    mesh = jax_make_mesh(8, spatial=2)
    trainer = JaxTrainer(c, recipe, mesh=mesh)
    assert trainer.mesh.axis_names == ("data", "spatial")
    jstate = jax_place_state(state, mesh)
    batch = synthetic_batch(8, 32, seed=0, with_labels=True)
    _, m = trainer.compiled_step()(jstate, jax_shard_batch(batch, mesh))
    want = {k: float(v) for k, v in jax.device_get(m).items()}
    got = w4[0]["metrics"]
    assert sorted(got) == sorted(want)
    _close_metrics(got, want, 2e-4, 0.0, keys=("loss_G", "g_noise_mse"))
    _close_metrics(got, want, 2e-3, 1e-5)
