"""The port's spatial axis (``tfcgan_tpu_torch.parallel.spatial``) on the
CPU: fft_glo on four gloo ranks as a (2 data x 2 spatial) mesh, spawned by
``torch_dist_ranks.spawn``, against one process and against the JAX
``Trainer`` on ``make_mesh(8, spatial=2)`` (the contract of
``tests/test_train.py::TestSpatialMesh``).

fft_glo, global batch 8 at 64², float32, deterministic G, one step from the
JAX state of ``test_torch_train._jax_state`` carried over by the bridge,
with the JAX step's draws. Each rank holds 2 samples' rows 0-31 or 32-63.

- Against the port's world 1: every metric rel 1e-5 / abs 1e-6 (the data
  axis's bounds, ``test_torch_parallel_dp.py``).
- The gradients against world 1's, every G and D gradient within 1e-4 of
  its tensor's max|g|, from a second pair of runs in float64 (modules and
  activations; the step otherwise the same). The gradients are compared,
  not the parameters after the step: Adam's m / sqrt(v) hides a constant
  factor in a gradient, and the spatial axis's gradient rule (each rank's
  share, summed over the group) is what would carry one. They are taken in
  float64 because in float32 the shards' convs and norms round otherwise
  than the whole map's, and at this state a leaky ReLU input of the U-Net's
  down path sits within that rounding of 0: its slope flips and moves
  down1-down5's gradients by up to 5e-2 of max|g| in world 1 alone (A
  moved by one float32 step does the same). In float64 no input sits that
  close, so one bound holds every tensor (measured on the CPU: 4.7e-15 of
  max|g| at most, G and D).
- Against the JAX Trainer's step on its (4 x 2) mesh: ``loss_G``,
  ``loss_D`` and ``g_fft`` within ``test_train.py``'s rtol 2e-4, every
  metric within rel 2e-3 / abs 1e-5.
- At 64² the U-Net's down6 maps have 1 row: its conv and blur-pool run on
  the whole map on both spatial ranks, 2 layers a step; no other layer of
  G, D or LPIPS does.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_train import _cfg as fftglo_cfg
from test_torch_train import _jax_state, jax_step_draws
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.parallel.mesh import place_state as jax_place_state
from tfcgan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.recipes import build_recipe


def _close_metrics(got, want, rel, abs_, keys=None):
    for k in keys or want:
        assert got[k] == pytest.approx(want[k], rel=rel, abs=abs_), (k, got[k], want[k])


def _close_grads(got, want, what):
    """Each gradient within 1e-4 of its max|g|."""
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float64, (what, k)
        scale = float(want[k].abs().max()) + 1e-12
        np.testing.assert_allclose(got[k].numpy() / scale, want[k].numpy() / scale,
                                   atol=1e-4, err_msg=f"{what} {k}")


def test_fft_glo_spatial_mesh_matches_world_one_and_the_jax_spatial_mesh(tmp_path):
    cfg = fftglo_cfg(64, 8)
    recipe, state = _jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    train_state_from_flax(state, port, torch.Generator())
    modules = tmp_path / "modules.pt"
    torch.save({"G": port.G.state_dict(), "D": port.D.state_dict(),
                "lpips": port.lpips.state_dict()}, modules)
    d = jax_step_draws(state.rng, 0, cfg.loss.patch_grid)
    draws = {"neg": d.patch_neg.numpy(), "factors": d.jitter_factors.numpy(),
             "order": list(d.jitter_order)}
    kw = dict(cfg=cfg, modules=str(modules), draws=draws, steps=1)
    kw64 = dict(kw, tmp=str(tmp_path), float64=True)
    # the ranks' float32 and float64 steps in one spawn, world 1's in another;
    # the JAX Trainer's step on its (data 4 x spatial 2) mesh, from the same
    # state, runs here meanwhile
    with ranks.start("calls", 4, tmp_path, deadline=300.0,
                     jobs=[("fftglo_steps", dict(kw, spatial=2)),
                           ("fftglo_steps", dict(kw64, spatial=2))]) as job, \
            ranks.start("calls", 1, tmp_path, deadline=300.0,
                        jobs=[("fftglo_steps", kw), ("fftglo_steps", kw64)]) as one:
        c = cfg.replace(mesh=cfg.mesh.__class__(num_devices=8, spatial=2))
        mesh = jax_make_mesh(8, spatial=2)
        trainer = JaxTrainer(c, recipe, mesh=mesh)
        assert trainer.mesh.axis_names == ("data", "spatial")
        jstate = jax_place_state(state, mesh)
        _, m = trainer.compiled_step()(jstate, jax_shard_batch(synthetic_batch(8, 64, seed=0),
                                                               mesh))
        want = {k: float(v) for k, v in jax.device_get(m).items()}
        w4 = [r[0] for r in job.join()]
        w1 = one.join()[0][0]
    assert all(w["metrics"] == w4[0]["metrics"] and w["sums"] == w4[0]["sums"] for w in w4)
    assert all(w["replicated"] == 2 for w in w4), [w["replicated"] for w in w4]
    assert w4[0]["allreduces"] == 2 and set(w4[0]["bytes"]) == {"G", "D"}
    _close_metrics(w4[0]["metrics"][0], w1["metrics"][0], 1e-5, 1e-6)
    assert sorted(w4[0]["metrics"][0]) == sorted(w1["metrics"][0])
    grads = {f"{m}{w}": torch.load(tmp_path / f"{m}_grads_{w}_f64.pt") for m in "gd" for w in "41"}
    for name in ("modules.pt", *(f"{m}_grads_{w}_f64.pt" for m in "gd" for w in "41")):
        (tmp_path / name).unlink()
    for m in "gd":
        _close_grads(grads[m + "4"], grads[m + "1"], m.upper())

    got = w4[0]["metrics"][0]
    _close_metrics(got, want, 2e-4, 0.0, keys=("loss_G", "loss_D", "g_fft"))
    _close_metrics(got, want, 2e-3, 1e-5)
