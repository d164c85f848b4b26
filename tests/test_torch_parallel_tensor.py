"""The port's tensor axis (``tfcgan_tpu_torch.parallel.tensor``) on the CPU:
fft_glo on four gloo ranks as a (2 data x 2 tensor) mesh, spawned by
``torch_dist_ranks.spawn``, against one process and against the JAX
``Trainer`` on ``make_mesh(8, tensor=2)`` (the contract of
``tests/test_train.py::TestTensorMesh``).

fft_glo, global batch 8 at 64², float32, deterministic G, one step from the
JAX state of ``test_torch_train._jax_state`` carried over by the bridge,
with the JAX step's draws:

- against the port's world 1: every metric rel 1e-5 / abs 1e-6 and every
  gathered G gradient within 1e-4 of its tensor's max|g| (the bounds that
  ``test_torch_parallel_dp.py`` holds the data axis to; the tensor axis
  changes only the float32 order of the partial sums of the input
  gradients and of sigma);
- against the JAX Trainer's step on its (4 x 2) mesh: ``loss_G``, ``loss_D``,
  ``g_fft`` and ``g_lpips`` within ``test_train.py``'s rtol 2e-4, every
  metric within ``test_torch_parallel_dp.py``'s cross-framework rel 2e-3 /
  abs 1e-5;
- each rank holds half of ``G.down1.conv``'s 64 out-channels, and so do
  both Adam moments after the update (the moments are made by the first
  update; ``test_torch_parallel_tensor_ckpt.py`` holds them before it, from a
  restored checkpoint); the four ranks' gathered replicas are equal.
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


def test_fft_glo_tensor_mesh_matches_world_one_and_the_jax_tensor_mesh(tmp_path):
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
    kw = dict(cfg=cfg, modules=str(modules), draws=draws, steps=1, tmp=str(tmp_path))
    w4 = ranks.spawn("fftglo_steps", 4, tmp_path, tensor=2, **kw)
    w1 = ranks.fftglo_steps(0, 1, **kw)
    assert all(w["metrics"] == w4[0]["metrics"] and w["sums"] == w4[0]["sums"] for w in w4)
    assert w4[0]["allreduces"] == 2 and set(w4[0]["bytes"]) == {"G", "D"}
    for w in w4:  # half the out-channels, and after the update half the moments too
        before, after = w["shapes"]
        assert before == [(32, 3, 4, 4)] and after == [(32, 3, 4, 4)] * 3, w["shapes"]
    _close_metrics(w4[0]["metrics"][0], w1["metrics"][0], 1e-5, 1e-6)
    assert sorted(w4[0]["metrics"][0]) == sorted(w1["metrics"][0])
    g4 = torch.load(tmp_path / "g_grads_4.pt")
    g1 = torch.load(tmp_path / "g_grads_1.pt")
    for name in ("modules.pt", "g_grads_4.pt", "g_grads_1.pt"):
        (tmp_path / name).unlink()
    assert sorted(g4) == sorted(g1)
    for k in g1:
        scale = float(g1[k].abs().max()) + 1e-8
        np.testing.assert_allclose(g4[k].numpy() / scale, g1[k].numpy() / scale, atol=1e-4,
                                   err_msg=k)

    # the JAX Trainer's step on its (data 4 x tensor 2) mesh, from the same state
    c = cfg.replace(mesh=cfg.mesh.__class__(num_devices=8, tensor=2))
    mesh = jax_make_mesh(8, tensor=2)
    trainer = JaxTrainer(c, recipe, mesh=mesh)
    jstate = jax_place_state(state, mesh)
    kern = jstate.g_params["G"]["down1"]["conv"]["kernel"]
    assert kern.addressable_shards[0].data.shape[-1] * 2 == kern.shape[-1]
    _, m = trainer.compiled_step()(jstate, jax_shard_batch(synthetic_batch(8, 64, seed=0), mesh))
    want = {k: float(v) for k, v in jax.device_get(m).items()}
    got = w4[0]["metrics"][0]
    _close_metrics(got, want, 2e-4, 0.0, keys=("loss_G", "loss_D", "g_fft", "g_lpips"))
    _close_metrics(got, want, 2e-3, 1e-5)
