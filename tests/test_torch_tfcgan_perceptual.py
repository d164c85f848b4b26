"""The fft_glo recipe with the msrecon perceptual term, the port against the
JAX package, float32 on the CPU.

``perceptual="msrecon"``, and ``"auto"`` where no LPIPS weights exist, score
G's output with the fixed multi-scale L1 + NCC pyramid instead of LPIPS, as
``lpips_weight * multiscale_recon(fake_b, b)`` under ``g_lpips``. Both sides
start from one JAX state at step 0 (fft_glo at 64², batch 2, deterministic
G) and take step 0's draws from the JAX key, as test_torch_train.py does.

Tolerances: those of test_torch_train.py at fixed weights, loss terms rtol
1e-4 and every G gradient atol 2e-4 x its tensor's max|g|.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_train import _cfg, _jax_state, jax_step_draws
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu_torch.bridge import generator_from_flax, train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.train.trainer import _frozen


@pytest.mark.parametrize("perceptual", ["msrecon", "auto"])
def test_msrecon_g_loss_and_gradients_match_jax(perceptual, monkeypatch):
    monkeypatch.delenv("TFCGAN_LPIPS_WEIGHTS", raising=False)  # "auto" is msrecon then
    cfg = _cfg(64, 2)
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, perceptual=perceptual))
    recipe, state = _jax_state(cfg)
    assert recipe.perceptual == "msrecon" and recipe.lpips is None
    port = build_recipe(cfg, "cpu")
    assert port.perceptual == "msrecon" and port.lpips is None
    train_state_from_flax(state, port, torch.Generator())
    batch = synthetic_batch(2, 64, seed=0)

    g_rng, _ = jax.random.split(jax.random.fold_in(state.rng, 0))
    spectral = jax_power_iteration(state.d_params, state.spectral)
    (_, (_, want)), grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, spectral, state.frozen, batch, g_rng)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    spectral_power_iteration(port.D, order="vu")
    with _frozen(port.D):
        loss_g, _, got = port.g_loss(tb, jax_step_draws(state.rng, 0, cfg.loss.patch_grid))
        loss_g.backward()
    assert float(got["g_lpips"].detach()) > 0
    for k in ("g_lpips", "loss_G"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, err_msg=k)
    want_g = generator_from_flax(grads["G"])
    for name, p in port.G.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-4 * np.abs(w).max(), err_msg=name)
