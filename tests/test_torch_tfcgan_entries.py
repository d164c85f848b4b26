"""The tfcgan registry entries beside fft_glo, the port against the JAX
package, float32 on the CPU: the FFT family (``patch_grid`` 4, ``fft_mode``
"patch" with ``fft_grid`` 2 and 4) and original_16p (no FFT term).
test_torch_tfcgan_entries_triptemp.py and test_torch_tfcgan_entries_ablation.py
hold the triptemp and the ablation entries.

Each case builds both recipes from the registry at 64², batch 2, float32 and
deterministic G, starts both from one JAX state at step 0 carried into the
port by ``bridge.train_state_from_flax``, takes step 0's draws from the JAX
key, and compares g_loss and d_loss at those weights: the same terms on both
sides, each within rtol 1e-4, and every G and D gradient within atol 2e-4 x
its tensor's max|g| (the tolerances of test_torch_train.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_train import _jax_state, jax_step_draws
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu_torch.bridge import discriminator_from_flax, generator_from_flax
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.train.trainer import _frozen


def entry_cfg(name, size=64, batch=2):
    """The registry entry at ``size``², batch ``batch``, float32, G without dropout."""
    cfg = get_experiment(name)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={**cfg.extra, "deterministic_g": True})


def assert_entry_matches_jax(name, monkeypatch):
    """g_loss and d_loss of the entry, terms and gradients, port against JAX."""
    monkeypatch.delenv("TFCGAN_LPIPS_WEIGHTS", raising=False)
    cfg = entry_cfg(name)
    recipe, state = _jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    assert port.perceptual == recipe.perceptual
    train_state_from_flax(state, port, torch.Generator())
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=0)

    g_rng, d_rng = jax.random.split(jax.random.fold_in(state.rng, 0))
    spectral = jax_power_iteration(state.d_params, state.spectral)
    (_, (aux, g_metrics)), g_grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, spectral, state.frozen, batch, g_rng)
    (_, d_metrics), d_grads = jax.jit(jax.value_and_grad(recipe.d_loss, has_aux=True))(
        state.d_params, spectral, aux, batch, d_rng)
    want = {k: v for k, v in {**g_metrics, **d_metrics}.items() if not k.startswith("_")}

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    spectral_power_iteration(port.D, order="vu")
    with _frozen(port.D):
        loss_g, port_aux, got = port.g_loss(tb, jax_step_draws(state.rng, 0, cfg.loss.patch_grid))
        loss_g.backward()
    loss_d, d_got = port.d_loss(tb, port_aux)
    loss_d.backward()
    got.update(d_got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4,
                                   err_msg=f"{name} {k}")
    for module, grads in ((port.G, generator_from_flax(g_grads["G"])),
                          (port.D, discriminator_from_flax(d_grads["D"]))):
        for pname, p in module.named_parameters():
            w = grads[pname].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-4 * np.abs(w).max(),
                                       err_msg=f"{name} {pname}")
    return got


@pytest.mark.parametrize("name", ["fft_glo_16p", "fft_patch_4", "fft_patch_16", "original_16p"])
def test_entry_loss_and_gradients_match_jax(name, monkeypatch):
    got = assert_entry_matches_jax(name, monkeypatch)
    lc = get_experiment(name).loss
    assert ("g_fft" in got) == (lc.fft_mode != "off")
    assert ("g_triplet" in got) == (lc.patch_grid > 0)
