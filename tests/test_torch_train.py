"""The port's fft_glo train step against the JAX package's, float32 on the CPU.

Both sides start from one JAX state of numpy draws, carried into the port by
``bridge.train_state_from_flax``, and the port's step draws are rebuilt from
the JAX key (``torch_jax_lockstep``, shared with the drift test). G dropout
is off (``deterministic_g``): flax's dropout masks are not rebuilt here, and
the U-Net blocks' masks are tested in test_torch_models.py.

Tolerances: (a) at fixed weights every loss term rtol 1e-4 and every
gradient atol 2e-4 x its tensor's max|g|; (b)-(d) over whole steps, loss
terms rtol 3e-3 / atol 1e-4, the early-step window of
test_parity_trajectory.py (float32 noise compounds through the Adam steps).
"""

import jax
import numpy as np
import pytest
import torch

from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu_torch.bridge import discriminator_from_flax, generator_from_flax
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.train.trainer import Trainer, _frozen
from torch_jax_lockstep import TERMS, _batches, _cfg, _jax_state, _lockstep, jax_step_draws


@pytest.fixture(scope="module")
def fixed_weights():
    """(a)'s setting: fft_glo at 64², batch 2, deterministic G, both sides
    from one state at step 0, and step 0's batch and draws."""
    cfg = _cfg(64, 2)
    recipe, state = _jax_state(cfg)
    port_recipe = build_recipe(cfg, "cpu")
    train_state_from_flax(state, port_recipe, torch.Generator())
    batch = _batches(cfg, 1)[0]
    return cfg, recipe, state, port_recipe, batch


def test_g_and_d_loss_and_gradients_at_fixed_weights(fixed_weights):
    cfg, recipe, state, port_recipe, batch = fixed_weights
    g_rng, d_rng = jax.random.split(jax.random.fold_in(state.rng, 0))
    spectral = jax_power_iteration(state.d_params, state.spectral)
    (_, (aux, g_metrics)), g_grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, spectral, state.frozen, batch, g_rng)
    (_, d_metrics), d_grads = jax.jit(jax.value_and_grad(recipe.d_loss, has_aux=True))(
        state.d_params, spectral, aux, batch, d_rng)
    want = {**g_metrics, **d_metrics}

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    spectral_power_iteration(port_recipe.D, order="vu")
    with _frozen(port_recipe.D):
        loss_g, port_aux, got = port_recipe.g_loss(tb, jax_step_draws(state.rng, 0, 2))
        loss_g.backward()
    assert all(p.grad is None for p in port_recipe.D.parameters())
    loss_d, d_got = port_recipe.d_loss(tb, port_aux)
    loss_d.backward()
    got.update(d_got)
    for k in TERMS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, err_msg=k)

    for module, grads in ((port_recipe.G, generator_from_flax(g_grads["G"])),
                          (port_recipe.D, discriminator_from_flax(d_grads["D"]))):
        for name, p in module.named_parameters():
            w = grads[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_two_step_lockstep_with_the_jax_trainer():
    cfg = _cfg(64, 2)
    jax_state, port_state, jax_hist, port_hist = _lockstep(cfg, 2)
    np.testing.assert_allclose(port_hist, jax_hist, rtol=3e-3, atol=1e-4)
    assert port_state.step == int(jax_state.step) == 2
    # the bridge carries the Adam moments: the JAX state's, bridged, sit
    # where the port's own run put them (to 1 % in norm: a few elements move
    # further, where the step-2 gradients cross a ReLU kink on one side only;
    # a wrong layout is off by O(1))
    bridged = train_state_from_flax(jax_state, build_recipe(cfg, "cpu"), torch.Generator())
    assert bridged.step == 2
    for opt, ref in ((bridged.opt_g, port_state.opt_g), (bridged.opt_d, port_state.opt_d)):
        for p, q in zip(opt.param_groups[0]["params"], ref.param_groups[0]["params"]):
            a, b = opt.state[p], ref.state[q]
            assert float(a["step"]) == float(b["step"]) == 2.0
            for k in ("exp_avg", "exp_avg_sq"):
                assert float((a[k] - b[k]).norm()) <= 1e-2 * float(b[k].norm()), k


@pytest.mark.parametrize("variant", ["per_forward", "single_pass_d"])
def test_one_step_lockstep_variants(variant, monkeypatch):
    if variant == "single_pass_d":
        # read at trace time by the JAX recipe and at call time by the port
        monkeypatch.setenv("TFCGAN_SINGLE_PASS_D", "1")
        cfg = _cfg(64, 2)
    else:
        cfg = _cfg(64, 2, spectral_cadence="per_forward")
    jax_state, port_state, jax_hist, port_hist = _lockstep(cfg, 1)
    np.testing.assert_allclose(port_hist, jax_hist, rtol=3e-3, atol=1e-4)
    if variant == "per_forward":
        # u/v advanced 4 times in the "uv" order on both sides
        want = discriminator_from_flax(jax_state.d_params["D"], jax_state.spectral["D"])
        for i, block in enumerate(port_state.D.blocks()):
            np.testing.assert_allclose(block.u.numpy(), want[f"block{i}_conv.u"].numpy(),
                                       rtol=1e-3, atol=1e-5)


@pytest.mark.slow
def test_four_step_lockstep_at_128():
    cfg = _cfg(128, 4)
    _, _, jax_hist, port_hist = _lockstep(cfg, 4)
    np.testing.assert_allclose(port_hist, jax_hist, rtol=3e-3, atol=1e-4)


def test_fit_with_its_own_draws_and_dropout():
    cfg = _cfg(64, 2)
    cfg = cfg.replace(extra={})  # dropout on: G draws its keep-masks
    recipe = build_recipe(cfg, "cpu")
    assert recipe.G.training and not recipe.deterministic_g

    class Log:
        rows = []

        def write(self, row):
            self.rows.append(row)

    trainer = Trainer(cfg, recipe, logger=Log())
    state = trainer.init_state(seed=3)
    draws = recipe.draw(torch.Generator().manual_seed(0), _batches(cfg, 1)[0])
    assert set(draws.dropout_masks) == {"down3", "down4", "up2", "up3"}
    assert sorted(draws.jitter_order) == [0, 1, 2, 3]
    state = trainer.fit(state, _batches(cfg, 3), num_steps=3, log_every=1, check_finite=True)
    assert state.step == 3 and [r["step"] for r in Log.rows] == [1, 2, 3]
    losses = [r["loss_G"] for r in Log.rows]
    assert all(np.isfinite(r[k]) for r in Log.rows for k in TERMS)
    assert len(set(losses)) == 3
