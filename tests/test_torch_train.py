"""The port's fft_glo train step against the JAX package's, float32 on the CPU.

The JAX state is built from numpy draws (G and D kernels normal(0, 0.02),
spectral u/v after 5 power iterations, LPIPS lecun-scaled normal convs and
uniform(0, 0.1) lin weights) and carried into the port by
``bridge.train_state_from_flax``. The port's step draws are rebuilt from the
JAX key as the JAX step draws them: ``fold_in(rng, step)`` -> ``split`` ->
``split(g_rng, 5)`` -> ``randint`` (patch negatives) and the ColorJitter
draws of ``ops/color.py``. G dropout is off (``deterministic_g``): flax's
dropout masks are not rebuilt here, and the U-Net blocks' masks are tested
in test_torch_models.py.

Tolerances: (a) at fixed weights every loss term rtol 1e-4 and every
gradient atol 2e-4 x its tensor's max|g|; (b)-(d) over whole steps, loss
terms rtol 3e-3 / atol 1e-4, the early-step window of
test_parity_trajectory.py (float32 noise compounds through the Adam steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_losses import jax_jitter_draws
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.train.state import GANTrainState, make_optimizers as jax_make_optimizers
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.bridge import discriminator_from_flax, generator_from_flax
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.tfcgan import StepDraws
from tfcgan_tpu_torch.train.trainer import Trainer, _frozen

TERMS = ("g_adv", "g_triplet", "g_temp", "g_lpips", "g_fft", "loss_G", "loss_D")


def _cfg(size, batch, **extra):
    cfg = get_experiment("fft_glo")
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={"deterministic_g": True, **extra})


def _jax_state(cfg, seed=0):
    """A JAX GANTrainState at step 0 from numpy draws (no flax init run)."""
    recipe = jax_build_recipe(cfg)
    key = jax.random.PRNGKey(seed)
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size)
    shapes = jax.eval_shape(recipe.init, key, batch)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "lin" in name:
            return rng.uniform(0, 0.1, s.shape).astype(np.float32)
        if "bias" in name:
            return np.zeros(s.shape, np.float32)
        if "lpips" in name:
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (rng.randn(*s.shape) * 0.02).astype(np.float32)

    def unit(s):
        v = rng.randn(*s.shape)
        return (v / np.linalg.norm(v)).astype(np.float32)

    pieces = {k: jax.tree_util.tree_map_with_path(draw, shapes[k])
              for k in ("g_params", "d_params", "frozen")}
    spectral = jax.tree.map(unit, shapes["spectral"])
    for _ in range(5):
        spectral = jax_power_iteration(pieces["d_params"], spectral)
    g_tx, d_tx = jax_make_optimizers(cfg)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.split(key)[1],
                          g_params=pieces["g_params"], d_params=pieces["d_params"],
                          spectral=jax.device_get(spectral), frozen=pieces["frozen"],
                          g_opt_state=g_tx.init(pieces["g_params"]),
                          d_opt_state=d_tx.init(pieces["d_params"]))
    return recipe, state


def jax_step_draws(rng, step: int, grid: int) -> StepDraws:
    """The patch negatives and ColorJitter draws of the JAX step ``step``."""
    g_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, k_patch, k_temp, _, _ = jax.random.split(g_rng, 5)
    neg = np.array(jax.random.randint(k_patch, (grid * grid,), 0, grid * grid))
    factors, order = jax_jitter_draws(k_temp)
    return StepDraws(torch.from_numpy(neg).long(), torch.from_numpy(factors), order, None)


def _batches(cfg, steps):
    return [synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=s)
            for s in range(steps)]


def _lockstep(cfg, steps):
    """``steps`` steps of the JAX Trainer's compiled step and of the port's
    Trainer from one state, on the same batches and draws."""
    recipe, state = _jax_state(cfg)
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    port_recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, port_recipe, torch.Generator())
    jax_rng = np.asarray(state.rng)  # a host copy: the compiled step donates the state
    trainer = Trainer(cfg, port_recipe, draw_fn=lambda s, b: jax_step_draws(
        jax_rng, s.step, cfg.loss.patch_grid))
    state = place_state(state, jax_trainer.mesh)
    step_fn = jax_trainer.compiled_step()
    jax_hist, port_hist = [], []
    for batch in _batches(cfg, steps):
        state, m = step_fn(state, shard_batch(batch, jax_trainer.mesh))
        jax_hist.append([float(m[k]) for k in TERMS])
        mp = trainer.step(port_state, batch)
        port_hist.append([float(mp[k]) for k in TERMS])
    return state, port_state, np.asarray(jax_hist), np.asarray(port_hist)


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
