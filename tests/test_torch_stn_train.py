"""The port's STN slice (stn_newmodel3 and its variants: train step and serve
path) against the JAX package's, float32 on the CPU at 64², batch 2, with a
small ViT (depth 2, dim 96, 4 heads, MLP 192).

The JAX state is built from numpy draws (conv kernels normal(0, 0.02),
LayerNorm scales near 1, the STN's dense kernels normal(0, 0.05), a small
non-zero ``fc4`` so that the warp is not the identity and the resampler's
gradients matter; spectral u/v after 5 power iterations) and carried into the
port by ``bridge.train_state_from_flax``. G dropout is off
(``deterministic_g``) except in the keep-mask test, where one set of numpy
masks is injected into both packages: into flax by replacing ``nn.Dropout``'s
call (12 calls a step, in the order of the forward), into the port as its
``STNStepDraws``.

Tolerances: at fixed weights every loss term rtol 1e-4, and every gradient
tensor within 2e-3 of the JAX one in L2 norm, each element within 2e-2 x the
tensor's max|g|. These are float32 gradients through three U-Net passes, two
PatchGANs and the warp, and a leaky-ReLU input within rounding of 0 on one
side only changes that pixel's slope by the factor 5 (ROADMAP Queue 3): D's
weights here are the random normal(0, 0.02) draw with zero biases, so a few
inputs lie there, and one such pixel moved one element of a D2 bias gradient
by 0.8 % of the tensor's max and 172 of 524288 elements of a kernel's by
0.45 %. The norm bounds what such single pixels can do; a wrong layout or a
dropped term is off by O(1). Over whole
steps the loss terms rtol 3e-3 / atol 1e-4, as for fft_glo; served images
atol 5e-4 (G's 2e-4 through the chain G2 -> STN -> warp -> G2).
"""

import dataclasses
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.train.state import GANTrainState, make_optimizers as jax_make_optimizers
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import (load_stn_generators_npz, stn_discriminators_from_flax,
                                     stn_generators_from_flax, train_state_from_flax)
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.stn import STNStepDraws, build_generators
from tfcgan_tpu_torch.train.trainer import Trainer, _frozen, make_train_step

VIT = dict(vit_depth=2, vit_dim=96, vit_heads=4, vit_mlp=192)
TERMS = {"stn_newmodel3": ("g_adv", "g_recon", "g_lpips", "g_morph", "loss_G", "theta_t",
                           "loss_D", "d1", "d2"),
         "stn_dark_visible": ("g_adv", "g_recon", "g_lpips", "g_fft", "loss_G", "theta_t",
                              "loss_D", "d1", "d2"),
         "stn_b2a": ("g_adv", "g_recon", "g_lpips", "g_fft", "loss_G", "theta_t",
                     "loss_D", "d1", "d2")}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name="stn_newmodel3", size=64, batch=2, **extra):
    cfg = get_experiment(name)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={**cfg.extra, "deterministic_g": True, **VIT, **extra})


def _jax_state(cfg, seed=0):
    """A JAX GANTrainState at step 0 from numpy draws (no flax init run)."""
    recipe = jax_build_recipe(cfg)
    assert recipe.perceptual == "msrecon"  # no converted LPIPS weights here
    key = jax.random.PRNGKey(seed)
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size)
    shapes = jax.eval_shape(recipe.init, key, batch)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if "fc4" in name:
            return (0.004 * rng.randn(*s.shape)).astype(np.float32)
        if "bias" in name:
            return np.zeros(s.shape, np.float32)
        if "STN" in name:
            return (0.05 * rng.randn(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) * 0.02).astype(np.float32)

    def unit(s):
        v = rng.randn(*s.shape)
        return (v / np.linalg.norm(v)).astype(np.float32)

    g_params = jax.tree_util.tree_map_with_path(draw, shapes["g_params"])
    d_params = jax.tree_util.tree_map_with_path(draw, shapes["d_params"])
    spectral = jax.tree.map(unit, shapes["spectral"])
    for _ in range(5):
        spectral = jax_power_iteration(d_params, spectral)
    g_tx, d_tx = jax_make_optimizers(cfg)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.split(key)[1],
                          g_params=g_params, d_params=d_params,
                          spectral=jax.device_get(spectral), frozen={},
                          g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init(d_params))
    return recipe, state


def _batches(cfg, steps):
    return [synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=s)
            for s in range(steps)]


def _no_draws(state, batch):
    return STNStepDraws(None, None, None)


def _jax_losses(recipe, state, batch, with_grads=True):
    """The JAX step's terms (and gradients) at the state's weights."""
    g_rng, d_rng = jax.random.split(jax.random.fold_in(state.rng, 0))
    spectral = jax_power_iteration(state.d_params, state.spectral)
    (_, (aux, g_metrics)), g_grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, spectral, state.frozen, batch, g_rng)
    (_, d_metrics), d_grads = jax.jit(jax.value_and_grad(recipe.d_loss, has_aux=True))(
        state.d_params, spectral, aux, batch, d_rng)
    return {**g_metrics, **d_metrics}, g_grads, d_grads, aux


def _port_losses(port_recipe, batch, draws):
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k in ("A", "B")}
    for p in [*port_recipe.G.parameters(), *port_recipe.D.parameters()]:
        p.grad = None
    spectral_power_iteration(port_recipe.D, order="vu")
    with _frozen(port_recipe.D):
        loss_g, aux, got = port_recipe.g_loss(tb, draws)
        loss_g.backward()
    assert all(p.grad is None for p in port_recipe.D.parameters())
    loss_d, d_got = port_recipe.d_loss(tb, aux)
    loss_d.backward()
    return {**got, **d_got}, aux


def _assert_terms(got, want, terms):
    assert set(got) == set(want) == set(terms)
    for k in terms:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def _assert_grads(port_recipe, g_grads, d_grads):
    for module, grads in ((port_recipe.G, stn_generators_from_flax(g_grads)),
                          (port_recipe.D, stn_discriminators_from_flax(d_grads))):
        for name, p in module.named_parameters():
            w, g = grads[name].numpy(), p.grad.numpy()
            if name.endswith("attn.key.bias"):  # exactly zero: rounding noise on both sides
                continue
            assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w) + 1e-7, name
            np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max() + 1e-7, err_msg=name)


@pytest.mark.parametrize("fast_warp", [True, False])
def test_newmodel3_losses_and_gradients_at_fixed_weights(fast_warp):
    cfg = _cfg(fast_warp=fast_warp)
    recipe, state = _jax_state(cfg)
    port_recipe = build_recipe(cfg, "cpu")
    assert port_recipe.perceptual == "msrecon" and port_recipe.lpips is None
    assert port_recipe.STN.fast_warp is fast_warp
    train_state_from_flax(state, port_recipe, torch.Generator())
    batch = _batches(cfg, 1)[0]
    want, g_grads, d_grads, _ = _jax_losses(recipe, state, batch)
    assert float(want["theta_t"]) > 1e-3  # the warp is not the identity
    got, _ = _port_losses(port_recipe, batch, STNStepDraws(None, None, None))
    _assert_terms(got, want, TERMS["stn_newmodel3"])
    _assert_grads(port_recipe, g_grads, d_grads)


@pytest.mark.parametrize("name", ["stn_dark_visible", "stn_b2a"])
def test_variant_loss_terms(name):
    cfg = _cfg(name)
    recipe, state = _jax_state(cfg)
    port_recipe = build_recipe(cfg, "cpu")
    assert port_recipe.variant == cfg.extra["variant"]
    assert port_recipe.STN.vit.patch_embed.kernel_size == \
        ((16, 16) if name == "stn_dark_visible" else (64, 64))
    train_state_from_flax(state, port_recipe, torch.Generator())
    batch = _batches(cfg, 1)[0]
    want, _, _, _ = _jax_losses(recipe, state, batch)
    got, _ = _port_losses(port_recipe, batch, STNStepDraws(None, None, None))
    _assert_terms(got, want, TERMS[name])


def test_injected_keep_masks_reach_the_three_generator_passes(monkeypatch):
    """Dropout on: one set of numpy keep-masks goes into flax's 12 Dropout
    calls of a step and into the port's STNStepDraws."""
    cfg = _cfg()
    cfg = cfg.replace(extra={k: v for k, v in cfg.extra.items() if k != "deterministic_g"})
    recipe, state = _jax_state(cfg)
    port_recipe = build_recipe(cfg, "cpu")
    assert port_recipe.G1.training and not port_recipe.deterministic_g
    train_state_from_flax(state, port_recipe, torch.Generator())
    batch = _batches(cfg, 1)[0]

    shapes = port_recipe.G1.dropout_shapes(2, 64, 64)
    order = ("down3", "down4", "up2", "up3")  # the U-Net's dropout calls, in forward order
    rng = np.random.RandomState(9)
    sets = [{k: ((rng.rand(*shapes[k]) < 0.5) * 2.0).astype(np.float32) for k in order}
            for _ in range(3)]
    queue = [s[k] for s in sets for k in order]

    def injected(self, inputs, deterministic=None, rng=None):
        mask = queue.pop(0)
        assert mask.shape == inputs.shape
        return inputs * mask

    monkeypatch.setattr(nn.Dropout, "__call__", injected)
    want, _, _, _ = _jax_losses(recipe, state, batch)
    assert not queue  # all 12 consumed, in order
    draws = STNStepDraws(*({k: torch.from_numpy(v) for k, v in s.items()} for s in sets))
    got, _ = _port_losses(port_recipe, batch, draws)
    _assert_terms(got, want, TERMS["stn_newmodel3"])

    own = port_recipe.draw(torch.Generator().manual_seed(0), batch)
    assert all(set(m) == set(order) for m in (own.g1_a, own.g2_b, own.g2_warped))
    assert not torch.equal(own.g2_b["down3"], own.g2_warped["down3"])
    with pytest.raises(ValueError, match="needs dropout_masks"):
        port_recipe.g_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                           STNStepDraws(None, None, None))


def _lockstep(cfg, steps):
    recipe, state = _jax_state(cfg)
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    port_recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, port_recipe, torch.Generator())
    trainer = Trainer(cfg, port_recipe, draw_fn=_no_draws)
    state = place_state(state, jax_trainer.mesh)
    step_fn = jax_trainer.compiled_step()
    terms = TERMS[cfg.name]
    jax_hist, port_hist = [], []
    for batch in _batches(cfg, steps):
        state, m = step_fn(state, shard_batch(batch, jax_trainer.mesh))
        jax_hist.append([float(m[k]) for k in terms])
        mp = trainer.step(port_state, batch)
        port_hist.append([float(mp[k]) for k in terms])
    return state, port_state, np.asarray(jax_hist), np.asarray(port_hist)


def test_two_step_lockstep_with_the_jax_trainer():
    cfg = _cfg()
    jax_state, port_state, jax_hist, port_hist = _lockstep(cfg, 2)
    np.testing.assert_allclose(port_hist, jax_hist, rtol=3e-3, atol=1e-4)
    assert port_state.step == int(jax_state.step) == 2
    assert jax_hist[0, 5] > 1e-3 and jax_hist[1, 5] != jax_hist[0, 5]  # theta_t moves
    # the STN's weights moved together: the zero-safe fc4 after two Adam steps
    want = stn_generators_from_flax(jax.device_get(jax_state.g_params))
    for name in ("STN.fc4.weight", "STN.vit.pos_embed", "G2.down1.conv.weight"):
        got = dict(port_state.G.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=5e-5, err_msg=name)
    # the bridge carries both Adams' moments of the containers
    bridged = train_state_from_flax(jax_state, build_recipe(cfg, "cpu"), torch.Generator())
    assert bridged.step == 2
    for opt, ref in ((bridged.opt_g, port_state.opt_g), (bridged.opt_d, port_state.opt_d)):
        for p, q in zip(opt.param_groups[0]["params"], ref.param_groups[0]["params"]):
            a, b = opt.state[p], ref.state[q]
            assert float(a["step"]) == float(b["step"]) == 2.0
            # (+1e-8: the key biases' moments are rounding noise of 1e-9)
            assert float((a["exp_avg"] - b["exp_avg"]).norm()) <= \
                2e-2 * float(b["exp_avg"].norm()) + 1e-8


@pytest.mark.slow
def test_four_step_lockstep_at_128():
    cfg = _cfg(size=128, batch=2)
    _, _, jax_hist, port_hist = _lockstep(cfg, 4)
    np.testing.assert_allclose(port_hist[:2], jax_hist[:2], rtol=3e-3, atol=1e-4)
    # from the third step on, the window of tests/test_parity_stn.py: Adam
    # divides the STN's small early gradients by their own size, so float32
    # noise in them moves theta by a few percent within three steps (theta_t
    # is off by 2 % at steps 3 and 4, every other term by less than 0.3 %)
    np.testing.assert_allclose(port_hist[2:], jax_hist[2:], rtol=3e-2, atol=1e-3)


def test_trainer_refuses_the_per_forward_cadence_and_owns_two_adams():
    cfg = _cfg(spectral_cadence="per_forward")
    recipe = build_recipe(cfg, "cpu")
    with pytest.raises(ValueError, match="per_forward"):
        make_train_step(cfg, recipe)
    cfg = _cfg()
    recipe = build_recipe(cfg, "cpu")
    state = Trainer(cfg, recipe).init_state(seed=1)
    n_g = sum(1 for _ in recipe.G.parameters())
    assert len(state.opt_g.param_groups[0]["params"]) == n_g
    assert len(state.opt_d.param_groups[0]["params"]) == sum(1 for _ in recipe.D.parameters())
    assert state.opt_g.param_groups[0]["lr"] == 1e-4
    assert set(dict(recipe.G.named_children())) == {"G1", "G2", "STN"}
    assert set(dict(recipe.D.named_children())) == {"D1", "D2"}
    assert not recipe.STN.fc4.weight.any()  # identity init survives recipe.init


def test_fit_with_its_own_draws_and_dropout():
    cfg = _cfg()
    cfg = cfg.replace(extra={k: v for k, v in cfg.extra.items() if k != "deterministic_g"})
    recipe = build_recipe(cfg, "cpu")

    class Log:
        rows = []

        def write(self, row):
            self.rows.append(row)

    trainer = Trainer(cfg, recipe, logger=Log())
    state = trainer.init_state(seed=3)
    state = trainer.fit(state, _batches(cfg, 3), num_steps=3, log_every=1, check_finite=True)
    assert state.step == 3 and [r["step"] for r in Log.rows] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in Log.rows for k in TERMS["stn_newmodel3"])
    assert len({r["loss_G"] for r in Log.rows}) == 3
    assert Log.rows[0]["theta_t"] == 0.0 and Log.rows[2]["theta_t"] > 0.0


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["test", "--config", "stn_newmodel3", "--init-seed", "0",
                  "--data-root", str(tmp_path)])
    # build_recipe puts the modules on cuda unless told otherwise
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
        build_recipe(_cfg())


# ----------------------------------------------------------------- serve
def _read(path):
    return np.asarray(Image.open(path)).astype(int)


def test_serve_path_matches_jax_and_writes_the_six_image_stack(tmp_path):
    cfg = _cfg()
    recipe, state = _jax_state(cfg)
    jax_inf = JaxInferencer(cfg, recipe, state.g_params)
    nets = build_generators(cfg, "cpu")
    assert not nets.training
    nets.load_state_dict(stn_generators_from_flax(state.g_params))
    inf = Inferencer(cfg, nets)
    batch = synthetic_batch(batch_size=2, image_size=64, seed=1)
    got, want = inf(batch), jax_inf(batch)
    assert set(got) == set(want) == {"fake_B", "fake_A1", "warped_B", "fake_A2"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, err_msg=k)

    assert inf.run_test_set([batch], str(tmp_path / "port")) == 2
    assert jax_inf.run_test_set([batch], str(tmp_path / "jax")) == 2
    for name in ("00000.png", "00001.png"):
        a, b = _read(tmp_path / "port" / name), _read(tmp_path / "jax" / name)
        assert a.shape == b.shape == (6 * 64, 64, 3)
        assert np.abs(a - b).max() <= 1, name


def test_cli_test_serves_the_stn_recipe(tmp_path):
    cfg = _cfg()
    _, state = _jax_state(cfg)
    npz = str(tmp_path / "g_params.npz")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_g_params", os.path.join(REPO, "tools", "export_g_params.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.save_g_params(state.g_params, npz)
    loaded = load_stn_generators_npz(npz)
    want = stn_generators_from_flax(state.g_params)
    assert set(loaded) == set(want)
    assert all(torch.equal(loaded[k], want[k]) for k in want)

    # the CLI builds ViT-Base (no vit_* flags): serve it from a seed at 64²
    rng = np.random.RandomState(11)
    os.makedirs(tmp_path / "data" / "test")
    for i in range(2):
        img = (rng.rand(64, 128, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "data" / "test" / f"{i:03d}.png")
    out = str(tmp_path / "out")
    cli.main(["test", "--config", "stn_newmodel3", "--init-seed", "0", "--device", "cpu",
              "--data-root", str(tmp_path / "data"), "--image-size", "64", "--dtype", "float32",
              "--out-dir", out])
    stacks = sorted(os.listdir(out))
    assert stacks == ["00000.png", "00001.png"]
    stack = _read(os.path.join(out, stacks[0]))
    assert stack.shape == (6 * 64, 64, 3)
    # identity init: warped_B (third image) is real_B (second) to the pixel
    np.testing.assert_array_equal(stack[128:192], stack[64:128])
    crops = str(tmp_path / "crops")
    cli.main(["prep-crop", "--stack-dir", out, "--out-root", crops,
              "--roles", "real_A,real_B,warped_B,fake_A1,fake_A2,fake_B"])
    assert len(os.listdir(crops)) == 6
