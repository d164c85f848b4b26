"""The port's TFC-Diff family against the JAX package's, float32 on the CPU.

Module by module (the schedule, ``timestep_embedding``, ``GroupNorm``,
``ResnetBlock2D``, ``CondUNet``) and as a whole (g_loss and its gradients for
the three variants, a 2-step lockstep against the JAX ``Trainer``, the
ancestral sampler, the bridge, ``cli gen``) on the same numpy inputs and
bridged weights. Weights are numpy draws on the shapes of the JAX init
(LeCun-scaled kernels, live biases and norm scales, so that a wrong mapping of
any of them shows). The step's draws are rebuilt from the JAX key as the JAX
step draws them: ``fold_in(rng, step)`` -> ``split`` -> ``split(g_rng, 3)`` ->
normal noise, ``randint(0, T - 1)`` timesteps; the hybrid variant's dropout
keep-masks are numpy draws injected into flax's ``nn.Dropout``.

Tolerances: the schedule's arrays rtol 2e-6 (betas exact); module outputs rtol =
atol = 1e-4 or tighter; loss terms rtol 1e-4; gradients of the smooth variants within 1e-4
x max|g| of their tensor, of the hybrid variant (ReLU and max-pool kinks in G
and VGG16) within 2e-2 x max|g| and 2e-3 of their L2 norm; the lockstep's
losses rtol 1e-3 (float32 noise through one Adam step).
"""

import dataclasses
import importlib.util
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.models import diffusion as jax_diffusion
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.train.state import GANTrainState, make_optimizers as jax_make_optimizers
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import (cond_unet_from_flax, diffusion_generators_from_flax,
                                     load_diffusion_generators_npz, train_state_from_flax)
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.evaluation.suite import save_image_grid
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.models import diffusion
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.diffusion import (DiffusionStepDraws, build_generators,
                                                diffusion_sample)
from tfcgan_tpu_torch.train.trainer import Trainer

EXPERIMENTS = {"condA": "tfc_diff", "label": "tfc_diff_label", "hybrid": "tfc_diff_hybrid"}
TERMS = {"condA": ("g_noise_mse", "loss_G", "loss_D"),
         "label": ("g_noise_mse", "loss_G", "loss_D"),
         "hybrid": ("g_recon", "g_noise_mse", "loss_G", "loss_D")}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"condA": 32, "label": 32, "hybrid": 64}  # the hybrid's G has 6 downsamples


def _cfg(variant="condA", batch=2, **extra):
    cfg = get_experiment(EXPERIMENTS[variant])
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=batch, image_size=SIZES[variant]),
        train=dataclasses.replace(cfg.train, compute_dtype="float32"),
        extra={**cfg.extra, **extra})


def _draw_tree(shapes, seed):
    """Numpy weights on a tree of shapes: kernels LeCun-scaled (VGG16's and the
    U-Nets' alike), biases normal(0, 0.1), norm scales around 1, LPIPS lin
    weights uniform(0, 0.1), the class embedding normal(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "lin" in name and "lpips" in name:
            return rng.uniform(0, 0.1, s.shape).astype(np.float32)
        if "class_emb" in name:
            return (0.02 * rng.randn(*s.shape)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if "bias" in name:
            if "'G'" in name or "lpips" in name:
                return np.zeros(s.shape, np.float32)
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        if "'G'" in name:
            return (0.02 * rng.randn(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_state(cfg, seed=0):
    """A JAX GANTrainState at step 0 from numpy draws: no D, one Adam."""
    recipe = jax_build_recipe(cfg)
    key = jax.random.PRNGKey(seed)
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size, with_labels=True)
    shapes = jax.eval_shape(recipe.init, key, batch)
    assert shapes["d_params"] == {} and shapes["spectral"] == {}
    g_params = _draw_tree(shapes["g_params"], seed)
    frozen = _draw_tree({"lpips": shapes["frozen"]["lpips"]}, seed + 1) \
        if shapes["frozen"] else {}
    g_tx, d_tx = jax_make_optimizers(cfg)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.split(key)[1],
                          g_params=g_params, d_params={}, spectral={}, frozen=frozen,
                          g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init({}))
    return recipe, state


def _batches(cfg, steps):
    return [synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=s, with_labels=True)
            for s in range(steps)]


def jax_step_draws(rng, step, shape, timesteps, masks=None) -> DiffusionStepDraws:
    """The noise and timesteps of the JAX step ``step`` for a target of ``shape``."""
    g_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    k_noise, k_t, _ = jax.random.split(g_rng, 3)
    noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    t = np.array(jax.random.randint(k_t, (shape[0],), 0, timesteps - 1))
    return DiffusionStepDraws(torch.from_numpy(noise), torch.from_numpy(t).long(), masks)


def _tensors(batch):
    return {"A": torch.from_numpy(batch["A"]), "B": torch.from_numpy(batch["B"]),
            "LAB": torch.from_numpy(batch["LAB"]).long()}


# ------------------------------------------------------------------ schedule
@pytest.mark.parametrize("timesteps", [20, 500, 1000])
def test_schedule_arrays(timesteps):
    want, got = jax_diffusion.DDPMSchedule(timesteps), diffusion.DDPMSchedule(timesteps)
    assert got.betas().dtype == got.alphas_cumprod().dtype == np.float32
    np.testing.assert_array_equal(got.betas(), np.asarray(want.betas()))
    # the port's product is the sequential float32 one, bit for bit
    ref, acc = [], np.float32(1.0)
    for beta in got.betas():
        acc = acc * (np.float32(1.0) - beta)
        ref.append(acc)
    assert acc.dtype == np.float32
    np.testing.assert_array_equal(got.alphas_cumprod(), np.asarray(ref))
    # XLA's cumprod is a parallel float32 scan: equal over the first 18
    # entries, then up to 1.52e-6 relative apart (T = 500, entry 446): rtol 2e-6
    abar, abar_jax = got.alphas_cumprod(), np.asarray(want.alphas_cumprod())
    np.testing.assert_array_equal(abar[:18], abar_jax[:18])
    np.testing.assert_allclose(abar, abar_jax, rtol=2e-6, atol=0)
    # ``step`` divides by 1 - abar, which is 4e-5 at t = 0: held too (measured
    # 3.7e-5 at entry 18 of T = 1000, one ulp of abar)
    np.testing.assert_allclose(1.0 - abar, 1.0 - abar_jax, rtol=5e-5, atol=0)
    assert got.betas().max() == np.float32(0.999)  # the cap is reached at the last step


@pytest.mark.parametrize("timesteps", [500, 1000])
def test_schedule_product_is_the_closest(timesteps):
    """Why the product is sequential float32 and not a float64 product rounded
    per entry (diffusers' ``torch.cumprod`` on the host): against the JAX
    arrays the two are alike in abar (both inside 2e-6), but in 1 - abar,
    which the ancestral step divides by, the float64 one is several times
    further (1.9e-4 and 2.6e-4 against 2.2e-5 and 3.7e-5)."""
    want = np.asarray(jax_diffusion.DDPMSchedule(timesteps).alphas_cumprod())
    sched = diffusion.DDPMSchedule(timesteps)
    alphas = np.float32(1.0) - sched.betas()
    rounded = np.cumprod(alphas.astype(np.float64)).astype(np.float32)

    def gap(abar):
        return float(np.max(np.abs((1.0 - abar) - (1.0 - want)) / (1.0 - want)))

    assert float(np.max(np.abs(rounded - want) / want)) < 2e-6
    assert gap(sched.alphas_cumprod()) < 5e-5 < 1.5e-4 < gap(rounded)


@pytest.mark.parametrize("timesteps", [500, 1000])
def test_schedule_chain_end(timesteps):
    """The whole ancestral chain of the two schedules with a stand-in denoiser
    (eps = tanh(x_t)) and the JAX steps' own noise: what the difference of the
    abar arrays comes to at the end of the chain. Measured 1.3e-5 (T = 500) and
    3.8e-5 (T = 1000) at max|x_0| = 1; with the JAX arrays handed to the port's
    ``step`` it is 1.1e-6 and 1.4e-6, with a float64 product 1.3e-4 and 1.9e-4."""
    ref, sched = jax_diffusion.DDPMSchedule(timesteps), diffusion.DDPMSchedule(timesteps)
    base = jax.random.PRNGKey(timesteps)
    x = np.array(jax.random.normal(base, (2, 8, 8, 1), jnp.float32))
    jax_step = jax.jit(lambda x, t, k: ref.step(jnp.tanh(x), t, x, k))
    want, got = jnp.asarray(x), torch.from_numpy(x)
    for t in range(timesteps - 1, -1, -1):
        key = jax.random.fold_in(base, t)
        noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
        want, got = jax_step(want, t, key), sched.step(torch.tanh(got), t, got, noise)
    assert 0.9 < float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_add_noise():
    rng = np.random.RandomState(0)
    x0, noise = (rng.randn(5, 8, 8, 1).astype(np.float32) for _ in range(2))
    t = np.array([0, 1, 250, 498, 499])
    want = jax_diffusion.DDPMSchedule(500).add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                                     jnp.asarray(t))
    got = diffusion.DDPMSchedule(500).add_noise(torch.from_numpy(x0), torch.from_numpy(noise),
                                                torch.from_numpy(t))
    # abar differs by up to 1.52e-6 relative (see above); where the two terms
    # cancel the sum is held by atol, at |x_t| up to 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("t", [499, 498, 250, 1, 0])
def test_ancestral_step(t, clip):
    """x_t -> x_{t-1} with the JAX step's own noise. At t = 499, 1 / sqrt(abar)
    is about 160 without the clip, hence the relative window."""
    rng = np.random.RandomState(t)
    eps, x = (rng.randn(2, 8, 8, 1).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(t)
    want = jax_diffusion.DDPMSchedule(500).step(jnp.asarray(eps), t, jnp.asarray(x), key,
                                                clip_sample=clip)
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    got = diffusion.DDPMSchedule(500).step(torch.from_numpy(eps), t, torch.from_numpy(x), noise,
                                           clip_sample=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6 * float(np.abs(np.asarray(want)).max()))
    if t == 0:  # no noise is added at the last step, and x_0 is clipped
        again = diffusion.DDPMSchedule(500).step(torch.from_numpy(eps), 0, torch.from_numpy(x),
                                                 None, clip_sample=clip)
        assert torch.equal(got, again)
        assert not clip or float(got.abs().max()) <= 1.0


def test_timestep_embedding():
    t = np.array([0, 1, 17, 250, 499, 999])
    want = jax_diffusion.timestep_embedding(jnp.asarray(t), 32)
    got = diffusion.timestep_embedding(torch.from_numpy(t), 32)
    # cos and sin of arguments up to 999 in float32: 1e-4 of an argument's ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert got.shape == (6, 32) and float(got[0, :16].min()) == 1.0  # [cos, sin]


# ------------------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [32, 64])
def test_group_norm(channels, dtype):
    rng = np.random.RandomState(channels)
    x = (3.0 + 2.0 * rng.randn(2, 6, 5, channels)).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.randn(channels)).astype(np.float32),
              "bias": (0.1 * rng.randn(channels)).astype(np.float32)}
    jt, tt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                         torch.float32)
    want = nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jt).apply(
        {"params": params}, jnp.asarray(x).astype(jt))
    m = diffusion.GroupNorm(channels, 32, dtype=tt)
    m.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                       "bias": torch.from_numpy(params["bias"])})
    got = m(torch.from_numpy(x).to(tt))
    assert got.dtype == tt
    tol = 1e-5 if dtype == "float32" else 1.6e-2  # two bf16 ulp at |y| <= 4
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("in_channels,feats", [(32, 32), (32, 64), (128, 64)])
def test_resnet_block(in_channels, feats):
    rng = np.random.RandomState(feats)
    x = rng.randn(2, 8, 8, in_channels).astype(np.float32)
    temb = rng.randn(2, 128).astype(np.float32)
    block = jax_diffusion.ResnetBlock2D(feats)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(temb))["params"]
    params = _draw_tree(shapes, in_channels)
    assert ("conv_shortcut" in params) == (in_channels != feats)
    want = block.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
    port = diffusion.ResnetBlock2D(in_channels, feats, 128)
    port.load_state_dict(cond_unet_from_flax(params))
    got = port(torch.from_numpy(x), torch.from_numpy(temb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _unet_pair(out_channels, cond_channels, seed=0, size=32):
    unet = jax_diffusion.CondUNet(out_channels=out_channels)
    x = jnp.zeros((1, size, size, out_channels))
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, size, size, cond_channels)))["params"]
    params = _draw_tree(shapes, seed)
    port = diffusion.CondUNet(out_channels + cond_channels, out_channels)
    port.load_state_dict(cond_unet_from_flax(params))
    return unet, params, port


@pytest.mark.parametrize("out_channels,cond_channels", [(1, 1), (3, 4)])
def test_cond_unet_forward(out_channels, cond_channels):
    """The whole denoiser at 32² (attention over 256 and 64 tokens): rtol = atol
    = 1e-4."""
    unet, params, port = _unet_pair(out_channels, cond_channels)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 32, out_channels).astype(np.float32)
    cond = rng.randn(2, 32, 32, cond_channels).astype(np.float32)
    t = np.array([3, 499], np.int32)
    want = unet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    assert got.shape == (2, 32, 32, out_channels)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cond_unet_matches_the_jax_flash_path(monkeypatch):
    """The same forward with the JAX blocks on their Pallas kernel (interpret
    mode; 256 tokens at the first attention resolution of a 32² input, the 64
    tokens of the second stay on the XLA path)."""
    monkeypatch.setenv("TFCGAN_FLASH_ATTN", "1")
    unet, params, port = _unet_pair(1, 1, seed=3)
    rng = np.random.RandomState(2)
    x, cond = (rng.randn(1, 32, 32, 1).astype(np.float32) for _ in range(2))
    t = np.array([77], np.int32)
    want = unet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cond_unet_has_seven_attention_blocks_and_flax_init():
    port = diffusion.CondUNet(2, 1, generator=torch.Generator().manual_seed(0))
    blocks = [n for n, m in port.named_modules() if isinstance(m, diffusion.AttentionBlock)]
    assert sorted(blocks) == ["down1_attn0", "down2_attn0", "mid_attn", "up0_attn0",
                              "up0_attn1", "up1_attn0", "up1_attn1"]
    w = port.down1_res0.conv1.weight.detach()
    assert abs(float(w.std()) - (1.0 / (9 * 32)) ** 0.5) < 0.1 * (1.0 / (9 * 32)) ** 0.5
    assert not bool(port.conv_in.bias.any()) and bool((port.conv_norm_out.weight == 1).all())
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(jax.eval_shape(
            jax_diffusion.CondUNet().init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 32, 32, 1)))))


# ----------------------------------------------------------- losses, trainer
def _inject_dropout(monkeypatch, port_recipe, cfg, seed=9):
    """One set of numpy keep-masks into flax's 4 Dropout calls of G's forward;
    returns it for the port's draws."""
    shapes = port_recipe.G.G.dropout_shapes(cfg.data.batch_size, *[cfg.data.image_size] * 2)
    order = ("down3", "down4", "up2", "up3")  # the U-Net's dropout calls, in forward order
    rng = np.random.RandomState(seed)
    masks = {k: ((rng.rand(*shapes[k]) < 0.5) * 2.0).astype(np.float32) for k in order}
    queue = [masks[k] for k in order]

    def injected(self, inputs, deterministic=None, rng=None):
        mask = queue.pop(0)
        assert mask.shape == inputs.shape
        return inputs * mask

    monkeypatch.setattr(nn.Dropout, "__call__", injected)
    return {k: torch.from_numpy(v) for k, v in masks.items()}, queue


@pytest.mark.parametrize("variant", ["condA", "label", "hybrid"])
def test_g_loss_and_gradients_at_fixed_weights(variant, monkeypatch):
    cfg = _cfg(variant)
    recipe, state = _jax_state(cfg)
    port_recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, port_recipe, torch.Generator())
    assert port_state.opt_d is None and not list(port_recipe.D.parameters())
    batch = _batches(cfg, 1)[0]
    masks, queue = (None, [])
    if variant == "hybrid":
        masks, queue = _inject_dropout(monkeypatch, port_recipe, cfg)
    g_rng, d_rng = jax.random.split(jax.random.fold_in(state.rng, 0))
    (_, (aux, g_metrics)), grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, {}, {}, state.frozen, batch, g_rng)
    assert not queue  # every mask consumed
    _, d_metrics = recipe.d_loss({}, {}, aux, batch, d_rng)
    want = {**g_metrics, **d_metrics}

    n, size = cfg.data.batch_size, cfg.data.image_size
    shape = (n, size, size, 1 if variant == "condA" else 3)
    timesteps = 500 if variant == "condA" else 1000
    assert port_recipe.schedule.num_timesteps == timesteps
    draws = jax_step_draws(state.rng, 0, shape, timesteps, masks)
    tb = _tensors(batch)
    loss, port_aux, got = port_recipe.g_loss(tb, draws)
    loss.backward()
    got.update(port_recipe.d_loss(tb, port_aux)[1])
    assert tuple(got) == TERMS[variant] and set(want) == set(got)
    for k in TERMS[variant]:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, err_msg=k)

    ref = diffusion_generators_from_flax(grads)
    assert set(ref) == {name for name, _ in port_recipe.G.named_parameters()}
    for name, p in port_recipe.G.named_parameters():
        w, g = ref[name].numpy(), p.grad.numpy()
        if variant == "hybrid":
            # conv biases in front of an instance norm, exactly zero in exact arithmetic
            assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w) + 1e-6, name
            np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max() + 1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max() + 1e-7, err_msg=name)
    if variant == "hybrid":  # the noise loss is not detached: it reaches G
        recon_only = torch.autograd.grad(
            port_recipe.lpips(port_recipe.G.G(tb["A"], masks), tb["B"]).mean(),
            port_recipe.G.G.final_conv.weight)[0]
        assert not torch.allclose(recon_only, port_recipe.G.G.final_conv.weight.grad, rtol=1e-3)


def _lockstep(cfg, steps):
    recipe, state = _jax_state(cfg)
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    port_recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, port_recipe, torch.Generator())
    jax_rng = np.asarray(state.rng)  # a host copy: the compiled step donates the state
    n, size = cfg.data.batch_size, cfg.data.image_size
    trainer = Trainer(cfg, port_recipe, draw_fn=lambda s, b: jax_step_draws(
        jax_rng, s.step, (n, size, size, 1), port_recipe.schedule.num_timesteps))
    state = place_state(state, jax_trainer.mesh)
    step_fn = jax_trainer.compiled_step()
    jax_hist, port_hist = [], []
    for batch in _batches(cfg, steps):
        state, m = step_fn(state, shard_batch(batch, jax_trainer.mesh))
        jax_hist.append([float(m[k]) for k in TERMS["condA"]])
        mp = trainer.step(port_state, batch)
        port_hist.append([float(mp[k]) for k in TERMS["condA"]])
    return state, port_state, np.asarray(jax_hist), np.asarray(port_hist)


def test_two_step_lockstep_with_the_jax_trainer():
    cfg = _cfg("condA")
    jax_state, port_state, jax_hist, port_hist = _lockstep(cfg, 2)
    np.testing.assert_allclose(port_hist, jax_hist, rtol=1e-3, atol=1e-6)
    assert port_hist[0, 0] != port_hist[1, 0] and (port_hist[:, 2] == 0).all()
    assert port_state.step == int(jax_state.step) == 2
    # the bridge carries the Adam moments: the JAX state's, bridged, sit where
    # the port's own run put them (a wrong layout is off by O(1))
    bridged = train_state_from_flax(jax_state, build_recipe(cfg, "cpu"), torch.Generator())
    assert bridged.step == 2 and bridged.opt_d is None
    moments = [port_state.opt_g.state[q]["exp_avg"].norm() for q in port_state.G.parameters()]
    floor = 1e-5 * float(max(moments))
    skipped = []
    for (name, p), q in zip(bridged.G.named_parameters(), port_state.G.parameters()):
        a, b = bridged.opt_g.state[p], port_state.opt_g.state[q]
        if float(b["exp_avg"].norm()) < floor:
            # a gradient that is exactly zero (the key bias: softmax is
            # shift-invariant; a bias, or the time projection, in front of a
            # GroupNorm of one channel a group): float32 noise that differs on
            # the two sides, and Adam normalises it
            skipped.append(name)
            continue
        assert float(a["step"]) == float(b["step"]) == 2.0
        for k in ("exp_avg", "exp_avg_sq"):
            assert float((a[k] - b[k]).norm()) <= 1e-2 * float(b[k].norm()) + 1e-12, k
        assert float((p - q).norm()) <= 1e-3 * float(q.norm()) + 1e-6
    assert all(n.endswith(("bias", "time_emb_proj.weight")) for n in skipped), skipped
    assert len(skipped) < 20


@pytest.mark.slow
def test_four_step_lockstep_at_128():
    cfg = _cfg("condA")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=128))
    _, _, jax_hist, port_hist = _lockstep(cfg, 4)
    np.testing.assert_allclose(port_hist, jax_hist, rtol=3e-3, atol=1e-6)


@pytest.mark.parametrize("variant", ["condA", "label", "hybrid"])
def test_fit_with_its_own_draws_and_no_discriminator(variant):
    cfg = _cfg(variant, timesteps=3)
    recipe = build_recipe(cfg, "cpu")

    class Log:
        rows = []

        def write(self, row):
            self.rows.append(row)

    Log.rows = []
    trainer = Trainer(cfg, recipe, logger=Log())
    state = trainer.init_state(seed=3)
    assert state.opt_d is None and len(state.opt_g.param_groups[0]["params"]) == len(
        list(recipe.G.parameters()))
    gen = torch.Generator().manual_seed(0)
    batch = _tensors(_batches(cfg, 1)[0])
    ts = torch.cat([recipe.draw(gen, batch).t for _ in range(40)])
    assert set(ts.tolist()) == {0, 1}  # uniform on [0, T - 2]: never T - 1
    draws = recipe.draw(gen, batch)
    assert draws.noise.shape == (2, SIZES[variant], SIZES[variant], 1 if variant == "condA" else 3)
    assert (draws.dropout_masks is not None) == (variant == "hybrid")
    trainer.fit(state, _batches(cfg, 3), num_steps=3, log_every=1, check_finite=True)
    assert state.step == 3 and [r["step"] for r in Log.rows] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in Log.rows for k in TERMS[variant])
    assert len({r["g_noise_mse"] for r in Log.rows}) == 3
    assert all(r["loss_D"] == 0.0 for r in Log.rows)


# ------------------------------------------------------------------- sampler
@pytest.mark.parametrize("variant", ["condA", "label"])
def test_four_step_sampler_with_the_jax_noise(variant):
    """``sample`` over a 4-timestep chain against the JAX ``fori_loop`` with
    its own draws (``k0, kloop = split(key)``; per step ``k, ks = split(k)``):
    atol 3e-4 on images in [-1, 1] (a 4-step schedule ends at abar = 2e-5, so
    the first step divides by sqrt(abar) = 5e-3 before it clips, and whatever
    the two U-Nets differ by passes through three more of them)."""
    cfg = _cfg(variant, timesteps=4)
    recipe, state = _jax_state(cfg, seed=2)
    batch = _batches(cfg, 1)[0]
    key = jax.random.PRNGKey(5)
    want = np.asarray(recipe.sample(state.g_params, batch, key))
    shape = want.shape
    k0, k = jax.random.split(key)
    noise = [jax.random.normal(k0, shape)]
    for _ in range(4):
        k, ks = jax.random.split(k)
        noise.append(jax.random.normal(ks, shape, jnp.float32))
    nets = build_generators(cfg, "cpu")
    nets.load_state_dict(diffusion_generators_from_flax(state.g_params))
    got = diffusion_sample(nets, diffusion.DDPMSchedule(4), _tensors(batch),
                           noise=torch.from_numpy(np.stack([np.asarray(z) for z in noise])))
    assert got.shape == shape == (2, 32, 32, 1 if variant == "condA" else 3)
    assert float(got.abs().max()) <= 1.0  # the last step clips x_0 and adds no noise
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4)


def test_sampler_draws_from_a_generator_and_checks_its_noise():
    cfg = _cfg("condA", timesteps=3)
    nets = build_generators(cfg, "cpu", torch.Generator().manual_seed(1))
    batch = _tensors(_batches(cfg, 1)[0])
    schedule = diffusion.DDPMSchedule(3)
    a = diffusion_sample(nets, schedule, batch, torch.Generator().manual_seed(4))
    b = diffusion_sample(nets, schedule, batch, torch.Generator().manual_seed(4))
    c = diffusion_sample(nets, schedule, batch, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c) and not a.requires_grad
    with pytest.raises(ValueError, match="noise must be"):
        diffusion_sample(nets, schedule, batch, noise=torch.zeros(3, 2, 32, 32, 1))
    inf = Inferencer(cfg, nets)
    assert torch.equal(inf({"A": batch["A"].numpy()}, seed=4), a)


# ---------------------------------------------------------------- bridge, CLI
@pytest.mark.parametrize("variant", ["condA", "label", "hybrid"])
def test_npz_round_trip(variant, tmp_path):
    """``tools/export_g_params.py``'s file -> the port's state dict."""
    spec = importlib.util.spec_from_file_location(
        "export_g_params", os.path.join(REPO, "tools", "export_g_params.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg = _cfg(variant)
    _, state = _jax_state(cfg, seed=4)
    path = str(tmp_path / "g_params.npz")
    tool.save_g_params(state.g_params, path)
    loaded = load_diffusion_generators_npz(path)
    nets = build_generators(cfg, "cpu")
    nets.load_state_dict(loaded)  # strict: every key, every shape
    direct = diffusion_generators_from_flax(state.g_params)
    assert set(loaded) == set(direct)
    assert all(torch.equal(loaded[k], direct[k]) for k in direct)
    assert ("class_emb" in loaded) == (variant != "condA")
    assert any(k.startswith("G.") for k in loaded) == (variant == "hybrid")


def test_cli_gen_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``cli gen --device cpu`` over 3 A|B pairs at 32², batch 2, the chain cut
    to 6 timesteps through the experiment's ``extra``: real_A | sample stacks."""
    from PIL import Image

    from tfcgan_tpu_torch import config

    pairs = synthetic_batch(batch_size=3, image_size=32, seed=1)
    for i in range(3):
        save_image_grid([pairs["A"][i], pairs["B"][i]],
                        str(tmp_path / "data" / "test" / f"{i:03d}.png"), axis=1)
    cfg = config.get_experiment("tfc_diff")
    monkeypatch.setitem(config.EXPERIMENTS, "tfc_diff",
                        cfg.replace(extra={**cfg.extra, "timesteps": 6}))
    out = tmp_path / "samples"
    cli.main(["gen", "--config", "tfc_diff", "--data-root", str(tmp_path / "data"),
              "--image-size", "32", "--batch-size", "2", "--dtype", "float32", "--init-seed", "0",
              "--seed", "7", "--out-dir", str(out), "--device", "cpu"])
    assert "sampled 3 images" in capsys.readouterr().out
    files = sorted(p.name for p in out.iterdir())
    assert files == ["00000.png", "00001.png", "00002.png"]
    with Image.open(out / files[0]) as img:
        assert img.size == (32, 64)  # real_A over the sample
        top = np.asarray(img.convert("RGB"))[32:]
    assert (top[..., 0] == top[..., 1]).all()  # the gray sample repeated on 3 channels
    with pytest.raises(SystemExit, match="diffusion"):
        cli.main(["gen", "--config", "fft_glo", "--init-seed", "0", "--device", "cpu"])
    with pytest.raises(SystemExit, match="exactly one"):
        cli.main(["gen", "--config", "tfc_diff", "--device", "cpu"])
