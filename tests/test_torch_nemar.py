"""The port's NeMAR slice (modules, losses, the D-first train step, the lr
schedules, the serve path) against the JAX package's, float32 on the CPU.

Weights are numpy draws carried into both packages: conv kernels normal(0,
0.02), Dense kernels normal(0, 0.05), biases normal(0, 0.01), and normal(0,
0.1) in the deformable STN, whose deep ResUnet has no norm and would otherwise
let its activations die (a large bias in front of an instance norm only costs
the signal its float32 digits). The
deformable STN's zero-initialised offset head gets a random kernel and a bias
of a few tenths of a pixel: at zero offsets every sample sits on an integer
coordinate, where the coordinate gradient is one-sided and one ulp decides
the side (``tests/test_torch_gridsample.py`` holds that case on its own);
here the samples are kept off the integers so that the comparison is of the
networks. The JAX warp runs its gather reference on the CPU backend, as the
package's own dispatcher chooses there; the port runs the plain version.

Tolerances: module outputs atol 2e-4 and each module's parameter gradients
2e-4 in L2 norm (2e-3 for the deformable STN: 20 convs, 7 max-pools and the
sampling's one-sided coordinate gradients); at fixed weights every loss term
of the recipe rtol 1e-4; the recipe's gradients as
``test_losses_and_gradients_at_fixed_weights`` states and explains.
``multi_resolution``: the discriminators' inputs are downscaled with an
antialiased triangle filter in both packages (``jax.image.resize`` /
``F.interpolate(antialias=True)``), held to atol 1e-5 on its own and to the
same loss and gradient tolerances. Over whole steps the loss terms rtol 3e-3 /
atol 1e-4; served images atol 5e-4.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.models import discriminator as jax_disc
from tfcgan_tpu.models import resnet_gen as jax_resnet
from tfcgan_tpu.models import stn as jax_stn
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.train.state import GANTrainState, _lr as jax_lr
from tfcgan_tpu.train.state import make_optimizers as jax_make_optimizers
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch import bridge, cli
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.models.discriminator import NLayerDiscriminator, PixelDiscriminator
from tfcgan_tpu_torch.models.resnet_gen import ResNetGenerator
from tfcgan_tpu_torch.models.stn import CNNAffineSTN, DeformableSTN, smoothness_loss
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.nemar import _downscale, build_generators
from tfcgan_tpu_torch.train.state import learning_rate
from tfcgan_tpu_torch.train.trainer import Trainer, _frozen, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G_TERMS = ("loss_G", "g_l1_tr", "g_l1_rt", "g_gan_tr", "g_gan_rt", "g_smooth")
TERMS = (*G_TERMS, "loss_D")


def _draw(rng, path, s, size, bias_std):
    """One parameter from numpy; ``size`` is the image side (the offset bias
    is in pixels of it)."""
    name = jax.tree_util.keystr(path)
    if "offset" in name and "bias" in name:  # (x, y) offsets of 0.3 and -0.2 pixel
        return np.asarray([0.3, -0.2], np.float32) * (2.0 / size)
    if "fc2" in name:  # dtheta stays a few hundredths
        return (0.003 * rng.randn(*s.shape)).astype(np.float32)
    if "bias" in name:
        return (bias_std * rng.randn(*s.shape)).astype(np.float32)
    std = 0.05 if len(s.shape) == 2 else 0.02
    return (std * rng.randn(*s.shape)).astype(np.float32)


def _params_like(shapes, seed, size, bias_std=0.01):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(lambda p, s: _draw(rng, p, s, size, bias_std),
                                            shapes)


def _module_params(module, *inputs, seed=0, bias_std=0.01):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))["params"]
    return _params_like(shapes, seed, inputs[0].shape[1], bias_std)


def _images(n, size, seed, channels=3):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n, size, size, channels)).astype(np.float32)


def _assert_module_grads(net, want_grads, tol=2e-4):
    """Every parameter gradient of ``net`` within ``tol`` of the bridged JAX
    one in L2 norm. A bias in front of an instance norm has no gradient in
    exact arithmetic (rounding noise on both sides) and is only held to be as
    small."""
    for name, p in net.named_parameters():
        w, g = want_grads[name].numpy(), p.grad.numpy()
        if name.endswith("bias") and np.abs(w).max() < 1e-4 * np.abs(
                want_grads[name[:-4] + "weight"].numpy()).max():
            assert np.abs(g).max() < 1e-3 * np.abs(
                want_grads[name[:-4] + "weight"].numpy()).max(), name
            continue
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w) + 1e-9, name


# ---------------------------------------------------------------- modules
def test_resnet_generator_matches_jax():
    x = _images(2, 64, 0)
    jm = jax_resnet.ResNetGenerator(num_blocks=2)
    params = _module_params(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = ResNetGenerator(num_blocks=2)
    net.load_state_dict(bridge.resnet_generator_from_flax(params))
    cot = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    out = net(torch.from_numpy(x))
    got = out.detach().numpy()
    assert got.shape == (2, 64, 64, 3) and np.abs(want).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=2e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * cot))(params)
    _assert_module_grads(net, bridge.resnet_generator_from_flax(grads))


@pytest.mark.parametrize("kind", ["nlayer", "pixel"])
def test_discriminators_match_jax(kind):
    x = _images(2, 64, 1, channels=6)
    if kind == "nlayer":
        jm, net, convert = (jax_disc.NLayerDiscriminator(), NLayerDiscriminator(),
                            bridge.nlayer_discriminator_from_flax)
        shape = (2, 6, 6, 1)
    else:
        jm, net, convert = (jax_disc.PixelDiscriminator(), PixelDiscriminator(),
                            bridge.pixel_discriminator_from_flax)
        shape = (2, 64, 64, 1)
    params = _module_params(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net.load_state_dict(convert(params))
    out = net(torch.from_numpy(x))
    got = out.detach().numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    (out - 1.0).square().mean().backward()  # the least-squares GAN term
    grads = jax.grad(lambda p: jnp.mean(jnp.square(
        jm.apply({"params": p}, jnp.asarray(x)) - 1.0)))(params)
    _assert_module_grads(net, convert(grads))


def test_cnn_affine_stn_matches_jax():
    a, b, extra = _images(2, 64, 2), _images(2, 64, 3), _images(2, 64, 4)
    jm = jax_stn.CNNAffineSTN()
    params = _module_params(jm, jnp.asarray(a), jnp.asarray(b))
    want, want_reg = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b),
                              apply_on=[jnp.asarray(a), jnp.asarray(extra)])
    net = CNNAffineSTN(64)
    net.load_state_dict(bridge.cnn_affine_stn_from_flax(params))
    got, reg = net(torch.from_numpy(a), torch.from_numpy(b),
                   apply_on=[torch.from_numpy(a), torch.from_numpy(extra)])
    assert 1e-3 < float(want_reg) < 0.2  # a warp next to the identity, not on it
    np.testing.assert_allclose(float(reg), float(want_reg), rtol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=2e-4)
    cot = np.random.RandomState(1).randn(*a.shape).astype(np.float32)

    def jax_loss(p):
        (w0, w1), r = jm.apply({"params": p}, jnp.asarray(a), jnp.asarray(b),
                               apply_on=[jnp.asarray(a), jnp.asarray(extra)])
        return jnp.sum((w0 - w1) * cot) + r

    (((got[0] - got[1]) * torch.from_numpy(cot)).sum() + reg).backward()
    _assert_module_grads(net, bridge.cnn_affine_stn_from_flax(jax.grad(jax_loss)(params)))
    # the default target is img_a
    with torch.no_grad():
        (only,), _ = net(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(only.numpy(), got[0].detach().numpy())


@pytest.mark.parametrize("alpha", [0.0, 2.0])
def test_deformable_stn_matches_jax(alpha):
    a, b, extra = _images(1, 128, 5), _images(1, 128, 6), _images(1, 128, 7)
    jm = jax_stn.DeformableSTN(alpha=alpha)
    params = _module_params(jm, jnp.asarray(a), jnp.asarray(b), bias_std=0.1)
    want, want_reg = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b),
                              apply_on=[jnp.asarray(a), jnp.asarray(extra)])
    net = DeformableSTN(alpha=alpha)
    net.load_state_dict(bridge.deformable_stn_from_flax(params))
    got, reg = net(torch.from_numpy(a), torch.from_numpy(b),
                   apply_on=[torch.from_numpy(a), torch.from_numpy(extra)])
    with torch.no_grad():
        offset = net.offsets(torch.from_numpy(a), torch.from_numpy(b))
    assert float(offset.abs().mean()) * 64 > 0.1  # the warp moves by tenths of a pixel
    assert float(want_reg) > 1e-6
    np.testing.assert_allclose(float(reg), float(want_reg), rtol=2e-3)
    for g, w in zip(got, want):
        assert g.shape == (1, 128, 128, 3)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=2e-4)
    cot = np.random.RandomState(1).randn(*a.shape).astype(np.float32)

    def jax_loss(p):
        (w0, w1), r = jm.apply({"params": p}, jnp.asarray(a), jnp.asarray(b),
                               apply_on=[jnp.asarray(a), jnp.asarray(extra)])
        return jnp.sum((w0 + w1) * cot) + 10.0 * r

    (((got[0] + got[1]) * torch.from_numpy(cot)).sum() + 10.0 * reg).backward()
    _assert_module_grads(net, bridge.deformable_stn_from_flax(jax.grad(jax_loss)(params)),
                         tol=2e-3)


@pytest.mark.parametrize("alpha", [0.0, 3.0])
def test_smoothness_loss_matches_jax(alpha):
    rng = np.random.RandomState(8)
    offset = (0.05 * rng.randn(2, 9, 11, 2)).astype(np.float32)
    img = _images(2, 11, 9)[:, :9]
    want = float(jax_stn.smoothness_loss(jnp.asarray(offset), jnp.asarray(img), alpha=alpha))
    got = float(smoothness_loss(torch.from_numpy(offset), torch.from_numpy(img), alpha=alpha))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fresh_modules_start_at_the_identity_warp():
    gen = torch.Generator().manual_seed(0)
    a, b = torch.from_numpy(_images(1, 128, 10)), torch.from_numpy(_images(1, 128, 11))
    net = DeformableSTN(generator=gen)
    assert not net.offset.weight.any() and not net.offset.bias.any()
    with torch.no_grad():
        (warped,), reg = net(a, b)
    torch.testing.assert_close(warped, a, rtol=0, atol=1e-6)
    assert float(reg) == 0.0
    affine = CNNAffineSTN(128, generator=gen)
    assert 1e-4 < float(affine.fc2.weight.std()) < 1e-3 and not affine.fc2.bias.any()
    net.reset_parameters(gen)
    assert not net.offset.weight.any() and bool(net.down0.weight.any())


# ------------------------------------------------------------ the recipe
def _cfg(size=128, batch=2, **extra):
    cfg = get_experiment("nemar")
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={**cfg.extra, "resnet_blocks": 2, **extra})


def _jax_state(cfg, seed=0):
    """A JAX GANTrainState at step 0 from numpy draws (no flax init run)."""
    recipe = jax_build_recipe(cfg)
    key = jax.random.PRNGKey(seed)
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size)
    shapes = jax.eval_shape(recipe.init, key, batch)
    size = cfg.data.image_size
    deformable = cfg.extra.get("stn_type", "deformable") == "deformable"
    g_params = {"T": _params_like(shapes["g_params"]["T"], seed, size),
                "R": _params_like(shapes["g_params"]["R"], seed + 1, size,
                                  bias_std=0.1 if deformable else 0.01)}
    d_params = _params_like(shapes["d_params"], seed + 2, size)
    g_tx, d_tx = jax_make_optimizers(cfg)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.split(key)[1],
                          g_params=g_params, d_params=d_params, spectral={}, frozen={},
                          g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init(d_params))
    return recipe, state


def _batches(cfg, steps):
    return [synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=s)
            for s in range(steps)]


def _jax_losses(recipe, state, batch):
    """The JAX recipe's terms and gradients at the state's weights (both
    losses at the same weights: no update in between)."""
    rng = jax.random.PRNGKey(0)
    (_, (aux, g_metrics)), g_grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, {}, {}, batch, rng)
    (_, d_metrics), d_grads = jax.jit(jax.value_and_grad(recipe.d_loss, has_aux=True))(
        state.d_params, {}, aux, batch, rng)
    return {**g_metrics, **d_metrics}, g_grads, d_grads


def _port_losses(port_recipe, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k in ("A", "B")}
    for p in [*port_recipe.G.parameters(), *port_recipe.D.parameters()]:
        p.grad = None
    with _frozen(port_recipe.D):
        loss_g, aux, got = port_recipe.g_loss(tb, None)
        loss_g.backward()
    assert all(p.grad is None for p in port_recipe.D.parameters())
    assert not any(v.requires_grad for v in aux.values())
    loss_d, d_got = port_recipe.d_loss(tb, aux)
    loss_d.backward()
    return {**got, **d_got}, aux


def _assert_terms(got, want):
    assert set(got) == set(want) == set(TERMS)
    for k in TERMS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def _assert_grads(module, want, l2_tol, max_tol):
    """Every gradient of ``module`` within ``l2_tol`` of the bridged JAX one in
    L2 norm and ``max_tol`` x the tensor's max|g| elementwise; a bias in front
    of an instance norm (no gradient in exact arithmetic) is skipped."""
    assert {n for n, _ in module.named_parameters()} == set(want)
    worst = 0.0
    for name, p in module.named_parameters():
        w, g = want[name].numpy(), p.grad.numpy()
        if name.endswith("bias") and np.abs(w).max() < 1e-4 * np.abs(
                want[name[:-4] + "weight"].numpy()).max():
            continue
        assert np.abs(w).max() > 0, name
        assert np.linalg.norm(g - w) <= l2_tol * np.linalg.norm(w) + 1e-7, name
        np.testing.assert_allclose(g, w, atol=max_tol * np.abs(w).max() + 1e-7, err_msg=name)
        worst = max(worst, np.linalg.norm(g - w) / np.linalg.norm(w))
    return worst


@pytest.mark.parametrize("extra", [
    dict(lambda_smooth=10.0),
    dict(lambda_smooth=10.0, fast_warp=False, stn_alpha=1.5),
    dict(stn_type="affine", size=64),
    dict(lambda_smooth=10.0, multi_resolution=2, batch=1),
], ids=["deformable", "deformable-gather-bilateral", "affine", "multi-resolution"])
def test_losses_and_gradients_at_fixed_weights(extra):
    """Loss terms rtol 1e-4. The gradients of the whole chain (T -> R -> T ->
    D) are held to 3e-2 in L2 norm and 0.15 x max|g|: at these random weights
    the chain is ill-conditioned in float32. D's output is next to constant
    there, so the backward of its instance norms removes nearly all of the
    upstream gradient and what is left carries the rounding: the fakes of the
    two packages differ by 1e-5, the JAX package's own gradients move by 0.5
    to 1.5 % in L2 norm when A is perturbed by 1e-6 (measured for the affine
    case), and with the JAX ``d_loss`` fed the port's own fakes a single
    leaky-ReLU input within 1e-5 of 0 still leaves D's gradients 0.3 % apart
    (the same D on another input agrees to 3e-6), so that comparison gets
    1e-2. Each module's own gradients are held tightly above, on well-
    conditioned losses; a dropped term or a wrong layout here is off by O(1)."""
    extra = dict(extra)
    cfg = _cfg(size=extra.pop("size", 128), batch=extra.pop("batch", 2), **extra)
    recipe, state = _jax_state(cfg)
    port_recipe = build_recipe(cfg, "cpu")
    assert port_recipe.update_order == recipe.update_order == "d_first"
    assert port_recipe.R.fast_warp is bool(extra.get("fast_warp", True))
    assert set(dict(port_recipe.D.named_children())) == set(state.d_params)
    bridge.train_state_from_flax(state, port_recipe, torch.Generator())
    # uniform noise: the synthetic batch's 8 x 8 constant blocks give 64 pixels
    # one pre-activation, and one of those within rounding of 0 then flips a
    # leaky-ReLU slope for all of them
    n, size = cfg.data.batch_size, cfg.data.image_size
    batch = {"A": _images(n, size, 20), "B": _images(n, size, 21)}
    want, g_grads, d_grads = _jax_losses(recipe, state, batch)
    got, aux = _port_losses(port_recipe, batch)
    _assert_terms(got, want)
    if "lambda_smooth" in extra:
        assert float(want["g_smooth"]) > 1e-6
    _assert_grads(port_recipe.G, bridge.nemar_generators_from_flax(g_grads), 3e-2, 0.15)
    _assert_grads(port_recipe.D, bridge.nemar_discriminators_from_flax(d_grads), 3e-2, 0.15)
    # D's side alone, on the same fakes
    jax_aux = {"fake_tr_b": jnp.asarray(aux["fake_TR_B"].numpy()),
               "fake_rt_b": jnp.asarray(aux["fake_RT_B"].numpy()),
               "reg_a": jnp.asarray(aux["registered_A"].numpy())}
    same = jax.grad(lambda p: recipe.d_loss(p, {}, jax_aux, batch, None)[0])(state.d_params)
    _assert_grads(port_recipe.D, bridge.nemar_discriminators_from_flax(same), 1e-2, 0.1)


def test_downscale_is_jax_image_resize():
    x = _images(2, 32, 12)
    for side in (16, 8):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, side, side, 3), "bilinear"))
        got = _downscale(torch.from_numpy(x), side).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(side, side), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1).numpy()
        if side == 8:  # without the antialias filter the 4x shrink differs visibly
            assert np.abs(plain - want).max() > 1e-2


# -------------------------------------------------------------- schedules
@pytest.mark.parametrize("schedule", ["constant", "linear_decay", "step", "cosine", "plateau"])
def test_schedules_match_the_jax_closed_forms(schedule):
    cfg = get_experiment("nemar")
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, schedule=schedule, decay_start_epoch=3),
                      train=dataclasses.replace(cfg.train, n_epochs=9, steps_per_epoch=7))
    sched = jax_lr(cfg)
    for step in (0, 1, 6, 7, 20, 21, 22, 40, 62, 63, 100):
        want = float(sched(jnp.asarray(step, jnp.int32))) if callable(sched) else sched
        # JAX evaluates in float32: 1 - frac cancels near the end of a decay
        np.testing.assert_allclose(learning_rate(cfg, step), want, rtol=2e-6, atol=1e-10,
                                   err_msg=f"{schedule} at {step}")
    if schedule == "linear_decay":
        assert learning_rate(cfg, 21) == cfg.optim.lr > learning_rate(cfg, 22) > 0
        assert learning_rate(cfg, 63) == 0.0
        # steps_per_epoch None counts every step as an epoch, as in JAX
        per_step = cfg.replace(train=dataclasses.replace(cfg.train, steps_per_epoch=None))
        np.testing.assert_allclose(learning_rate(per_step, 6), cfg.optim.lr * 0.5)


def test_unported_schedule_and_cadence_raise():
    cfg = get_experiment("nemar")
    # plateau is ported: its step lr is the base lr, which the controller
    # rewrites between epochs (tests/test_torch_checkpoint.py)
    plateau = cfg.replace(optim=dataclasses.replace(cfg.optim, schedule="plateau"))
    assert learning_rate(plateau, 40) == cfg.optim.lr
    with pytest.raises(ValueError, match="unknown lr schedule"):
        learning_rate(cfg.replace(optim=dataclasses.replace(cfg.optim, schedule="warmup")), 0)
    per_forward = _cfg(spectral_cadence="per_forward")
    recipe = build_recipe(per_forward, "cpu")
    with pytest.raises(ValueError, match="per_forward"):
        make_train_step(per_forward, recipe)


# --------------------------------------------------------------- lockstep
def _lockstep(cfg, steps):
    recipe, state = _jax_state(cfg)
    start = state
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    port_recipe = build_recipe(cfg, "cpu")
    port_state = bridge.train_state_from_flax(state, port_recipe, torch.Generator())
    trainer = Trainer(cfg, port_recipe)
    state = place_state(state, jax_trainer.mesh)
    step_fn = jax_trainer.compiled_step()
    jax_hist, port_hist, lrs = [], [], []
    for batch in _batches(cfg, steps):
        state, m = step_fn(state, shard_batch(batch, jax_trainer.mesh))
        jax_hist.append([float(m[k]) for k in TERMS])
        mp = trainer.step(port_state, batch)
        port_hist.append([float(mp[k]) for k in TERMS])
        lrs.append((port_state.opt_g.param_groups[0]["lr"], port_state.opt_d.param_groups[0]["lr"]))
    return start, state, port_state, np.asarray(jax_hist), np.asarray(port_hist), lrs


def _decaying(cfg):
    """linear_decay that is already decaying at the second update."""
    return cfg.replace(optim=dataclasses.replace(cfg.optim, decay_start_epoch=0),
                       train=dataclasses.replace(cfg.train, n_epochs=4, steps_per_epoch=1))


def test_two_step_d_first_lockstep_with_the_jax_trainer():
    cfg = _decaying(_cfg(lambda_smooth=10.0))
    assert cfg.optim.schedule == "linear_decay"
    start, jax_state, port_state, jax_hist, port_hist, lrs = _lockstep(cfg, 2)
    np.testing.assert_allclose(port_hist, jax_hist, rtol=3e-3, atol=1e-4)
    assert port_state.step == int(jax_state.step) == 2
    assert lrs == [(cfg.optim.lr,) * 2, (cfg.optim.lr * 0.75,) * 2]
    # a G-first step would show in step 1's GAN terms at O(1e-2): D moved first
    assert abs(jax_hist[0, 3] - jax_hist[1, 3]) > 1e-3
    # the weights moved together, through the schedule's second learning rate.
    # Adam moves every weight by about lr a step whatever its gradient's size,
    # so the elements whose gradient is rounding noise move apart: the two
    # packages' movements are held to each other in L2 norm
    pairs = ((port_state.G, bridge.nemar_generators_from_flax, "g_params",
              ("T.stem.weight", "T.head.weight", "R.offset.weight", "R.down0.bias")),
             (port_state.D, bridge.nemar_discriminators_from_flax, "d_params",
              ("D.conv0.weight", "D.final.bias")))
    for module, convert, field, names in pairs:
        before = convert(jax.device_get(getattr(start, field)))
        after = convert(jax.device_get(getattr(jax_state, field)))
        params = dict(module.named_parameters())
        for name in names:
            moved = (after[name] - before[name]).numpy()
            got = params[name].detach().numpy() - before[name].numpy()
            assert np.abs(moved).max() > 1e-4, name
            print(name, np.linalg.norm(got - moved) / np.linalg.norm(moved))
            assert np.linalg.norm(got - moved) <= 0.2 * np.linalg.norm(moved), name
    # the bridge carries both Adams' moments, counts and the schedule's lr
    bridged = bridge.train_state_from_flax(jax_state, build_recipe(cfg, "cpu"), torch.Generator())
    assert bridged.step == 2
    assert bridged.opt_g.param_groups[0]["lr"] == pytest.approx(cfg.optim.lr * 0.5)
    for opt, ref in ((bridged.opt_g, port_state.opt_g), (bridged.opt_d, port_state.opt_d)):
        for p, q in zip(opt.param_groups[0]["params"], ref.param_groups[0]["params"]):
            a, b = opt.state[p], ref.state[q]
            assert float(a["step"]) == float(b["step"]) == 2.0
            # two steps of ill-conditioned gradients (see the fixed-weights
            # test); + 1e-4: a bias in front of an instance norm has moments
            # of rounding noise, 1e-5
            assert float((a["exp_avg"] - b["exp_avg"]).norm()) <= \
                0.2 * float(b["exp_avg"].norm()) + 1e-4


@pytest.mark.slow
def test_six_step_lockstep_with_nine_blocks():
    cfg = _cfg(lambda_smooth=10.0, resnet_blocks=9)
    _, _, _, jax_hist, port_hist, _ = _lockstep(cfg, 6)
    np.testing.assert_allclose(port_hist[:2], jax_hist[:2], rtol=3e-3, atol=1e-4)
    # later steps accumulate float32 noise amplified by lambda_recon = 100, the
    # window of tests/test_parity_nemar.py
    np.testing.assert_allclose(port_hist[2:3], jax_hist[2:3], rtol=3e-2, atol=1e-3)
    assert np.isfinite(port_hist).all()
    np.testing.assert_allclose(port_hist[3:], jax_hist[3:], rtol=0.8, atol=0.1)


def test_fit_runs_the_forward_once_a_step():
    cfg = _cfg()
    recipe = build_recipe(cfg, "cpu")
    calls = {"T": 0, "R": 0}
    recipe.T.register_forward_hook(lambda *_: calls.__setitem__("T", calls["T"] + 1))
    recipe.R.register_forward_hook(lambda *_: calls.__setitem__("R", calls["R"] + 1))

    class Log:
        rows = []

        def write(self, row):
            self.rows.append(row)

    trainer = Trainer(cfg, recipe, logger=Log())
    state = trainer.init_state(seed=3)
    assert recipe.draw(state.generator, {}) is None
    state = trainer.fit(state, _batches(cfg, 2), num_steps=2, log_every=1, check_finite=True)
    assert state.step == 2 and [r["step"] for r in Log.rows] == [1, 2]
    assert calls == {"T": 4, "R": 2}  # T(A) and T(reg_A), R once: no second forward
    assert all(np.isfinite(r[k]) for r in Log.rows for k in TERMS)
    assert Log.rows[0]["loss_G"] != Log.rows[1]["loss_G"]
    assert set(dict(recipe.G.named_children())) == {"T", "R"}
    assert len(state.opt_g.param_groups[0]["params"]) == sum(1 for _ in recipe.G.parameters())


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["test", "--config", "nemar", "--init-seed", "0", "--data-root", str(tmp_path)])
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
        build_recipe(_cfg())


# ------------------------------------------------------------------ serve
def _read(path):
    return np.asarray(Image.open(path)).astype(int)


def test_serve_path_matches_jax_and_writes_the_six_image_stack(tmp_path):
    cfg = _cfg()
    recipe, state = _jax_state(cfg)
    jax_inf = JaxInferencer(cfg, recipe, state.g_params)
    nets = build_generators(cfg, "cpu")
    assert not nets.training
    nets.load_state_dict(bridge.nemar_generators_from_flax(state.g_params))
    inf = Inferencer(cfg, nets)
    batch = synthetic_batch(batch_size=2, image_size=128, seed=1)
    got, want = inf(batch), jax_inf(batch)
    assert set(got) == set(want) == {"registered_A", "fake_B", "fake_TR_B", "fake_RT_B"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, err_msg=k)
    assert float(np.abs(got["registered_A"].numpy() - batch["A"]).max()) > 1e-2  # it warps

    assert inf.run_test_set([batch], str(tmp_path / "port")) == 2
    assert jax_inf.run_test_set([batch], str(tmp_path / "jax")) == 2
    for name in ("00000.png", "00001.png"):
        a, b = _read(tmp_path / "port" / name), _read(tmp_path / "jax" / name)
        assert a.shape == b.shape == (6 * 128, 128, 3)
        assert np.abs(a - b).max() <= 1, name


def test_cli_test_serves_the_nemar_recipe(tmp_path):
    cfg = _cfg()
    _, state = _jax_state(cfg)
    npz = str(tmp_path / "g_params.npz")
    spec = importlib.util.spec_from_file_location(
        "export_g_params", os.path.join(REPO, "tools", "export_g_params.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.save_g_params(state.g_params, npz)
    loaded = bridge.load_nemar_generators_npz(npz)
    want = bridge.nemar_generators_from_flax(state.g_params)
    assert set(loaded) == set(want) == set(build_generators(cfg, "cpu").state_dict())
    assert all(torch.equal(loaded[k], want[k]) for k in want)

    # the CLI builds the registered experiment (9 blocks): serve it from a seed
    rng = np.random.RandomState(11)
    os.makedirs(tmp_path / "data" / "test")
    for i in range(2):
        img = (rng.rand(128, 256, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "data" / "test" / f"{i:03d}.png")
    out = str(tmp_path / "out")
    cli.main(["test", "--config", "nemar", "--init-seed", "0", "--device", "cpu",
              "--data-root", str(tmp_path / "data"), "--image-size", "128", "--dtype", "float32",
              "--out-dir", out])
    stacks = sorted(os.listdir(out))
    assert stacks == ["00000.png", "00001.png"]
    stack = _read(os.path.join(out, stacks[0]))
    assert stack.shape == (6 * 128, 128, 3)
    # zero offset head: registered_A (third image) is real_A (first) to the
    # pixel, and both fakes behind the warp are fake_B (fourth)
    np.testing.assert_array_equal(stack[256:384], stack[:128])
    assert np.abs(stack[512:640] - stack[384:512]).max() <= 1
    assert np.abs(stack[640:768] - stack[384:512]).max() <= 1
    crops = str(tmp_path / "crops")
    roles = "real_A,real_B,reg_A,fake_B,fake_TR_B,fake_RT_B"
    cli.main(["prep-crop", "--stack-dir", out, "--out-root", crops, "--roles", roles])
    assert sorted(os.listdir(crops)) == sorted(roles.split(","))
