"""The port's ThermalGAN models (G1 in both norm forms, the Encoder, G2 and
its keep-masks, the three discriminators, ``multiscale_loss``, the
segmentation surrogate, the temperature normalisation and the eps-0.8 batch
norm) against the JAX package's, float32 on the CPU; the recipe and the serve
path are in ``tests/test_torch_thermalgan_recipe.py``.

Weights are numpy draws carried into both packages through the bridge: conv
kernels normal(0, 0.02), Dense kernels normal(0, 0.05), biases normal(0,
0.01), norm scales 1 + normal(0, 0.02). G2 has eight stride-2 downs and
needs 256², so the generators and the recipe run at 256², batch 1; the
discriminators at 64², batch 2. G2's dropout is off (``deterministic_g``):
flax's draws cannot be rebuilt, and the port's keep-masks are held on their
own (``test_g2_applies_the_dropout_masks_as_given``).

Tolerances: module outputs within 2e-4 x max|out|; the recipe's loss terms
rtol 1e-4. Gradients (to the input and to every parameter) are held in L2
norm and elementwise x max|g|: ``TIGHT`` (2e-4, 2e-4) for the
discriminators at 64² and the batch-norm G1 (measured 6.0e-6 / 8.7e-6).
The 256² networks with leaky-ReLU and ReLU layers behind instance or group
norms over up to 128 x 128 x 64 values hold wider bounds, about three times
what was measured. The two packages' float32 convs differ by 1e-5 there, so
a few pre-activations sit on the other side of a kink in one package, and
each such element's gradient changes by the slope ratio (100 at G1's 0.01):
on the instance-norm G1 the port's float32 gradients are 7.0e-4 (L2) from
its own float64 ones and from the JAX package's alike, while the JAX
float32 ones are 2.4e-6 from the port's float64: the port's rounding meets
the kinks; it is not another function. Measured: G1 7.9e-4 / 7.3e-3 and G2
6.3e-4 / 1.1e-2 (``KINKED``), the Encoder 6.2e-3 / 6.0e-2 (``ENCODER``),
the recipe's G and D gradients, whose G2 sees G1's fake_S, 9.5e-3 / 0.115
(``RECIPE``). A dropped term, a swapped layout or a wrong slope is off by
O(1). A bias in front of an instance norm, whose gradient is zero in exact
arithmetic and rounding noise in both packages, is only held to be as
small.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.models import discriminator as jax_disc
from tfcgan_tpu.models import thermalgan as jax_tg
from tfcgan_tpu_torch import bridge
from tfcgan_tpu_torch.models import thermalgan as tg
from tfcgan_tpu_torch.models.discriminator import MultiDiscriminator, multiscale_loss

SIZE = 256


def _draw(rng, path, s):
    name = jax.tree_util.keystr(path)
    if "scale" in name:
        return (1.0 + 0.02 * rng.randn(*s.shape)).astype(np.float32)
    if "bias" in name:
        return (0.01 * rng.randn(*s.shape)).astype(np.float32)
    return ((0.05 if len(s.shape) == 2 else 0.02) * rng.randn(*s.shape)).astype(np.float32)


def _params_like(shapes, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(lambda p, s: _draw(rng, p, s), shapes)


def _module_params(module, *inputs, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))["params"]
    return _params_like(shapes, seed)


def _images(n, size, seed, channels=3):
    return np.random.RandomState(seed).uniform(-1, 1, (n, size, size, channels)).astype(
        np.float32)


def _temps(n, size, seed):
    return np.random.RandomState(seed).uniform(24, 38, (n, size, size)).astype(np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(want).max() > 0, what
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), err_msg=what)


TIGHT = (2e-4, 2e-4)  # (L2, elementwise x max|g|)
KINKED = (2e-3, 3e-2)
ENCODER = (2e-2, 0.15)
RECIPE = (3e-2, 0.3)


def _assert_grad(got, want, tol, what):
    l2, elem = tol
    assert np.linalg.norm(got - want) <= l2 * np.linalg.norm(want) + 1e-9, what
    np.testing.assert_allclose(got, want, atol=elem * np.abs(want).max() + 1e-9, err_msg=what)


def _assert_grads(module, want, tol=TIGHT):
    """Every parameter gradient of ``module`` within ``tol`` (L2,
    elementwise) of the bridged JAX one. A bias in front of an instance norm
    (zero gradient in exact arithmetic) is only held to be as small."""
    assert {n for n, _ in module.named_parameters() if n in want} == set(want)
    for name, w in want.items():
        g = dict(module.named_parameters())[name].grad.numpy()
        w = w.numpy()
        scale = np.abs(want.get(name[:-4] + "weight", w).numpy()).max() \
            if name.endswith("bias") else np.abs(w).max()
        if name.endswith("bias") and np.abs(w).max() < 1e-4 * scale:
            assert np.abs(g).max() < 1e-3 * scale, name
            continue
        _assert_grad(g, w, tol, name)


# ---------------------------------------------------------------- modules
def _check_module(jm, net, convert, inputs, tol=TIGHT, outputs=None):
    """Outputs, the gradient to the first input and every parameter gradient
    of ``net`` against the JAX module ``jm`` under one random cotangent."""
    params = _module_params(jm, *[jnp.asarray(x) for x in inputs])
    net.load_state_dict(convert(params))

    def jax_fn(p, x0):
        out = jm.apply({"params": p}, x0, *[jnp.asarray(x) for x in inputs[1:]])
        return outputs(out) if outputs else out

    want = jax.jit(jax_fn)(params, jnp.asarray(inputs[0]))
    cot = [np.random.RandomState(7 + i).randn(*np.shape(w)).astype(np.float32)
           for i, w in enumerate(jax.tree_util.tree_leaves(want))]
    x0 = torch.from_numpy(inputs[0]).requires_grad_(True)
    out = net(x0, *[torch.from_numpy(x) for x in inputs[1:]])
    got = outputs(out) if outputs else out
    for i, (g, w) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                   jax.tree_util.tree_leaves(want))):
        _close(g.detach().numpy(), w, 2e-4, f"output {i}")
    sum(((g * torch.from_numpy(c)).sum() for g, c in zip(jax.tree_util.tree_leaves(got), cot)),
        torch.zeros(())).backward()
    p_grads, x_grad = jax.jit(jax.grad(lambda p, x: sum(
        jnp.sum(o * c) for o, c in zip(jax.tree_util.tree_leaves(jax_fn(p, x)), cot)),
        argnums=(0, 1)))(params, jnp.asarray(inputs[0]))
    _assert_grad(x0.grad.numpy(), np.asarray(x_grad), tol, "input gradient")
    _assert_grads(net, convert(p_grads), tol)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_generator_g1_matches_jax(norm):
    net = tg.GeneratorG1(norm=norm)
    if norm == "batch":
        assert net.down7.bn is None and net.down2.bn is not None and net.up1.bn is not None
    _check_module(jax_tg.GeneratorG1(norm=norm), net, bridge.conv_net_from_flax,
                  [_images(1, SIZE, 1), _temps(1, SIZE, 2) / 100.0],
                  TIGHT if norm == "batch" else KINKED)


def test_encoder_matches_jax_and_flattens_nhwc():
    net = tg.Encoder(image_size=SIZE)
    assert net.fc_mu.weight.shape == (8, 2 * 2 * 256)
    _check_module(jax_tg.Encoder(), net, bridge.conv_net_from_flax, [_images(1, SIZE, 3)],
                  ENCODER, outputs=lambda out: list(out))


def test_generator_g2_matches_jax():
    def convert(params):
        return {k[3:]: v for k, v in bridge.thermalgan_generators_from_flax(
            {"G2": params}).items()}

    net = tg.GeneratorG2().eval()
    _check_module(jax_tg.GeneratorG2(), net, convert, [_images(1, SIZE, 4)], KINKED)
    with pytest.raises(ValueError, match="256"):
        net(torch.zeros(1, 128, 128, 3))


def test_g2_applies_the_dropout_masks_as_given():
    gen = torch.Generator().manual_seed(0)
    net = tg.GeneratorG2(generator=gen)
    x = torch.from_numpy(_images(1, SIZE, 5))
    with pytest.raises(ValueError, match="dropout_masks"):
        net(x)
    masks = net.draw_dropout_masks(1, SIZE, SIZE, gen)
    assert sorted(masks) == sorted([f"down{i}" for i in range(4, 9)]
                                   + [f"up{i}" for i in range(1, 5)])
    for name, m in masks.items():
        assert set(torch.unique(m).tolist()) <= {0.0, 2.0}, name
    seen = {}
    for name in ("down6", "up3"):
        block = getattr(net, name)
        block.conv.register_forward_hook(lambda mod, inp, out, name=name: seen.__setitem__(
            f"{name}.conv", out))
        block.register_forward_hook(lambda mod, inp, out, name=name: seen.__setitem__(name, out))
    with torch.no_grad():
        net(x, masks)
    want_down6 = torch.nn.functional.leaky_relu(tg.instance_norm(seen["down6.conv"]), 0.2)
    torch.testing.assert_close(seen["down6"], want_down6 * masks["down6"], rtol=0, atol=0)
    want_up3 = torch.relu(tg.instance_norm(seen["up3.conv"])) * masks["up3"]
    torch.testing.assert_close(seen["up3"][..., :512], want_up3, rtol=0, atol=0)
    # keep-masks of ones are the eval-mode network
    ones = {k: torch.ones_like(v) for k, v in masks.items()}
    with torch.no_grad():
        train_out = net(x, ones)
        eval_out = net.eval()(x)
    torch.testing.assert_close(train_out, eval_out, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["pix", "vae2", "multi"])
def test_discriminators_match_jax(kind):
    img, cond = _images(2, 64, 6), _images(2, 64, 7)
    if kind == "pix":
        _check_module(jax_tg.DiscriminatorPix(), tg.DiscriminatorPix(),
                      bridge.conv_net_from_flax, [img, cond])
    elif kind == "vae2":
        net = tg.VAEDiscriminator2()
        assert net.final.bias is None
        _check_module(jax_tg.VAEDiscriminator2(), net, bridge.conv_net_from_flax, [img])
    else:
        net = MultiDiscriminator()
        assert net.disc_0.final.weight.shape == (1, 512, 3, 3) and net.disc_2.final.bias is not None
        _check_module(jax_disc.MultiDiscriminator(), net, bridge.conv_net_from_flax, [img])


@pytest.mark.parametrize("loss", ["l1", "mse"])
def test_multiscale_loss_matches_jax(loss):
    rng = np.random.RandomState(8)
    outs = [rng.randn(2, s, s, 1).astype(np.float32) for s in (4, 2, 1)]
    for target in (0.0, 1.0):
        want = float(jax_disc.multiscale_loss([jnp.asarray(o) for o in outs], target, loss))
        got = float(multiscale_loss([torch.from_numpy(o) for o in outs], target, loss))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    bf16 = multiscale_loss([torch.from_numpy(o).bfloat16() for o in outs], 1.0, loss)
    assert bf16.dtype == torch.bfloat16  # no float32 cast, as in JAX


def test_mask_temps_and_batch_norm_match_jax():
    b, t = _images(2, 16, 9), _temps(2, 16, 10)
    np.testing.assert_allclose(tg.thermal_mask(torch.from_numpy(b)).numpy(),
                               np.asarray(jax_tg.thermal_mask(jnp.asarray(b))), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tg.normalized_temps(torch.from_numpy(t)).numpy(),
                               np.asarray(jax_tg.normalized_temps(jnp.asarray(t))), rtol=1e-6)
    x = _images(3, 8, 11, channels=5) * 3.0
    jm = jax_tg.TrainBatchNorm()
    params = _module_params(jm, jnp.asarray(x))
    net = tg.TrainBatchNorm(5)
    assert net.eps == 0.8
    net.load_state_dict({"weight": torch.from_numpy(np.asarray(params["scale"])),
                         "bias": torch.from_numpy(np.asarray(params["bias"]))})
    for dtype in (torch.float32, torch.bfloat16):
        got = net(torch.from_numpy(x).to(dtype))
        want = jm.apply({"params": params}, jnp.asarray(
            x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-2 if dtype == torch.bfloat16 else 1e-5, atol=1e-5)
