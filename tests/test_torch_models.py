"""The port's generator and its layers against the JAX modules, float32,
with the JAX params carried over by ``tfcgan_tpu_torch.bridge``.

Tolerance atol 2e-4, the one ``tests/test_models.py`` holds the JAX
generator to against a torch replica: float32 convolutions summed in
another order, through six instance norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu import models as jax_models
from tfcgan_tpu.models import layers as jax_layers
from tfcgan_tpu_torch.bridge import flatten_params, generator_from_flax
from tfcgan_tpu_torch.models import layers
from tfcgan_tpu_torch.models.unet import GeneratorUNet


@pytest.fixture(scope="module")
def jax_g():
    """JAX GeneratorUNet params, normal(0, 0.02) from numpy (their shapes do
    not depend on the image size), and its jitted forward."""
    m = jax_models.GeneratorUNet()
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.02).astype(np.float32), shapes)
    return params, jax.jit(lambda p, x: m.apply({"params": p}, x))


@pytest.mark.parametrize("size,batch", [(128, 1), (64, 2)])
def test_generator_matches_jax(jax_g, size, batch):
    # at 64² down6 sees a 1×1 map and up1 a 2×2 one: the reflect pads run
    # past the axis and the instance norm gives zeros
    x = np.random.RandomState(size).randn(batch, size, size, 3).astype(np.float32)
    params, apply = jax_g
    want = np.asarray(apply(params, jnp.asarray(x)))
    g = GeneratorUNet().eval()
    g.load_state_dict(generator_from_flax(params))
    with torch.inference_mode():
        got = g(torch.from_numpy(x))
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_bridge_takes_flat_slash_keys_and_covers_the_state_dict(jax_g):
    params = jax_g[0]
    flat = flatten_params(params)
    assert "down1/conv/kernel" in flat and "final_conv/bias" in flat
    nested, from_flat = generator_from_flax(params), generator_from_flax(flat)
    assert set(nested) == set(GeneratorUNet().state_dict()) == set(from_flat)
    for k in nested:
        torch.testing.assert_close(nested[k], from_flat[k], rtol=0, atol=0)
    with pytest.raises(KeyError, match="no GeneratorUNet parameter"):
        generator_from_flax({"down1": {"norm": {"scale": np.ones(3)}}})


def _flax_to_torch_conv(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _flax_to_torch_convT(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("normalize", [True, False])
def test_unet_down_matches_jax(normalize):
    x = np.random.RandomState(3).randn(2, 17, 17, 6).astype(np.float32)
    m = jax_layers.UNetDown(8, normalize=normalize)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = layers.UNetDown(6, 8, normalize=normalize).eval()
    port.conv.weight.data = _flax_to_torch_conv(params["conv"]["kernel"])
    got = port(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax.jit(m.apply)({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_unet_up_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 5, 8).astype(np.float32)
    skip = rng.randn(2, 10, 10, 4).astype(np.float32)
    m = jax_layers.UNetUp(6)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip))["params"]
    port = layers.UNetUp(8, 6).eval()
    port.conv.weight.data = _flax_to_torch_convT(params["conv"]["kernel"])
    got = port(torch.from_numpy(x), torch.from_numpy(skip)).detach().numpy()
    want = np.asarray(jax.jit(m.apply)({"params": params}, jnp.asarray(x), jnp.asarray(skip)))
    assert got.shape == (2, 10, 10, 10)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_upsample2x_conv_matches_jax():
    x = np.random.RandomState(5).randn(2, 6, 7, 8).astype(np.float32)
    m = jax_layers.Upsample2xConv(3)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {**params, "bias": jnp.asarray([0.1, -0.2, 0.3])}
    port = layers.Upsample2xConv(8, 3)
    port.weight.data = _flax_to_torch_conv(params["kernel"])
    port.bias.data = torch.from_numpy(np.array(params["bias"]))
    got = port(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    assert got.shape == (2, 12, 14, 3)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_dropout_blocks_refuse_training_mode():
    # training mode runs dropout only with explicit keep-masks
    g = GeneratorUNet().train()
    with pytest.raises(ValueError, match="needs dropout_masks"):
        g(torch.zeros(1, 64, 64, 3))
    masks = g.draw_dropout_masks(1, 64, 64, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="eval mode"):
        g.eval()(torch.zeros(1, 64, 64, 3), masks)


def _keep_mask(shape, seed):
    """A p = 0.5 keep-mask, scaled by 1/(1-p) = 2."""
    return torch.from_numpy((np.random.RandomState(seed).rand(*shape) < 0.5) * 2.0).float()


def test_unet_down_dropout_is_jax_output_times_mask():
    # dropout is the block's last op, so the JAX block's deterministic output
    # times the mask is exactly the JAX block with that keep-mask
    x = np.random.RandomState(20).randn(2, 17, 17, 6).astype(np.float32)
    m = jax_layers.UNetDown(8, dropout=0.5)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = layers.UNetDown(6, 8, dropout=0.5).train()
    port.conv.weight.data = _flax_to_torch_conv(params["conv"]["kernel"])
    keep = _keep_mask((2, 8, 8, 8), 21)
    got = port(torch.from_numpy(x), keep).detach().numpy()
    want = np.asarray(jax.jit(m.apply)({"params": params}, jnp.asarray(x))) * keep.numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_unet_up_dropout_comes_before_the_skip_concat():
    rng = np.random.RandomState(22)
    x = rng.randn(2, 5, 5, 8).astype(np.float32)
    skip = rng.randn(2, 10, 10, 4).astype(np.float32)
    m = jax_layers.UNetUp(6, dropout=0.5)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip))["params"]
    port = layers.UNetUp(8, 6, dropout=0.5).train()
    port.conv.weight.data = _flax_to_torch_convT(params["conv"]["kernel"])
    keep = _keep_mask((2, 10, 10, 6), 23)
    got = port(torch.from_numpy(x), torch.from_numpy(skip), keep).detach().numpy()
    want = np.array(jax.jit(m.apply)({"params": params}, jnp.asarray(x), jnp.asarray(skip)))
    want[..., :6] *= keep.numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_drawn_masks_keep_half_and_reach_every_dropout_block():
    g = GeneratorUNet().train()
    masks = g.draw_dropout_masks(2, 64, 64, torch.Generator().manual_seed(1))
    assert set(masks) == {"down3", "down4", "up2", "up3"}
    assert masks["down3"].shape == (2, 8, 8, 256) and masks["up2"].shape == (2, 4, 4, 512)
    kept = torch.cat([m.flatten() for m in masks.values()])
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert abs(float((kept > 0).float().mean()) - 0.5) < 0.02
    zeros = {k: torch.zeros_like(v) for k, v in masks.items()}
    x = torch.randn(2, 64, 64, 3)
    assert not torch.equal(g(x, masks), g(x, zeros))


def test_init_seed_is_reproducible_and_normal():
    a = GeneratorUNet(generator=torch.Generator().manual_seed(0))
    b = GeneratorUNet(generator=torch.Generator().manual_seed(0))
    w = a.down2.conv.weight
    torch.testing.assert_close(w, b.down2.conv.weight, rtol=0, atol=0)
    assert abs(float(w.detach().std()) - 0.02) < 1e-3
    assert not a.final_conv.bias.detach().any()
