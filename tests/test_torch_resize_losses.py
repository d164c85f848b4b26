"""``ops/resize.py`` and the rest of ``ops/gan_losses.py`` against the JAX
package's functions, float32 on the CPU: the cubic resize (Keys a = -0.5,
antialiased when it shrinks) on up- and down-scales within 1e-5, the
pyramid's 3x3 average pool exactly as XLA's window sums give it (1e-6), and
the vanilla and WGAN terms (rtol 1e-6) and the gradient penalty on a small
PatchGAN in its three modes (rtol 1e-4; its gradients to D's parameters
within 1e-4 of their L2 norm; the biases in front of an instance norm,
zero in exact arithmetic, held below 1e-3 of their kernel's max|g|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.models.discriminator import NLayerDiscriminator as JaxNLayer
from tfcgan_tpu.ops import gan_losses as jax_losses
from tfcgan_tpu.ops import resize as jax_resize
from tfcgan_tpu_torch import bridge
from tfcgan_tpu_torch.models.discriminator import NLayerDiscriminator
from tfcgan_tpu_torch.ops import gan_losses
from tfcgan_tpu_torch.ops.resize import avg_pool_2x, resize_bicubic_torch


def _images(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("out_hw", [(34, 48), (17, 24), (8, 12), (5, 7), (40, 9), (1, 1)],
                         ids=["up2x", "same", "down2x", "down-odd", "mixed", "to-1"])
def test_resize_bicubic_matches_jax_image_resize(out_hw):
    x = _images((2, 17, 24, 3), 0)
    want = np.asarray(jax_resize.resize_bicubic_torch(jnp.asarray(x), out_hw))
    got = resize_bicubic_torch(torch.from_numpy(x), out_hw)
    assert got.shape == (2, *out_hw, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if out_hw == (8, 12):  # torch's bicubic (a = -0.75, no antialias) is another function
        plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw,
                                                mode="bicubic").permute(0, 2, 3, 1)
        assert float((plain - got).abs().max()) > 1e-2


@pytest.mark.parametrize("hw", [(16, 16), (9, 7), (1, 2)])
def test_avg_pool_2x_matches_jax(hw):
    x = _images((2, *hw, 4), 1)
    want = np.asarray(jax_resize.avg_pool_2x(jnp.asarray(x)))
    got = avg_pool_2x(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_vanilla_and_wgan_terms_match_jax():
    real, fake = _images((2, 6, 6, 1), 2) * 3, _images((2, 6, 6, 1), 3) * 3
    tr, tf_ = torch.from_numpy(real), torch.from_numpy(fake)
    pairs = [(gan_losses.vanilla_g_loss(tf_), jax_losses.vanilla_g_loss(jnp.asarray(fake))),
             (gan_losses.wgan_g_loss(tf_), jax_losses.wgan_g_loss(jnp.asarray(fake))),
             (gan_losses.wgan_d_loss(tr, tf_),
              jax_losses.wgan_d_loss(jnp.asarray(real), jnp.asarray(fake)))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("mode", ["mixed", "real", "fake"])
def test_gradient_penalty_matches_jax(mode):
    real, fake = _images((2, 32, 32, 6), 4), _images((2, 32, 32, 6), 5)
    jm = JaxNLayer()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(real))["params"]
    key = jax.random.PRNGKey(3)
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))

    def jax_gp(p):
        return jax_losses.gradient_penalty(lambda x: jm.apply({"params": p}, x),
                                           jnp.asarray(real), jnp.asarray(fake), key, mode=mode)

    want, want_grads = jax.value_and_grad(jax_gp)(params)
    net = NLayerDiscriminator()
    net.load_state_dict(bridge.nlayer_discriminator_from_flax(params))
    fake_t = torch.from_numpy(fake).requires_grad_(True)
    got = gan_losses.gradient_penalty(net, torch.from_numpy(real), fake_t,
                                      torch.from_numpy(alpha) if mode == "mixed" else None,
                                      mode=mode)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    got.backward()
    grads = bridge.nlayer_discriminator_from_flax(want_grads)
    for name, p in net.named_parameters():
        w = grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()  # final.bias: no path
        if name in ("conv1.bias", "conv2.bias", "conv3.bias"):
            # in front of an instance norm: zero in exact arithmetic, noise in both
            scale = np.abs(grads[name[:-4] + "weight"].numpy()).max()
            assert np.abs(w).max() < 1e-3 * scale and np.abs(g).max() < 1e-3 * scale, name
            continue
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-9, name
    # differentiable in the images too, where they carry a graph
    assert (fake_t.grad is not None) == (mode != "real")
    with pytest.raises(ValueError, match="alpha"):
        gan_losses.gradient_penalty(net, torch.from_numpy(real), fake_t, mode="mixed")
