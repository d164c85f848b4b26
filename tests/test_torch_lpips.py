"""The port's LPIPS against the JAX package's, float32 on the CPU, with the
JAX params carried over by ``tfcgan_tpu_torch.bridge``; and the recipe's
refusal to train where the JAX package would load pretrained weights.

Tolerances: distances rtol 1e-5 (float32 convs summed in another order,
through 13 convs). The gradient to x atol 3e-3 x max|g|: 13 ReLUs and 4
max-pools make it piecewise, and an element within float32 rounding of a
kink or of a pooling tie takes either branch in either framework. Against
the port in float64, the port's float32 gradient was off by 1.2e-3 x max at
32² and the JAX package's by 5.7e-4 x max at 64²; a wrong formula is off by
O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu import models as jax_models
from tfcgan_tpu_torch.bridge import lpips_from_flax
from tfcgan_tpu_torch.config import get_experiment
from tfcgan_tpu_torch.models.lpips import LPIPS
from tfcgan_tpu_torch.recipes import build_recipe


@pytest.fixture(scope="module")
def jax_lpips():
    """JAX LPIPS variables: lecun-scaled normal convs, small random biases and
    uniform(0, 0.1) lin weights, from numpy."""
    m = jax_models.LPIPS()
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.RandomState(40)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "lin" in name:
            return rng.uniform(0, 0.1, s.shape).astype(np.float32)
        if "bias" in name:
            return (rng.randn(*s.shape) * 0.01).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)

    return m, {"params": jax.tree_util.tree_map_with_path(draw, shapes)}


def _images(size, seed):
    rng = np.random.RandomState(seed)
    return [np.tanh(rng.randn(2, size, size, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("size", [32, 64])
def test_distance_and_gradient_match_jax(jax_lpips, size):
    m, variables = jax_lpips
    x, y = _images(size, size)
    want_d = np.asarray(jax.jit(lambda a: m.apply(variables, a, y))(jnp.asarray(x)))
    want_g = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(m.apply(variables, a, y))))(
        jnp.asarray(x)))

    port = LPIPS()
    port.load_state_dict(lpips_from_flax(variables))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    got = port(xt, yt)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want_d, rtol=1e-5)
    got.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=3e-3 * np.abs(want_g).max())
    # the real-image tower runs without a graph, and the weights are frozen
    assert yt.grad is None
    assert all(p.grad is None and not p.requires_grad for p in port.parameters())


def test_zero_for_identical_positive_otherwise():
    port = LPIPS(generator=torch.Generator().manual_seed(0))
    x, y = (torch.from_numpy(v) for v in _images(32, 1))
    np.testing.assert_allclose(port(x, x).numpy(), 0.0, atol=1e-6)
    assert (port(x, y) > 0).all()


def test_random_init_has_the_jax_distributions():
    port = LPIPS(generator=torch.Generator().manual_seed(0))
    w = port.vgg.conv5.weight  # (256, 128, 3, 3): lecun normal, std sqrt(1 / 1152)
    assert abs(float(w.std()) - (1 / 1152) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * (1 / 1152) ** 0.5 / 0.87962566 + 1e-6
    lin = port.lin3
    assert 0 <= float(lin.min()) and float(lin.max()) <= 0.1
    assert not port.vgg.conv1.bias.any()


def test_recipe_refuses_to_train_on_random_weights_where_jax_loads_them(monkeypatch, tmp_path):
    # the recipe loads the file where the JAX recipe does (test_torch_weights_msgpack.py);
    # a file it cannot read stops the init instead of leaving LPIPS random
    weights = tmp_path / "lpips_flax.msgpack"
    weights.write_bytes(b"")
    monkeypatch.setenv("TFCGAN_LPIPS_WEIGHTS", str(weights))
    cfg = get_experiment("fft_glo")
    recipe = build_recipe(cfg, "cpu")
    assert recipe.perceptual == "lpips"
    with pytest.raises(ValueError, match="truncated msgpack"):
        recipe.init(torch.Generator().manual_seed(0))
    monkeypatch.delenv("TFCGAN_LPIPS_WEIGHTS")
    # msrecon builds no LPIPS module, so it trains with no weights to load
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, perceptual="msrecon"))
    recipe = build_recipe(cfg, "cpu")
    assert recipe.perceptual == "msrecon" and recipe.lpips is None
