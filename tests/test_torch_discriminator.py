"""The port's PatchDiscriminator and spectral power iteration against the
JAX package, float32 on the CPU, with the JAX params and spectral u/v carried
over by ``tfcgan_tpu_torch.bridge``.

Tolerances: logits and gradients atol 2e-4 x their max magnitude (the
2e-4 of ``tests/test_models.py``, scaled: float32 convs summed in another
order); the power iteration's u and v rtol 1e-5.

Block i's conv biases are +-3 * 4^i by channel, larger than the conv's own
output there, so that no leaky-ReLU input lies near its kink: a
pre-activation of 1e-8 can round to either sign in the two frameworks, and its
gradient then differs by the factor 5 between the slopes (with random biases,
one such element at 128² moved the input gradient by 1.8 % of its max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu import models as jax_models
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu_torch.bridge import discriminator_from_flax
from tfcgan_tpu_torch.models.discriminator import PatchDiscriminator
from tfcgan_tpu_torch.models.layers import spectral_power_iteration


def _unit(v):
    return (v / np.linalg.norm(v)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_d():
    """JAX PatchDiscriminator params normal(0, 0.02) with small random biases,
    from numpy, and u/v from random unit vectors after 20 power iterations
    (near W's top singular pair, so sigma is W's spectral norm, as in training)."""
    m = jax_models.PatchDiscriminator()
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.RandomState(30)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.02).astype(np.float32),
                          shapes["params"])
    for i in range(4):
        bias = params[f"block{i}_conv"]["bias"]
        params[f"block{i}_conv"]["bias"] = np.where(np.arange(bias.size) % 2, 1.0, -1.0
                                                    ).astype(np.float32) * 3 * 4**i
    spectral = jax.tree.map(lambda s: _unit(rng.randn(*s.shape)), shapes["spectral"])
    for _ in range(20):
        spectral = jax_power_iteration(params, spectral)
    return m, params, jax.device_get(spectral)


def _port_d(params, spectral):
    d = PatchDiscriminator()
    d.load_state_dict(discriminator_from_flax(params, spectral))
    return d


@pytest.mark.parametrize("size", [64, 128])
def test_forward_and_gradients_match_jax(jax_d, size):
    m, params, spectral = jax_d
    rng = np.random.RandomState(size)
    a, b = (np.tanh(rng.randn(2, size, size, 3)).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, size // 16, size // 16, 1).astype(np.float32)

    def jax_loss(p, a_, b_):
        out = m.apply({"params": p, "spectral": spectral}, a_, b_)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(a), jnp.asarray(b))

    d = _port_d(params, spectral)
    pre = []  # every leaky-ReLU input, to check that none is near the kink
    for block in d.blocks():
        block.register_forward_hook(lambda mod, args, y: pre.append(y.detach().abs().min()))
    at, bt = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    out = d(at, bt)
    assert min(pre) > 1.0
    assert out.shape == (2, size // 16, size // 16, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-4 * np.abs(np.asarray(want)).max())
    (out * torch.from_numpy(cot)).sum().backward()

    def close(got, want_):
        want_ = np.asarray(want_)
        np.testing.assert_allclose(got, want_, atol=2e-4 * np.abs(want_).max())

    close(at.grad.numpy(), grads[1])
    close(bt.grad.numpy(), grads[2])
    want_w = discriminator_from_flax(jax.device_get(grads[0]))
    for name, p in d.named_parameters():
        close(p.grad.numpy(), want_w[name].numpy())


@pytest.mark.parametrize("order", ["vu", "uv"])
def test_power_iteration_matches_jax(jax_d, order):
    _, params, spectral = jax_d
    d = _port_d(params, spectral)
    want = discriminator_from_flax(params, jax_power_iteration(params, spectral, order=order))
    spectral_power_iteration(d, order=order)
    for i in range(4):
        for k in ("u", "v"):
            got = getattr(getattr(d, f"block{i}_conv"), k)
            np.testing.assert_allclose(got.numpy(), want[f"block{i}_conv.{k}"].numpy(),
                                       rtol=1e-5, atol=1e-7)


def test_power_iteration_replaces_buffers_a_saved_graph_holds(jax_d):
    # the per-forward cadence advances u/v between two D forwards of one
    # backward: the first forward's saved u/v must stay as they were
    _, params, spectral = jax_d
    d = _port_d(params, spectral)
    x = torch.randn(1, 32, 32, 3, requires_grad=True)
    y1 = d(x, x)
    spectral_power_iteration(d, order="uv")
    y2 = d(x, x)
    (y1.sum() + y2.sum()).backward()
    assert torch.isfinite(x.grad).all()


def test_init_is_reproducible_and_unit():
    a = PatchDiscriminator(generator=torch.Generator().manual_seed(0))
    b = PatchDiscriminator(generator=torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    for block in a.blocks():
        assert abs(float(block.u.norm()) - 1) < 1e-6 and abs(float(block.v.norm()) - 1) < 1e-6
        assert not block.bias.detach().any()
