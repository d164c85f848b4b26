"""Blur-pool of the port (CPU: its plain version) against the JAX package,
forward and backward.

The JAX side runs ``blur_pool_padded`` (the XLA form) and the Pallas kernel
``blur_pool_fast`` in interpret mode (conftest pins JAX to the CPU, where
``default_interpret()`` is true); the backward is ``jax.grad`` of the first
and ``jax.vjp`` of the second (its hand-written adjoint). Tolerances: float32
atol 1e-5 (summation order only), bfloat16 atol 3e-2 (a few bf16 ulps at
|y| ~ 2, as the JAX package's own bf16 kernel test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.ops.blurpool import blur_pool_padded as jax_blur_pool_padded
from tfcgan_tpu.ops.pallas_kernels.blurpool import _reflect, blur_pool_fast
from tfcgan_tpu_torch.ops import blurpool
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel

# the cases of tests/test_pallas_kernels.py's blur-pool tests
KERNEL_CASES = [(2, 32, 32, 16), (1, 16, 16, 64), (1, 15, 17, 5), (1, 255, 9, 2),
                (2, 31, 31, 8), (1, 8, 8, 256)]
# blur inputs of the 256² discriminator at batch 1, all stride 2
D_SHAPES = [(1, 255, 255, 64), (1, 127, 127, 128), (1, 63, 63, 256), (1, 31, 31, 512)]
# blur inputs of the 256² generator at batch 1: (shape, stride on the path)
MAIN_PATH = [
    ((1, 255, 255, 64), 2), ((1, 127, 127, 128), 2), ((1, 63, 63, 256), 2),
    ((1, 31, 31, 512), 2), ((1, 15, 15, 512), 2), ((1, 7, 7, 512), 2),
    ((1, 8, 8, 512), 1), ((1, 16, 16, 512), 1), ((1, 32, 32, 256), 1),
    ((1, 64, 64, 128), 1), ((1, 128, 128, 64), 1),
]


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(x, stride):
    return blurpool.blur_pool(torch.from_numpy(x), stride).numpy()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", KERNEL_CASES)
def test_matches_jax_padded_and_pallas(shape, stride):
    x = _x(shape, 6)
    got = _port(x, stride)
    np.testing.assert_allclose(got, np.asarray(jax_blur_pool_padded(jnp.asarray(x), stride)),
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(blur_pool_fast(jnp.asarray(x), stride)),
                               atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_matches_jax(stride):
    x = _x((1, 16, 16, 8), 7)
    xt = torch.from_numpy(x).bfloat16()
    got = blurpool.blur_pool(xt, stride)
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    for want in (jax_blur_pool_padded(xj, stride), blur_pool_fast(xj, stride)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)), atol=3e-2)


@pytest.mark.parametrize("shape,stride", MAIN_PATH)
def test_main_path_shapes(shape, stride):
    x = _x(shape, 9)
    got = _port(x, stride)
    assert got.shape == (1, kernel.out_len(shape[1], stride), kernel.out_len(shape[2], stride),
                         shape[3])
    np.testing.assert_allclose(got, np.asarray(jax_blur_pool_padded(jnp.asarray(x), stride)),
                               atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_tiny_maps_pad_past_the_axis(n, stride):
    # the 64² generator reaches n = 1 (down6) and n = 2 (up1), where the
    # reflect pad is as long as the axis: F.pad(mode="reflect") refuses it
    x = _x((2, n, n, 8), 10)
    np.testing.assert_allclose(_port(x, stride),
                               np.asarray(jax_blur_pool_padded(jnp.asarray(x), stride)),
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 255])
def test_reflect_index_matches_tpu_module(n):
    assert [blurpool.reflect_index(j, n) for j in range(-1, n + 2)] == \
        [_reflect(j, n) for j in range(-1, n + 2)]


def test_output_is_nhwc_contiguous():
    y = blurpool.blur_pool(torch.randn(2, 9, 9, 4), 2)
    assert y.shape == (2, 5, 5, 4) and y.is_contiguous()


def test_kernel_wrapper_refuses_cpu_tensor():
    # no silent fallback: the kernel's wrapper raises for a CPU tensor
    launches = kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.blur_pool_fwd(torch.randn(1, 8, 8, 4), 2)
    assert kernel.LAUNCHES == launches


def _port_grad(x, dy, stride):
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(blurpool.blur_pool(xt, stride), xt, torch.from_numpy(dy))
    return g.numpy()


def _grads(shape, stride, seed):
    """(port gradient, jax.grad of blur_pool_padded, the Pallas kernel's VJP)
    for one random input and output gradient."""
    x = _x(shape, seed)
    dy = _x((shape[0], kernel.out_len(shape[1], stride), kernel.out_len(shape[2], stride),
             shape[3]), seed + 1)
    xj, dyj = jnp.asarray(x), jnp.asarray(dy)
    _, vjp_padded = jax.vjp(lambda v: jax_blur_pool_padded(v, stride), xj)
    _, vjp_fast = jax.vjp(lambda v: blur_pool_fast(v, stride), xj)
    return (_port_grad(x, dy, stride), np.asarray(vjp_padded(dyj)[0]),
            np.asarray(vjp_fast(dyj)[0]))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", KERNEL_CASES)
def test_backward_matches_jax_padded_and_pallas(shape, stride):
    # the odd lengths fold the right-edge taps j = n, n + 1 onto n - 2, n - 3
    got, want_padded, want_fast = _grads(shape, stride, 11)
    np.testing.assert_allclose(got, want_padded, atol=1e-5)
    np.testing.assert_allclose(got, want_fast, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_backward_tiny_maps(n, stride):
    # one input collects up to four reads here. Held to jax.grad of the padded
    # form only: the Pallas kernel does not take these shapes
    # (blur_pool_supported is false) and its adjoint is off at n = 1
    got, want_padded, _ = _grads((2, n, n, 8), stride, 11)
    np.testing.assert_allclose(got, want_padded, atol=1e-5)


@pytest.mark.parametrize("shape", D_SHAPES)
def test_backward_discriminator_shapes(shape):
    got, want_padded, want_fast = _grads(shape, 2, 12)
    np.testing.assert_allclose(got, want_padded, atol=1e-5)
    np.testing.assert_allclose(got, want_fast, atol=1e-5)


def test_backward_kernel_wrapper_refuses_cpu_tensor():
    launches = kernel.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.blur_pool_bwd(torch.randn(1, 4, 4, 4), 8, 8, 2)
    assert kernel.BWD_LAUNCHES == launches
