"""Blur-pool of the port (CPU: its plain version) against the JAX package.

The JAX side runs ``blur_pool_padded`` (the XLA form) and the Pallas kernel
``blur_pool_fast`` in interpret mode (conftest pins JAX to the CPU, where
``default_interpret()`` is true). Tolerances: float32 atol 1e-5 (summation
order only), bfloat16 atol 3e-2 (a few bf16 ulps at |y| ~ 2, as the JAX
package's own bf16 kernel test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.ops.blurpool import blur_pool_padded as jax_blur_pool_padded
from tfcgan_tpu.ops.pallas_kernels.blurpool import _reflect, blur_pool_fast
from tfcgan_tpu_torch.ops import blurpool
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel

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
@pytest.mark.parametrize("shape", [(2, 32, 32, 16), (1, 16, 16, 64), (1, 15, 17, 5),
                                   (1, 255, 9, 2), (2, 31, 31, 8), (1, 8, 8, 256)])
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
