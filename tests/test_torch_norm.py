"""Instance norm of the port against the JAX package.

float32 is held at atol 1e-5 (the same two-pass arithmetic); the bf16 form
at atol 3e-2 (both round the same E[x²]−μ² result to bf16, a few ulps at the
|y| ~ 3 of standardized data).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.ops.norm import instance_norm as jax_instance_norm
from tfcgan_tpu_torch.ops.norm import instance_norm


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 7, 9, 3), (2, 2, 2, 512)])
def test_fp32_matches_jax(shape):
    x = (np.random.RandomState(0).randn(*shape) * 3 + 1).astype(np.float32)
    got = instance_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_instance_norm(jnp.asarray(x))), atol=1e-5)


def test_bf16_matches_jax():
    x = (np.random.RandomState(1).randn(2, 16, 16, 8) * 3 + 1).astype(np.float32)
    got = instance_norm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = jax_instance_norm(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_by_one_map_gives_zeros(dtype):
    # down6 of the 64² generator normalizes a 1×1 map
    x = np.random.RandomState(2).randn(2, 1, 1, 16).astype(np.float32)
    got = instance_norm(torch.from_numpy(x).to(dtype)).float().numpy()
    np.testing.assert_array_equal(got, np.zeros_like(x))
    np.testing.assert_array_equal(np.asarray(jax_instance_norm(jnp.asarray(x))), got)
