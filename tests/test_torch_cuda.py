"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. The file imports no JAX, so on a machine with a card and without
JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol 1e-5 (summation order). bfloat16 against the plain
version computed in float32 from the same bf16 input (or output gradient)
and then rounded: atol = rtol = 8e-3, one bf16 ulp, for a final rounding
that can land on the other side.
"""

import pytest
import torch

from tfcgan_tpu_torch.ops import blurpool
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(8, 255, 255, 64), (8, 7, 7, 512), (8, 16, 16, 512),
                                   (1, 15, 17, 5), (1, 255, 9, 2), (2, 31, 31, 8),
                                   (2, 1, 1, 8), (2, 2, 2, 8), (2, 3, 3, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_kernel_matches_plain(cuda, shape, stride, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    launches = kernel.LAUNCHES
    got = kernel.blur_pool_fwd(x, stride)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == launches + 1
    want = blurpool.blur_pool_padded(x.float(), stride).to(dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(8, 255, 255, 64), (8, 7, 7, 512), (8, 16, 16, 512),
                                   (1, 15, 17, 5), (1, 255, 9, 2), (2, 31, 31, 8),
                                   (2, 1, 1, 8), (2, 2, 2, 8), (2, 3, 3, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_backward_kernel_matches_plain_gradient(cuda, shape, stride, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    n, h, w, c = shape
    dy = torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                     device=cuda, generator=g).to(dtype)
    launches = kernel.BWD_LAUNCHES
    got = kernel.blur_pool_bwd(dy, h, w, stride)
    torch.cuda.synchronize()
    assert kernel.BWD_LAUNCHES == launches + 1 and got.dtype == dtype
    x = torch.zeros(shape, device=cuda, requires_grad=True)
    (want,) = torch.autograd.grad(blurpool.blur_pool_padded(x, stride), x, dy.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.to(dtype).float(), atol=8e-3, rtol=8e-3)


def test_blur_pool_autograd_runs_both_kernels(cuda):
    x = torch.randn(2, 31, 31, 8, device=cuda, requires_grad=True)
    fwd, bwd = kernel.LAUNCHES, kernel.BWD_LAUNCHES
    y = blurpool.blur_pool(x, 2)
    (y * y).sum().backward()
    torch.cuda.synchronize()
    assert (kernel.LAUNCHES, kernel.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    xp = x.detach().requires_grad_()
    (blurpool.blur_pool_padded(xp, 2) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, xp.grad, atol=1e-5, rtol=0)


def test_blurpool_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.blur_pool_fwd(x.permute(0, 2, 1, 3), 2)
    with pytest.raises(TypeError):
        kernel.blur_pool_fwd(x.half(), 2)
    dy = torch.randn(1, 4, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.blur_pool_bwd(dy.permute(0, 2, 1, 3), 8, 8, 2)
    with pytest.raises(TypeError):
        kernel.blur_pool_bwd(dy.half(), 8, 8, 2)
    with pytest.raises(ValueError, match="not the stride-2 output"):
        kernel.blur_pool_bwd(dy, 9, 7, 2)
