"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. The file imports no JAX, so on a machine with a card and without
JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: blur-pool float32 atol 1e-5 (summation order); bfloat16 against
the plain version computed in float32 from the same bf16 input (or output
gradient) and then rounded: atol = rtol = 8e-3, one bf16 ulp, for a final
rounding that can land on the other side. Resampling (float32 results from a
float32 or bfloat16 input): outputs and the gradient to x within 2e-5, the
gradients to p and q (sums over whole lines, in another order) within 2e-4,
each x max(1, max|plain|).
"""

from unittest import mock

import pytest
import torch

from tfcgan_tpu_torch.ops import blurpool, resample
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel
from tfcgan_tpu_torch.ops.kernels import resample as rkernel

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


# ------------------------------------------------------------ resampling
def _close(got, want, tol):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=0)


def _lines(outer, lines, l_in, g):
    """p in [0.5, 4], q in [-3, 3]; the first lines: the ends of the TPU
    adjoint's domain, the identity, lines wholly off either end, p below the
    domain, p = 0 and a flip."""
    p = torch.empty(outer * lines, device=g.device).uniform_(0.5, 4.0, generator=g)
    q = torch.empty(outer * lines, device=g.device).uniform_(-3.0, 3.0, generator=g)
    corner = [(0.5, 0.3), (4.0, -1.7), (1.0, 0.0), (1.0, -3.0 * l_in - 5.0),
              (1.0, 3.0 * l_in + 5.0), (0.25, 0.4), (0.0, 0.5 * (l_in - 1)), (-1.0, l_in - 1.0)]
    for i, (pv, qv) in enumerate(corner[:outer * lines]):
        p[i], q[i] = pv, qv
    return p.view(outer, lines), q.view(outer, lines)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", [True, False])
@pytest.mark.parametrize("mode", ["cubic", "linear"])
@pytest.mark.parametrize("shape,l_out,channels", [
    ((512, 256, 3), 256, 3), ((2, 256, 768), 256, 3),  # the warp's x- and y-pass views
    ((64, 100, 1), 100, 1), ((16, 40, 6), 57, 3), ((7, 33, 10), 20, 5),
    ((15, 17, 5), 17, 5), ((1, 15, 85), 15, 5),
    ((4, 1, 6), 1, 3), ((4, 2, 6), 5, 3), ((4, 3, 6), 3, 3), ((3, 1, 1), 4, 1)])
def test_resample_kernels_match_plain(cuda, shape, l_out, channels, mode, border, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    p, q = _lines(shape[0], shape[2] // channels, shape[1], g)
    ct = torch.randn((shape[0], l_out, shape[2]), device=cuda, generator=g)
    before = (rkernel.FWD_LAUNCHES, rkernel.ADJOINT_LAUNCHES, rkernel.GRADPOS_LAUNCHES)
    out = rkernel.resample_fwd(x, p, q, l_out, mode, border, channels)
    gx = rkernel.resample_adjoint(ct, p, q, shape[1], mode, border, channels)
    gp, gq = rkernel.resample_gradpos(x, ct, p, q, mode, border, channels)
    torch.cuda.synchronize()
    assert (rkernel.FWD_LAUNCHES, rkernel.ADJOINT_LAUNCHES, rkernel.GRADPOS_LAUNCHES) == \
        tuple(b + 1 for b in before)
    assert out.dtype == gx.dtype == gp.dtype == torch.float32
    xp, pp, qp = x.float().requires_grad_(), p.clone().requires_grad_(), q.clone().requires_grad_()
    want = resample.resample_axis_plain(xp, pp, qp, l_out, mode, border, channels)
    wx, wp, wq = torch.autograd.grad(want, (xp, pp, qp), ct)
    _close(out, want.detach(), 2e-5)
    _close(gx, wx, 2e-5)
    _close(gp, wp, 2e-4)
    _close(gq, wq, 2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,padding", [("bicubic", "border"), ("bilinear", "zeros")])
def test_separable_warp_autograd_runs_the_kernels(cuda, mode, padding, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    src = torch.randn((2, 64, 48, 3), device=cuda, generator=g).to(dtype)
    theta = torch.tensor([[[0.98, 0.03, 0.01], [-0.03, 1.02, -0.02]]], device=cuda).repeat(2, 1, 1)
    ct = torch.randn((2, 64, 48, 3), device=cuda, generator=g)
    s, t = src.clone().requires_grad_(), theta.clone().requires_grad_()
    before = (rkernel.FWD_LAUNCHES, rkernel.ADJOINT_LAUNCHES, rkernel.GRADPOS_LAUNCHES)
    out = resample.warp_affine_separable(s, t, mode, padding)
    assert out.dtype == dtype
    (out.float() * ct).sum().backward()
    torch.cuda.synchronize()
    # both passes forward; both adjoints (src wants its gradient here) and
    # both position gradients backward
    assert (rkernel.FWD_LAUNCHES, rkernel.ADJOINT_LAUNCHES, rkernel.GRADPOS_LAUNCHES) == \
        (before[0] + 2, before[1] + 2, before[2] + 2)
    sp, tp = src.float().requires_grad_(), theta.clone().requires_grad_()
    with mock.patch.object(resample, "resample_axis", resample.resample_axis_plain):
        want = resample.warp_affine_separable(sp, tp, mode, padding)
        (want * ct).sum().backward()
    if dtype == torch.float32:
        _close(out, want.detach(), 2e-5)
        _close(s.grad, sp.grad, 2e-5)
    else:  # the output and src's gradient are rounded to bf16 once
        torch.testing.assert_close(out.float(), want.detach(), atol=8e-3, rtol=8e-3)
        torch.testing.assert_close(s.grad.float(), sp.grad, atol=8e-3, rtol=8e-3)
    _close(t.grad, tp.grad, 2e-4 if dtype == torch.float32 else 2e-2)


def test_resample_needs_no_adjoint_for_a_source_without_gradient(cuda):
    src = torch.randn(1, 16, 16, 3, device=cuda)
    theta = torch.tensor([[[1.0, 0.02, 0.0], [0.0, 1.0, 0.01]]], device=cuda, requires_grad=True)
    before = (rkernel.ADJOINT_LAUNCHES, rkernel.GRADPOS_LAUNCHES)
    resample.warp_affine_separable(src, theta).sum().backward()
    torch.cuda.synchronize()
    # the x-pass reads src (no gradient wanted): only the y-pass runs its adjoint
    assert (rkernel.ADJOINT_LAUNCHES, rkernel.GRADPOS_LAUNCHES) == (before[0] + 1, before[1] + 2)
    assert theta.grad is not None and bool(torch.isfinite(theta.grad).all())


def test_resample_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 8, 6, device=cuda)
    p = q = torch.ones(4, 2, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rkernel.resample_fwd(x.transpose(1, 2), p, q, 8, "cubic", True, 3)
    with pytest.raises(TypeError):
        rkernel.resample_fwd(x.half(), p, q, 8, "cubic", True, 3)
    with pytest.raises(TypeError):
        rkernel.resample_adjoint(x.bfloat16(), p, q, 8, "cubic", True, 3)
    with pytest.raises(ValueError, match="multiple of channels"):
        rkernel.resample_fwd(x, p, q, 8, "cubic", True, 4)
    with pytest.raises(ValueError, match="must be a contiguous float32"):
        rkernel.resample_fwd(x, p[:, :1], q, 8, "cubic", True, 3)
    with pytest.raises(ValueError, match="mode must be"):
        rkernel.resample_fwd(x, p, q, 8, "nearest", True, 3)
    with pytest.raises(ValueError, match="does not belong"):
        rkernel.resample_gradpos(x, torch.randn(3, 8, 6, device=cuda), p, q, "cubic", True, 3)
