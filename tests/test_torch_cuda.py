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
each x max(1, max|plain|). Dense grid_sample: the forward within 1e-5 x
max(1, max|plain|) in float32 and one bf16 ulp in bfloat16; both gradients
within 1e-4 x max(1, max|plain|) (the image gradient is summed with float32
atomics in an order that changes from run to run, the grid gradient over the
channels in another order than autograd). Flash attention: the float32
forward within 2e-5 x max(1, max|plain|) (exp2f's 2 ulp, sums over up to 16384
keys in another order), its gradients within 1e-4 x max(1, max|plain|) (sums
of products of p and dp - di, which cancel), bfloat16 within 2e-2 x max(5e-3,
max|plain|) (the tensor-core forward rounds the unnormalised probability, the
plain version the normalised one; the tensor-core backward, fed the forward
kernel's lse, rounds P and dS to bfloat16 for its products, the plain
version's autograd rounds P, dP and dS); the forward's lse within 2e-5 x
max(1, max|lse|) of the float32 log-sum-exp.
"""

from unittest import mock

import pytest
import torch

from tfcgan_tpu_torch.ops import blurpool, flashattn, gridsample, resample
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel
from tfcgan_tpu_torch.ops.kernels import flashattn as fkernel
from tfcgan_tpu_torch.ops.kernels import gridsample as gkernel
from tfcgan_tpu_torch.ops.kernels import resample as rkernel
from tfcgan_tpu_torch.ops.warp import affine_grid

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


def _plain_blur_grad(dy, h, w, stride):
    x = torch.zeros((dy.shape[0], h, w, dy.shape[3]), device=dy.device, requires_grad=True)
    return torch.autograd.grad(blurpool.blur_pool_padded(x, stride), x, dy.float())[0]


def _blur_dy(shape, stride, dtype, g):
    n, h, w, c = shape
    return torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                       device=g.device, generator=g).to(dtype)


def _assert_blur_grad(got, want, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0, msg=what)
    else:
        torch.testing.assert_close(got.float(), want.to(dtype).float(), atol=8e-3, rtol=8e-3,
                                   msg=what)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [6, 8, 12, 24, 64, 136])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_backward_blocks_on_small_and_odd_maps(cuda, c, stride, dtype):
    """The backward's 2 x 2 blocks of dx pixels at every H, W in {4, 5, 6, 7,
    33}: border and interior blocks, odd edges where a block holds one row or
    column. Every access width: one scalar (C = 6 in bfloat16), 8 bytes (at
    stride 1 up to 256 bytes a pixel; C = 6 in float32, where 16 bytes do not
    divide a pixel) and 16 bytes (stride 2; C = 136 at stride 1); 64 is the
    path's narrowest C."""
    g = torch.Generator(device=cuda).manual_seed(2)
    for h in (4, 5, 6, 7, 33):
        for w in (4, 5, 6, 7, 33):
            dy = _blur_dy((2, h, w, c), stride, dtype, g)
            got = kernel.blur_pool_bwd(dy, h, w, stride)
            _assert_blur_grad(got, _plain_blur_grad(dy, h, w, stride), dtype,
                              lambda m, h=h, w=w: f"H={h} W={w}: {m}")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_backward_takes_a_misaligned_dy(cuda, stride, dtype):
    """A contiguous dy at an odd storage offset (2 or 4 bytes off a 16-byte
    boundary) takes the scalar path: the same sums in the same order, so the
    same bits as the 16-byte path on an aligned copy."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n, h, w, c = 2, 33, 31, 64
    aligned = _blur_dy((n, h, w, c), stride, dtype, g)
    flat = torch.empty(aligned.numel() + 1, dtype=dtype, device=cuda)
    dy = flat[1:].view(aligned.shape)
    dy.copy_(aligned)
    assert dy.is_contiguous() and dy.data_ptr() % 16 != 0
    got = kernel.blur_pool_bwd(dy, h, w, stride)
    _assert_blur_grad(got, _plain_blur_grad(aligned, h, w, stride), dtype, lambda m: m)
    assert torch.equal(got, kernel.blur_pool_bwd(aligned, h, w, stride))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_backward_repeats_bit_for_bit(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    for shape, stride in (((8, 255, 255, 64), 2), ((8, 128, 128, 64), 1), ((8, 7, 7, 512), 2),
                          ((8, 8, 8, 512), 1), ((1, 15, 17, 5), 2), ((2, 2, 2, 8), 1)):
        dy = _blur_dy(shape, stride, dtype, g)
        first, second = (kernel.blur_pool_bwd(dy, *shape[1:3], stride) for _ in range(2))
        assert torch.equal(first, second), (shape, stride)


def _assert_blur_fwd(got, x, stride, what):
    want = blurpool.blur_pool_padded(x.float(), stride).to(x.dtype)
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0, msg=what)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=8e-3, rtol=8e-3, msg=what)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [5, 4, 6, 8, 64, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_forward_strips_on_small_and_odd_maps(cuda, c, stride, dtype):
    """The forward's strips of output rows at every H, W in {1, 2, 3, 7, 8,
    15, 16, 33}: maps all border, tail strips shorter than a strip, non-square
    maps. Both access widths: one scalar (odd C, and C = 6 in float32 and 4 in
    bfloat16, where 16 bytes do not divide a pixel) and 16 bytes (C = 4 in
    float32, 8, 64 and 512 in bfloat16; 64 is the path's narrowest C, 512 its
    widest)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for h in (1, 2, 3, 7, 8, 15, 16, 33):
        for w in (1, 2, 3, 7, 8, 15, 16, 33):
            x = torch.randn((2, h, w, c), device=cuda, generator=g).to(dtype)
            _assert_blur_fwd(kernel.blur_pool_fwd(x, stride), x, stride,
                             lambda m, h=h, w=w: f"H={h} W={w}: {m}")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_forward_takes_a_misaligned_x(cuda, stride, dtype):
    """A contiguous x at an odd storage offset takes the scalar path: the same
    sums in the same order, so the same bits as the 16-byte path."""
    g = torch.Generator(device=cuda).manual_seed(6)
    aligned = torch.randn((2, 33, 31, 64), device=cuda, generator=g).to(dtype)
    flat = torch.empty(aligned.numel() + 1, dtype=dtype, device=cuda)
    x = flat[1:].view(aligned.shape)
    x.copy_(aligned)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = kernel.blur_pool_fwd(x, stride)
    _assert_blur_fwd(got, aligned, stride, lambda m: m)
    assert torch.equal(got, kernel.blur_pool_fwd(aligned, stride))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blurpool_forward_repeats_bit_for_bit(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(7)
    for shape, stride in (((8, 255, 255, 64), 2), ((8, 128, 128, 64), 1), ((8, 7, 7, 512), 2),
                          ((8, 8, 8, 512), 1), ((1, 15, 17, 5), 2), ((2, 2, 2, 8), 1)):
        x = torch.randn(shape, device=cuda, generator=g).to(dtype)
        first, second = (kernel.blur_pool_fwd(x, stride) for _ in range(2))
        assert torch.equal(first, second), (shape, stride)


@pytest.mark.parametrize("stride", [1, 2])
def test_blurpool_takes_more_images_than_one_grid(cuda, stride):
    """More than 65535 images (the grid's z limit) go in several launches,
    forward and backward; the images of the second launch come out as they do
    alone."""
    g = torch.Generator(device=cuda).manual_seed(10)
    shape = (65535 + 3, 5, 4, 8)
    x = torch.randn(shape, device=cuda, generator=g).to(torch.bfloat16)
    y = kernel.blur_pool_fwd(x, stride)
    _assert_blur_fwd(y, x, stride, lambda m: m)
    assert torch.equal(y[-3:], kernel.blur_pool_fwd(x[-3:].contiguous(), stride))
    dy = _blur_dy(shape, stride, torch.bfloat16, g)
    dx = kernel.blur_pool_bwd(dy, 5, 4, stride)
    _assert_blur_grad(dx, _plain_blur_grad(dy, 5, 4, stride), torch.bfloat16, lambda m: m)
    assert torch.equal(dx[-3:], kernel.blur_pool_bwd(dy[-3:].contiguous(), 5, 4, stride))


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


def _views(n, h, w, c, g, dtype):
    """The x-pass view (N*H, W, C) and the y-pass view (N, H, W*C) of one
    image, each with its lines' p and q: ``_lines`` with p = 0 and |p| < 0.5
    in the first lines after the identity."""
    img = torch.randn((n, h, w, c), device=g.device, generator=g).to(dtype)
    out = []
    for x in (img.view(n * h, w, c), img.view(n, h, w * c)):
        p, q = _lines(x.shape[0], x.shape[2] // c, x.shape[1], g)
        p.view(-1)[:4] = torch.tensor([1.0, 0.0, 0.3, -0.45], device=g.device)
        out.append((x, p, q))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", [True, False])
@pytest.mark.parametrize("mode", ["cubic", "linear"])
def test_resample_forward_per_line_taps(cuda, mode, border, dtype):
    """The forward's taps computed once a (line, position) and applied to the
    line's channels: x-pass and y-pass views, 1 and 3 channels a line."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for c in (1, 3):
        for x, p, q in _views(2, 19, 23, c, g, dtype):
            for l_out in (x.shape[1], 2 * x.shape[1] + 1):
                got = rkernel.resample_fwd(x, p, q, l_out, mode, border, c)
                want = resample.resample_axis_plain(x.float(), p, q, l_out, mode, border, c)
                _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample_forward_repeats_bit_for_bit(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    for x, p, q in _views(8, 256, 256, 3, g, dtype):
        first, second = (rkernel.resample_fwd(x, p, q, 256, "cubic", True, 3)
                         for _ in range(2))
        assert torch.equal(first, second), tuple(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample_backward_repeats_bit_for_bit(cuda, dtype):
    """The adjoint and the position gradient sum in a fixed order: twice on
    the same inputs, the warp's two views, the same bits."""
    g = torch.Generator(device=cuda).manual_seed(10)
    for x, p, q in _views(8, 256, 256, 3, g, dtype):
        ct = torch.randn(x.shape, device=cuda, generator=g)
        first, second = ((rkernel.resample_adjoint(ct, p, q, 256, "cubic", True, 3),
                          *rkernel.resample_gradpos(x, ct, p, q, "cubic", True, 3))
                         for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second)), tuple(x.shape)


def _edge_lines(outer, lines, l_in, l_out, g):
    """p in [-4, 4], q in [-l_in, 2 l_in]; the first lines: over both ends (p =
    2 from q = -3, its flip, a slope that spans the line and 3 elements beyond
    each end), p = 0 inside, near either end and beyond either end, p < 0
    across the low end and across both, a half-element shift, a start below 0."""
    p = torch.empty(outer * lines, device=g.device).uniform_(-4.0, 4.0, generator=g)
    q = torch.empty(outer * lines, device=g.device).uniform_(-l_in, 2.0 * l_in, generator=g)
    corner = [(2.0, -3.0), (-2.0, l_in + 2.0), ((l_in + 6.0) / l_out, -3.0),
              (0.0, 0.5 * (l_in - 1)), (0.0, -0.7), (0.0, l_in - 1.3), (0.0, -5.0),
              (0.0, l_in + 4.0), (-1.5, l_in + 2.0), (-0.3, 1.0), (-4.0, 3.0 * l_in),
              (1.0, 0.5), (0.7, -2.5)]
    for i, (pv, qv) in enumerate(corner[:outer * lines]):
        p[i], q[i] = pv, qv
    return p.view(outer, lines), q.view(outer, lines)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", [True, False])
@pytest.mark.parametrize("mode", ["cubic", "linear"])
def test_resample_edge_lines_match_plain(cuda, mode, border, dtype):
    """The edge masses the adjoint adds in its own launch (border clamping),
    at lines of 1-3 elements (the first element also the last at 1) and of 40,
    and the channel loop at run time (1, 5, 10, 300 channels) beside the
    unrolled one (3): all three kernels against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(11)
    for channels in (1, 3, 5, 10, 300):
        for l_in, l_out in ((1, 4), (2, 5), (3, 3), (40, 57)):
            x = torch.randn((8, l_in, 2 * channels), device=cuda, generator=g).to(dtype)
            p, q = _edge_lines(8, 2, l_in, l_out, g)
            ct = torch.randn((8, l_out, 2 * channels), device=cuda, generator=g)
            out = rkernel.resample_fwd(x, p, q, l_out, mode, border, channels)
            gx = rkernel.resample_adjoint(ct, p, q, l_in, mode, border, channels)
            gp, gq = rkernel.resample_gradpos(x, ct, p, q, mode, border, channels)
            xp, pp, qp = (x.float().requires_grad_(), p.clone().requires_grad_(),
                          q.clone().requires_grad_())
            want = resample.resample_axis_plain(xp, pp, qp, l_out, mode, border, channels)
            wx, wp, wq = torch.autograd.grad(want, (xp, pp, qp), ct)
            _close(out, want.detach(), 2e-5)
            _close(gx, wx, 2e-5)
            _close(gp, wp, 2e-4)
            _close(gq, wq, 2e-4)


def test_resample_adjoint_is_one_launch_without_scratch(cuda):
    """The edge masses are the adjoint kernel's own work: one kernel on the
    card and one allocation (dx) a call, at both views."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(12)
    for x, p, q in _views(2, 32, 40, 3, g, torch.float32):
        ct = torch.randn(x.shape, device=cuda, generator=g)

        def call():
            return rkernel.resample_adjoint(ct, p, q, x.shape[1], "cubic", True, 3)

        call()  # built and loaded
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
        launches = rkernel.ADJOINT_LAUNCHES
        call()
        torch.cuda.synchronize()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated + 1
        assert rkernel.ADJOINT_LAUNCHES == launches + 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        on_card = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(on_card) == 1 and "resample_adjoint_kernel" in on_card[0], on_card


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


# ------------------------------------------------------ dense grid_sample
PADDINGS = ("zeros", "border", "reflection")


def _identity_grid(n, h, w, device, align=False):
    theta = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=device).expand(n, 2, 3)
    return affine_grid(theta, (n, h, w), align_corners=align).contiguous()


def _k3_case(case, dtype, align, g):
    """(inp, grid) of one named case on g's device."""
    dev = g.device

    def rand(shape):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def uniform(shape, scale):
        return (torch.rand(shape, device=dev, generator=g) * 2 - 1) * scale

    if case.startswith("path"):  # (8, 256, 256, 6): A and fake_B stacked
        pixels = {"path-identity": 0.0, "path-0.3px": 0.3, "path-5px": 5.0}[case]
        base = _identity_grid(8, 256, 256, dev, align)
        return rand((8, 256, 256, 6)), base + uniform(base.shape, pixels * 2 / 256)
    if case in ("c1", "c2", "c3", "c6", "c8", "c300"):  # Hg, Wg != H, W; 300: 2 channels a thread
        return rand((2, 24, 40, int(case[1:]))), uniform((2, 16, 33, 2), 1.2)
    if case == "off-image":
        return rand((2, 24, 40, 3)), uniform((2, 16, 33, 2), 6.0)
    if case == "constant":  # 4096 outputs a sample on one spot
        return rand((2, 24, 40, 3)), torch.tensor((0.313, -0.477), device=dev).expand(
            2, 64, 64, 2).contiguous()
    if case == "identity-16":
        return rand((2, 16, 16, 3)), _identity_grid(2, 16, 16, dev, align)
    shape = {"1px": (2, 1, 1, 3), "2x3px": (2, 2, 3, 2), "3x1px": (1, 3, 1, 1)}[case]
    return rand(shape), uniform((shape[0], 5, 7, 2), 1.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("case", ["path-identity", "path-0.3px", "path-5px", "c1", "c2", "c3", "c6",
                                  "c8", "c300", "1px", "2x3px", "3x1px", "off-image", "constant",
                                  "identity-16"])
def test_gridsample_kernels_match_plain(cuda, case, padding, align, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    inp, grid = _k3_case(case, dtype, align, g)
    ct = torch.randn((*grid.shape[:3], inp.shape[3]), device=cuda, generator=g).to(dtype)
    before = (gkernel.FWD_LAUNCHES, gkernel.BWD_LAUNCHES)
    out = gkernel.gridsample_fwd(inp, grid, padding, align)
    d_inp, d_grid = gkernel.gridsample_bwd(ct, inp, grid, padding, align)
    torch.cuda.synchronize()
    assert (gkernel.FWD_LAUNCHES, gkernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and d_inp.dtype == d_grid.dtype == torch.float32
    ip, gp = inp.float().requires_grad_(), grid.clone().requires_grad_()
    want = gridsample.grid_sample_dense_plain(ip, gp, "bilinear", padding, align)
    wi, wg = torch.autograd.grad(want, (ip, gp), ct.float(), allow_unused=True)
    wg = torch.zeros_like(grid) if wg is None else wg  # reflection of a 1-pixel axis
    if dtype == torch.float32:
        _close(out, want.detach(), 1e-5)
    else:
        torch.testing.assert_close(out.float(), want.detach().to(dtype).float(), atol=8e-3,
                                   rtol=8e-3)
    _close(d_inp, wi, 1e-4)
    _close(d_grid, wg, 1e-4)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("padding", PADDINGS)
def test_gridsample_kernels_take_coordinates_no_int_holds(cuda, padding, align):
    g = torch.Generator(device=cuda).manual_seed(5)
    inp = torch.randn((2, 24, 40, 3), device=cuda, generator=g)
    grid = (torch.rand((2, 16, 33, 2), device=cuda, generator=g) * 2 - 1) * 1.2
    flat = grid.view(-1)
    for i, v in enumerate((1e10, -1e10, float("inf"), float("-inf"), float("nan"), 3e38)):
        flat[7 * i + 3] = v
    flat[200], flat[201] = float("nan"), float("inf")
    ct = torch.randn((2, 16, 33, 3), device=cuda, generator=g)
    out = gkernel.gridsample_fwd(inp, grid, padding, align)
    d_inp, d_grid = gkernel.gridsample_bwd(ct, inp, grid, padding, align)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in (out, d_inp, d_grid))
    bad = ~(grid.abs() <= 1e30)  # inf, NaN, and 3e38, which overflows in pixels
    keep = ~bad.any(dim=-1, keepdim=True)
    assert not bool(d_grid[bad].any())
    if padding == "zeros":
        assert not bool(out[~keep.expand_as(out)].any())
    # the other samples (1e10 among them) against the plain version
    ip = inp.clone().requires_grad_()
    gp = torch.where(bad, torch.zeros_like(grid), grid).requires_grad_()
    want = gridsample.grid_sample_dense_plain(ip, gp, "bilinear", padding, align)
    wi, wg = torch.autograd.grad(want, (ip, gp), ct * keep)
    d_inp, d_grid = gkernel.gridsample_bwd(ct * keep, inp, grid, padding, align)
    _close(out * keep, want.detach() * keep, 1e-5)
    _close(d_inp, wi, 1e-4)
    _close(d_grid * keep, wg * keep, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["path-0.3px", "c1", "c3", "c8", "c300", "constant", "identity-16",
                                  "non-finite"])
def test_gridsample_backward_repeats(cuda, case, dtype):
    """Two identical backward runs: the grid gradient (one writer, its channel
    shares summed in one order) bit for bit, the image gradient (atomics in
    an order that changes) within 1e-4 x max(1, max|g|); both finite."""
    g = torch.Generator(device=cuda).manual_seed(8)
    if case == "non-finite":
        inp = torch.randn((2, 24, 40, 3), device=cuda, generator=g).to(dtype)
        grid = (torch.rand((2, 16, 33, 2), device=cuda, generator=g) * 2 - 1) * 1.2
        flat = grid.view(-1)
        for i, v in enumerate((1e10, -1e10, float("inf"), float("-inf"), float("nan"), 3e38)):
            flat[7 * i + 3] = v
    else:
        inp, grid = _k3_case(case, dtype, False, g)
    ct = torch.randn((*grid.shape[:3], inp.shape[3]), device=cuda, generator=g).to(dtype)
    for padding in PADDINGS:
        first, second = (gkernel.gridsample_bwd(ct, inp, grid, padding) for _ in range(2))
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in (*first, *second))
        assert torch.equal(first[1], second[1]), padding
        _close(first[0], second[0], 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gridsample_forward_repeats_bit_for_bit(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    inp, grid = _k3_case("path-0.3px", dtype, False, g)
    for padding in PADDINGS:
        first, second = (gkernel.gridsample_fwd(inp, grid, padding) for _ in range(2))
        assert torch.equal(first, second), padding


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 8])
def test_gridsample_forward_takes_misaligned_tensors(cuda, c, dtype):
    """An image and a grid at an odd storage offset take the narrower loads
    (one scalar a channel, two scalar grid loads): the same bits as the wide
    loads on aligned copies."""
    g = torch.Generator(device=cuda).manual_seed(10)
    inp = torch.randn((2, 24, 40, c), device=cuda, generator=g).to(dtype)
    grid = (torch.rand((2, 16, 33, 2), device=cuda, generator=g) * 2 - 1) * 1.2
    views = []
    for t in (inp, grid):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        views.append(flat[1:].view(t.shape).copy_(t))
    assert all(v.is_contiguous() and v.data_ptr() % 8 != 0 for v in views)
    for padding in PADDINGS:
        assert torch.equal(gkernel.gridsample_fwd(*views, padding),
                           gkernel.gridsample_fwd(inp, grid, padding)), padding


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_sample_dense_autograd_runs_both_kernels_once(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    inp = torch.randn((2, 32, 48, 6), device=cuda, generator=g).to(dtype)
    grid = _identity_grid(2, 32, 48, cuda) + (torch.rand((2, 32, 48, 2), device=cuda,
                                                         generator=g) - 0.5) * 0.1
    ct = torch.randn((2, 32, 48, 6), device=cuda, generator=g)
    i, gr = inp.clone().requires_grad_(), grid.clone().requires_grad_()
    before = (gkernel.FWD_LAUNCHES, gkernel.BWD_LAUNCHES)
    out = gridsample.grid_sample_dense(i, gr)
    assert out.dtype == dtype
    (out.float() * ct).sum().backward()
    torch.cuda.synchronize()
    assert (gkernel.FWD_LAUNCHES, gkernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert i.grad.dtype == dtype and gr.grad.dtype == torch.float32
    ip, gp = inp.float().requires_grad_(), grid.clone().requires_grad_()
    (gridsample.grid_sample_dense_plain(ip, gp) * ct).sum().backward()
    if dtype == torch.float32:
        _close(i.grad, ip.grad, 1e-4)
        _close(gr.grad, gp.grad, 1e-4)
    else:  # the output gradient and the image gradient are rounded to bf16 once
        torch.testing.assert_close(i.grad.float(), ip.grad, atol=8e-3, rtol=8e-3)
        _close(gr.grad, gp.grad, 2e-2)
    # only the gradient that is asked for
    before = gkernel.BWD_LAUNCHES
    gr2 = grid.clone().requires_grad_()
    gridsample.grid_sample_dense(inp, gr2).float().sum().backward()
    torch.cuda.synchronize()
    assert gkernel.BWD_LAUNCHES == before + 1 and gr2.grad is not None


def test_gridsample_identity_grid_gradient_is_the_plain_one(cuda):
    """Zero offsets: every sample on an integer coordinate, where the grid
    gradient is one-sided; the kernel must floor to the plain version's side."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for size in (256, 24):  # 24: the coordinates are not exact in float32
        inp = torch.randn((2, size, size, 6), device=cuda, generator=g)
        grid = _identity_grid(2, size, size, cuda)
        ct = torch.randn((2, size, size, 6), device=cuda, generator=g)
        _, d_grid = gkernel.gridsample_bwd(ct, inp, grid, need_inp=False)
        gp = grid.clone().requires_grad_()
        (wg,) = torch.autograd.grad(gridsample.grid_sample_dense_plain(inp, gp), gp, ct)
        assert float(wg.abs().max()) > 1.0
        _close(d_grid, wg, 1e-4)


def test_gridsample_kernels_refuse_what_they_do_not_take(cuda):
    inp = torch.randn(2, 8, 8, 3, device=cuda)
    grid = torch.zeros(2, 4, 4, 2, device=cuda)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        gkernel.gridsample_fwd(inp.permute(0, 2, 1, 3), grid)
    with pytest.raises(TypeError):
        gkernel.gridsample_fwd(inp.half(), grid)
    with pytest.raises(TypeError, match="float32 grid"):
        gkernel.gridsample_fwd(inp, grid.bfloat16())
    with pytest.raises(ValueError, match="grid"):
        gkernel.gridsample_fwd(inp, grid[:1])
    with pytest.raises(ValueError, match="padding_mode"):
        gkernel.gridsample_fwd(inp, grid, "wrap")
    with pytest.raises(ValueError, match="g must be"):
        gkernel.gridsample_bwd(torch.zeros(2, 4, 4, 2, device=cuda), inp, grid)
    assert gkernel.gridsample_bwd(torch.zeros(2, 4, 4, 3, device=cuda), inp, grid,
                                  need_inp=False, need_grid=False) == (None, None)


# ------------------------------------------------------- flash attention (K4)
# (forward, gradients, floor): errors within tolerance x max(floor, max|plain|).
# bfloat16 is held to two to three ulps of the largest value whatever its size
# (0.15 at S = 4096); its floor keeps the window no tighter than float32's where
# the plain gradient is exactly 0 (a single key)
FLASH_TOL = {torch.float32: (2e-5, 1e-4, 1.0), torch.bfloat16: (2e-2, 2e-2, 5e-3)}


def _flash_inputs(cuda, n, heads, d, s, dtype, views, seed=0):
    """q, k, v and the upstream gradient as (N, heads, D, S): permuted views of
    (N, S, heads * D) tensors, as the diffusion U-Net passes them, or dense."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if views:
        return [torch.randn((n, s, heads * d), device=cuda, generator=g).to(dtype)
                .view(n, s, heads, d).permute(0, 2, 3, 1) for _ in range(4)]
    return [torch.randn((n, heads, d, s), device=cuda, generator=g).to(dtype) for _ in range(4)]


def _flash_grads(fn, q, k, v, g, scale):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, scale)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), g))


def _flash_close(got, want, tol, what, floor=1.0):
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(floor, float(want.abs().max())), f"{what}: max abs err {err}"


@pytest.mark.parametrize("views", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 8, 8, 4096), (8, 8, 8, 1024), (32, 8, 8, 1024),
                                   (2, 8, 8, 16384), (2, 3, 8, 1), (2, 3, 8, 7), (2, 3, 8, 255),
                                   (2, 3, 8, 1000), (2, 2, 16, 1000), (2, 2, 32, 1000),
                                   (2, 2, 64, 1000), (1, 2, 64, 512)])
def test_flashattn_kernels_match_plain(cuda, shape, dtype, views):
    q, k, v, g = _flash_inputs(cuda, *shape, dtype, views)
    scale = shape[2] ** -0.5
    before = (fkernel.FWD_LAUNCHES, fkernel.DQ_LAUNCHES, fkernel.DKV_LAUNCHES)
    got = _flash_grads(flashattn.flash_attention, q, k, v, g, scale)
    assert (fkernel.FWD_LAUNCHES, fkernel.DQ_LAUNCHES, fkernel.DKV_LAUNCHES) == tuple(
        b + 1 for b in before)
    assert got[0].stride() == q.stride()  # the result in q's memory order, no copy
    want = _flash_grads(flashattn.flash_attention_plain, q, k, v, g, scale)
    tol_f, tol_g, floor = FLASH_TOL[dtype]
    for a, b, tol, name in zip(got, want, (tol_f, tol_g, tol_g, tol_g), ("o", "dq", "dk", "dv")):
        _flash_close(a, b, tol, f"{shape} {dtype} {name}", floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flashattn_path_shape_at_batch_32(cuda, dtype):
    q, k, v, g = _flash_inputs(cuda, 32, 8, 8, 4096, dtype, True)
    got = _flash_grads(flashattn.flash_attention, q, k, v, g, 8 ** -0.5)
    want = _flash_grads(flashattn.flash_attention_plain, q, k, v, g, 8 ** -0.5)
    tol_f, tol_g, floor = FLASH_TOL[dtype]
    for a, b, tol, name in zip(got, want, (tol_f, tol_g, tol_g, tol_g), ("o", "dq", "dk", "dv")):
        _flash_close(a, b, tol, f"(32, 8, 8, 4096) {dtype} {name}", floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flashattn_large_scores_do_not_overflow(cuda, dtype):
    q, k, v, g = _flash_inputs(cuda, 2, 4, 8, 700, dtype, True, seed=3)
    got = _flash_grads(flashattn.flash_attention, 40.0 * q, k, v, g, 1.0)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    want = _flash_grads(flashattn.flash_attention_plain, 40.0 * q, k, v, g, 1.0)
    tol_f, tol_g, floor = FLASH_TOL[dtype]
    for a, b, tol, name in zip(got, want, (tol_f, tol_g, tol_g, tol_g), ("o", "dq", "dk", "dv")):
        _flash_close(a, b, tol, f"q x 40 {dtype} {name}", floor)


@pytest.mark.parametrize("need", [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1),
                                  (1, 0, 1)])
def test_flashattn_backward_computes_only_what_autograd_asks_for(cuda, need):
    q, k, v, g = _flash_inputs(cuda, 4, 8, 8, 1000, torch.bfloat16, True, seed=5)
    full = _flash_grads(flashattn.flash_attention, q, k, v, g, 0.35)[1:]
    ts = [t.detach().requires_grad_(bool(r)) for t, r in zip((q, k, v), need)]
    before = (fkernel.DQ_LAUNCHES, fkernel.DKV_LAUNCHES)
    out = flashattn.flash_attention(*ts, 0.35)
    grads = torch.autograd.grad(out, [t for t in ts if t.requires_grad], g)
    assert fkernel.DQ_LAUNCHES - before[0] == need[0]
    assert fkernel.DKV_LAUNCHES - before[1] == int(bool(need[1] or need[2]))
    for got, ref in zip(grads, [f for f, r in zip(full, need) if r]):
        assert torch.equal(got, ref)  # one writer per element: bit for bit


def test_flashattn_backward_repeats_bit_for_bit(cuda):
    q, k, v, g = _flash_inputs(cuda, 8, 8, 8, 4096, torch.float32, True, seed=6)
    first = _flash_grads(flashattn.flash_attention, q, k, v, g, 8 ** -0.5)
    second = _flash_grads(flashattn.flash_attention, q, k, v, g, 8 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _tc_counts():
    return fkernel.FWD_TC_LAUNCHES, fkernel.DQ_TC_LAUNCHES, fkernel.DKV_TC_LAUNCHES


@pytest.mark.parametrize("views", [True, False])
@pytest.mark.parametrize("s", [1, 7, 255, 1000])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_flashattn_bf16_backward_runs_on_the_tensor_cores(cuda, d, s, views):
    q, k, v, g = _flash_inputs(cuda, 2, 3, d, s, torch.bfloat16, views, seed=d + s)
    before = _tc_counts()
    got = _flash_grads(flashattn.flash_attention, q, k, v, g, d ** -0.5)
    assert _tc_counts() == tuple(b + 1 for b in before)  # forward, dq, dk/dv
    want = _flash_grads(flashattn.flash_attention_plain, q, k, v, g, d ** -0.5)
    _, tol_g, floor = FLASH_TOL[torch.bfloat16]
    for a, b, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        _flash_close(a, b, tol_g, f"D={d} S={s} views={views} {name}", floor)


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_flashattn_bf16_backward_with_large_scores(cuda, d):
    q, k, v, g = _flash_inputs(cuda, 2, 4, d, 700, torch.bfloat16, True, seed=d)
    got = _flash_grads(flashattn.flash_attention, 40.0 * q, k, v, g, 1.0)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    want = _flash_grads(flashattn.flash_attention_plain, 40.0 * q, k, v, g, 1.0)
    _, tol_g, floor = FLASH_TOL[torch.bfloat16]
    for a, b, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        _flash_close(a, b, tol_g, f"q x 40 D={d} {name}", floor)


def test_flashattn_bf16_backward_repeats_bit_for_bit(cuda):
    q, k, v, g = _flash_inputs(cuda, 8, 8, 8, 4096, torch.bfloat16, True, seed=7)
    first = _flash_grads(flashattn.flash_attention, q, k, v, g, 8 ** -0.5)
    second = _flash_grads(flashattn.flash_attention, q, k, v, g, 8 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flashattn_tensor_core_counts_move_only_for_bf16(cuda, dtype):
    q, k, v, g = _flash_inputs(cuda, 2, 2, 8, 100, dtype, True)
    before, plain = _tc_counts(), (fkernel.FWD_LAUNCHES, fkernel.DQ_LAUNCHES,
                                   fkernel.DKV_LAUNCHES)
    o, lse = fkernel.flashattn_fwd(q, k, v, 0.35)
    di = (o.float() * g.float()).sum(dim=2).contiguous()
    fkernel.flashattn_bwd(q, k, v, g, lse, di, 0.35)
    assert (fkernel.FWD_LAUNCHES, fkernel.DQ_LAUNCHES, fkernel.DKV_LAUNCHES) == tuple(
        b + 1 for b in plain)
    tc = int(dtype == torch.bfloat16)
    assert _tc_counts() == tuple(b + tc for b in before)


@pytest.mark.parametrize("views", [True, False])
@pytest.mark.parametrize("s", [1, 7, 255, 1000, 4096])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_flashattn_bf16_forward_runs_on_the_tensor_cores(cuda, d, s, views):
    """The bf16 forward kernel alone: its output against the plain version,
    its lse against the float32 log-sum-exp of the same bf16 scores (2e-5 x
    max(1, max|lse|), the float32 forward's window), one tensor-core launch."""
    q, k, v, _ = _flash_inputs(cuda, 2, 3, d, s, torch.bfloat16, views, seed=d * s)
    before = _tc_counts()
    o, lse = fkernel.flashattn_fwd(q, k, v, d ** -0.5)
    assert _tc_counts() == (before[0] + 1, *before[1:])
    assert o.stride() == q.stride() and lse.dtype == torch.float32
    tol_f, _, floor = FLASH_TOL[torch.bfloat16]
    _flash_close(o, flashattn.flash_attention_plain(q, k, v, d ** -0.5), tol_f,
                 f"D={d} S={s} views={views} o", floor)
    scores = torch.matmul(q.float().transpose(-1, -2), k.float()) * d ** -0.5
    _flash_close(lse, torch.logsumexp(scores, dim=-1), 2e-5, f"D={d} S={s} lse")


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_flashattn_bf16_forward_with_large_scores_and_a_negative_scale(cuda, d):
    q, k, v, _ = _flash_inputs(cuda, 2, 4, d, 700, torch.bfloat16, True, seed=d + 1)
    tol_f, _, floor = FLASH_TOL[torch.bfloat16]
    for qs, scale in ((40.0 * q, 1.0), (q, -0.3)):
        got = fkernel.flashattn_fwd(qs, k, v, scale)[0]
        assert bool(torch.isfinite(got).all())
        _flash_close(got, flashattn.flash_attention_plain(qs, k, v, scale), tol_f,
                     f"D={d} scale {scale}", floor)


def test_flashattn_bf16_forward_repeats_bit_for_bit(cuda):
    q, k, v, _ = _flash_inputs(cuda, 8, 8, 8, 4096, torch.bfloat16, True, seed=9)
    first, second = (fkernel.flashattn_fwd(q, k, v, 8 ** -0.5) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_flashattn_three_dimensional_entry_and_no_grad(cuda):
    q, k, v, _ = (t[0] for t in _flash_inputs(cuda, 1, 6, 8, 300, torch.float32, False))
    with torch.no_grad():
        got = flashattn.flash_attention(q, k, v, 0.35)
    assert got.shape == q.shape and not got.requires_grad
    _flash_close(got, flashattn.flash_attention_plain(q, k, v, 0.35), 2e-5, "(6, 8, 300)")


def test_flashattn_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, _ = _flash_inputs(cuda, 2, 2, 8, 64, torch.float32, False)
    with pytest.raises(ValueError, match="head_dim"):
        fkernel.flashattn_fwd(*_flash_inputs(cuda, 1, 1, 24, 8, torch.float32, False)[:3], 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fkernel.flashattn_fwd(q.half(), k.half(), v.half(), 1.0)
    with pytest.raises(ValueError, match="must be"):
        fkernel.flashattn_fwd(q, k[:, :1], v, 1.0)
    with pytest.raises(ValueError, match="must be"):
        fkernel.flashattn_fwd(q, k.bfloat16(), v, 1.0)
    with pytest.raises(ValueError, match="views"):
        fkernel.flashattn_fwd(q[0], k[0], v[0], 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fkernel.flashattn_fwd(q.cpu(), k.cpu(), v.cpu(), 1.0)
    o, lse = fkernel.flashattn_fwd(q, k, v, 1.0)
    with pytest.raises(ValueError, match="lse"):
        fkernel.flashattn_bwd(q, k, v, o, lse[..., :8], lse, 1.0)
    assert fkernel.flashattn_bwd(q, k, v, o, lse, lse, 1.0, False, False, False) == (
        None, None, None)


def test_diffusion_unet_forward_and_backward_through_the_kernels(cuda):
    """The denoiser at 64² (1024 and 256 tokens) in float32: output and
    parameter gradients on the kernel path against the plain path (atol 1e-4
    of the output; gradients within 1e-3 x max|g| + 1e-7)."""
    from tfcgan_tpu_torch.models import diffusion

    unet = diffusion.CondUNet(2, 1, device=cuda, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    x, cond = (torch.randn((2, 64, 64, 1), device=cuda, generator=g) for _ in range(2))
    t = torch.tensor([5, 400], device=cuda)
    launches = fkernel.FWD_LAUNCHES
    out = unet(x, t, cond)
    assert fkernel.FWD_LAUNCHES == launches + 7
    out.square().mean().backward()
    got = {n: p.grad.clone() for n, p in unet.named_parameters()}
    unet.zero_grad()
    with mock.patch.object(diffusion, "flash_attention", flashattn.flash_attention_plain):
        want_out = unet(x, t, cond)
        want_out.square().mean().backward()
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=0)
    for n, p in unet.named_parameters():
        bound = 1e-3 * float(p.grad.abs().max()) + 1e-7
        assert float((got[n] - p.grad).abs().max()) <= bound, n
