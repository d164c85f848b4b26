"""The port's 1-D affine resampler and separable warp (``ops/resample.py``)
against ``tfcgan_tpu.ops.pallas_kernels.resample``, float32 on the CPU.

The port runs its plain version here (a CPU tensor never reaches a CUDA
kernel); the JAX side runs its Pallas kernels in interpret mode, which its
dispatcher picks on the CPU backend. Tolerances after the JAX package's own
tests: 2e-5 on outputs and on the gradient to x (relative to the largest
element: sums of 2-4 products in another order), 2e-4 on gradients to p, q
and theta (sums over whole lines or images).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.ops.pallas_kernels import resample as jax_resample
from tfcgan_tpu_torch.ops import resample
from tfcgan_tpu_torch.ops.kernels import resample as kernels
from tfcgan_tpu_torch.ops.warp import warp_affine


def _both(x, p, q, ct, w_out, mode, border, stride):
    """Output and (gx, gp, gq) of the JAX function and of the port's."""
    def loss(xi, pi, qi):
        return jnp.sum(jax_resample.resample_affine_lanes(xi, pi, qi, w_out, mode, border,
                                                          stride) * ct)

    jx, jp, jq = jnp.asarray(x), jnp.asarray(p), jnp.asarray(q)
    want = jax_resample.resample_affine_lanes(jx, jp, jq, w_out, mode, border, stride)
    want_g = jax.grad(loss, (0, 1, 2))(jx, jp, jq)
    tx, tp, tq = (torch.from_numpy(v).requires_grad_() for v in (x, p, q))
    got = resample.resample_affine_lanes(tx, tp, tq, w_out, mode, border, stride)
    (got * torch.from_numpy(ct)).sum().backward()
    return (got.detach().numpy(), [t.grad.numpy() for t in (tx, tp, tq)],
            np.asarray(want), [np.asarray(g) for g in want_g])


def _assert_close(got, got_g, want, want_g):
    np.testing.assert_allclose(got, want, atol=2e-5 * max(np.abs(want).max(), 1.0))
    for g, w, tol, name in zip(got_g, want_g, (2e-5, 2e-4, 2e-4), ("gx", "gp", "gq")):
        np.testing.assert_allclose(g, w, atol=tol * max(np.abs(w).max(), 1.0), err_msg=name)


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("border", [True, False])
@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_resample_affine_lanes_and_gradients(mode, border, stride):
    """w_out != w_in, widths that are no multiple of 8 or 128, p in [0.6, 4]."""
    r = np.random.RandomState(0)
    rows, w_in, w_out = 5, 13, 17
    x = r.randn(rows, w_in * stride).astype(np.float32)
    p = r.uniform(0.6, 4.0, rows).astype(np.float32)
    q = r.uniform(-3.0, 3.0, rows).astype(np.float32)
    ct = r.randn(rows, w_out * stride).astype(np.float32)
    _assert_close(*_both(x, p, q, ct, w_out, mode, border, stride))


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_lines_far_off_both_edges(mode, stride):
    """The edge-mass case: q runs lines partly and wholly beyond either end,
    so the clamped taps' weight lands on the two edge elements of gx."""
    r = np.random.RandomState(7)
    w_in = w_out = 32
    q = np.array([-6.0, -2.5, 0.0, 1.5, 9.0, -40.0, 45.0, 31.2], np.float32)
    rows = len(q)
    p = r.uniform(0.6, 1.5, rows).astype(np.float32)
    x = r.randn(rows, w_in * stride).astype(np.float32)
    ct = r.randn(rows, w_out * stride).astype(np.float32)
    got, got_g, want, want_g = _both(x, p, q, ct, w_out, mode, True, stride)
    _assert_close(got, got_g, want, want_g)
    # a line wholly beyond an end reads one edge element: all of its
    # cotangent lands there
    gx = got_g[0].reshape(rows, w_in, stride)
    np.testing.assert_allclose(gx[5, 0], ct.reshape(rows, w_out, stride)[5].sum(0), rtol=1e-5)
    np.testing.assert_allclose(gx[6, -1], ct.reshape(rows, w_out, stride)[6].sum(0), rtol=1e-5)
    assert not gx[5, 1:].any() and not gx[6, :-1].any()


@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_adjoint_stays_exact_below_half_scale(mode):
    """|p| < 0.5 (outside the JAX adjoint's tap window) and p == 0: the
    port's gradient to x is the exact transpose, checked against the
    sampling matrix built column by column from the forward."""
    r = np.random.RandomState(1)
    w_in, w_out = 9, 40
    p = np.array([0.2, 0.05, 0.0, -0.3], np.float32)
    q = np.array([0.3, 4.1, 3.6, 8.2], np.float32)
    rows = len(p)
    ct = r.randn(rows, w_out).astype(np.float32)
    basis = np.eye(w_in, dtype=np.float32)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    # A[r, i, v]: the forward applied to the unit vectors
    cols = [resample.resample_affine_lanes(torch.from_numpy(np.tile(basis[v], (rows, 1))), tp, tq,
                                           w_out, mode, True).numpy() for v in range(w_in)]
    want = np.einsum("vri,ri->rv", np.stack(cols), ct)
    x = torch.zeros(rows, w_in, requires_grad=True)
    (resample.resample_affine_lanes(x, tp, tq, w_out, mode, True)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5)


def _theta(n, seed=3):
    """Near-identity rotations with scale and shift (the JAX TestWarpV2._theta)."""
    r = np.random.RandomState(seed)
    ang = r.uniform(-0.1, 0.1, n)
    th = np.zeros((n, 2, 3), np.float32)
    th[:, 0, 0] = np.cos(ang) * r.uniform(0.9, 1.1, n)
    th[:, 0, 1] = -np.sin(ang)
    th[:, 1, 0] = np.sin(ang)
    th[:, 1, 1] = np.cos(ang) * r.uniform(0.9, 1.1, n)
    th[:, 0, 2] = r.uniform(-0.1, 0.1, n)
    th[:, 1, 2] = r.uniform(-0.1, 0.1, n)
    return th


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 16, 24, 1), (1, 15, 17, 5)])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_warp_affine_separable_and_gradients(mode, padding_mode, shape):
    r = np.random.RandomState(4)
    src = np.tanh(r.randn(*shape)).astype(np.float32)
    th = _theta(shape[0])
    ct = r.randn(*shape).astype(np.float32)

    def loss(s, t):
        return jnp.sum(jax_resample.warp_affine_separable(s, t, mode, padding_mode) * ct)

    want = np.asarray(jax_resample.warp_affine_separable(
        jnp.asarray(src), jnp.asarray(th), mode, padding_mode))
    want_gs, want_gt = jax.grad(loss, (0, 1))(jnp.asarray(src), jnp.asarray(th))
    ts = torch.from_numpy(src).requires_grad_()
    tt = torch.from_numpy(th).requires_grad_()
    got = resample.warp_affine_separable(ts, tt, mode, padding_mode)
    assert got.shape == src.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_gs),
                               atol=2e-5 * np.abs(want_gs).max())
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_gt),
                               atol=2e-4 * np.abs(want_gt).max())


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_separable_warp_is_the_direct_warp_without_rotation(mode):
    """Axis-aligned scale and translation: the two passes are the two factors
    of the direct warp's tensor-product interpolation, so both agree."""
    r = np.random.RandomState(5)
    src = torch.from_numpy(np.tanh(r.randn(2, 24, 24, 3)).astype(np.float32))
    theta = torch.tensor([[[0.95, 0.0, 0.02], [0.0, 1.05, -0.03]]]).repeat(2, 1, 1)
    fast = resample.warp_affine_separable(src, theta, mode, "border")
    exact = warp_affine(src, theta, mode, "border", align_corners=True)
    np.testing.assert_allclose(fast.numpy(), exact.numpy(), atol=2e-5)
    identity = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]]).repeat(2, 1, 1)
    np.testing.assert_allclose(resample.warp_affine_separable(src, identity, mode).numpy(),
                               src.numpy(), atol=1e-6)


def test_lanes_plain_is_the_cpu_path():
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.randn(4, 10 * 3).astype(np.float32))
    p, q = torch.tensor([0.7, 1.0, 1.3, 2.0]), torch.tensor([-2.0, 0.0, 0.4, 3.0])
    for mode in ("linear", "cubic"):
        np.testing.assert_array_equal(
            resample.resample_affine_lanes_plain(x, p, q, 12, mode, True, 3).numpy(),
            resample.resample_affine_lanes(x, p, q, 12, mode, True, 3).numpy())


def test_bf16_source_keeps_its_dtype_and_float32_intermediate():
    r = np.random.RandomState(6)
    src = torch.from_numpy(r.randn(1, 8, 8, 3).astype(np.float32)).bfloat16()
    theta = torch.from_numpy(_theta(1))
    out = resample.warp_affine_separable(src, theta)
    want = resample.warp_affine_separable(src.float(), theta)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), want.bfloat16().float().numpy())


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_arguments():
    """On a CUDA tensor the wrappers launch or raise; here everything raises."""
    x = torch.zeros(2, 8, 3)
    p = q = torch.zeros(2, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.resample_fwd(x, p, q, 8, "cubic", True, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.resample_adjoint(x, p, q, 8, "cubic", True, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.resample_gradpos(x, x, p, q, "cubic", True, 3)
    with pytest.raises(ValueError, match="mode must be"):
        resample.resample_axis_plain(x, p, q, 8, "nearest")
    assert (kernels.FWD_LAUNCHES, kernels.ADJOINT_LAUNCHES, kernels.GRADPOS_LAUNCHES) == (0, 0, 0)
