"""The port's direct 2-D warp (``ops/warp.py``) against ``tfcgan_tpu.ops.warp``
and, as a second witness, ``torch.nn.functional.grid_sample``.

float32 on the CPU, inputs from numpy seeds. Tolerances: grids and sampled
values atol 2e-5 (the same formulas, sums in another order); gradients atol
2e-5 x max|g| for the image and 2e-4 x max|g| for theta (theta's gradient
sums over every pixel). Grid points are kept 1e-3 away from the places where
the sampling index jumps (integers; half-integers for nearest), where one
rounding flips the tap on one side only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tfcgan_tpu.ops import warp as jax_warp
from tfcgan_tpu_torch.ops import warp

MODES = ("bilinear", "bicubic", "nearest")
PADDINGS = ("zeros", "border", "reflection")


def _theta(n, seed=3):
    r = np.random.RandomState(seed)
    ang = r.uniform(-0.3, 0.3, n)
    th = np.zeros((n, 2, 3), np.float32)
    th[:, 0, 0] = np.cos(ang) * r.uniform(0.8, 1.2, n)
    th[:, 0, 1] = -np.sin(ang)
    th[:, 1, 0] = np.sin(ang)
    th[:, 1, 1] = np.cos(ang) * r.uniform(0.8, 1.2, n)
    th[:, :, 2] = r.uniform(-0.3, 0.3, (n, 2))
    return th


def _safe_grid(n, hg, wg, h, w, align_corners, seed):
    """A random grid reaching beyond the image, no point within 1e-3 of a
    place where floor or round of its pixel coordinate jumps."""
    r = np.random.RandomState(seed)
    grid = r.uniform(-1.6, 1.6, (n, hg, wg, 2)).astype(np.float32)
    for axis, size in ((0, w), (1, h)):
        pix = np.asarray(jax_warp._unnormalize(jnp.asarray(grid[..., axis]), size, align_corners))
        frac = pix * 2 - np.round(pix * 2)  # distance to the nearest half-integer, doubled
        grid[..., axis] = np.where(np.abs(frac) < 4e-3, grid[..., axis] + 0.02, grid[..., axis])
    return grid


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid(align_corners):
    th = _theta(3)
    want = np.asarray(jax_warp.affine_grid(jnp.asarray(th), (3, 9, 13), align_corners))
    got = warp.affine_grid(torch.from_numpy(th), (3, 9, 13), align_corners)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    witness = F.affine_grid(torch.from_numpy(th), (3, 1, 9, 13), align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), witness.numpy(), atol=2e-6)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("mode", MODES)
def test_grid_sample_and_gradients(mode, padding_mode, align_corners):
    r = np.random.RandomState(0)
    n, h, w, c = 2, 11, 14, 3
    img = r.randn(n, h, w, c).astype(np.float32)
    grid = _safe_grid(n, 7, 9, h, w, align_corners, seed=1)
    ct = r.randn(n, 7, 9, c).astype(np.float32)
    kw = dict(mode=mode, padding_mode=padding_mode, align_corners=align_corners)

    def loss(i, g):
        return jnp.sum(jax_warp.grid_sample(i, g, **kw) * ct)

    want = np.asarray(jax_warp.grid_sample(jnp.asarray(img), jnp.asarray(grid), **kw))
    want_gi, want_gg = jax.grad(loss, (0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti = torch.from_numpy(img).requires_grad_()
    tg = torch.from_numpy(grid).requires_grad_()
    got = warp.grid_sample(ti, tg, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_gi),
                               atol=2e-5 * np.abs(want_gi).max())
    if mode == "nearest":  # no path to the grid: JAX says zero, autograd says none
        assert tg.grad is None and not np.asarray(want_gg).any()
    else:
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_gg),
                                   atol=2e-5 * np.abs(want_gg).max())

    # second witness: torch's own operator on the same inputs (NCHW)
    wi = torch.from_numpy(img).permute(0, 3, 1, 2).requires_grad_()
    wg = torch.from_numpy(grid).requires_grad_()
    witness = F.grid_sample(wi, wg, **kw)
    np.testing.assert_allclose(got.detach().numpy(), witness.permute(0, 2, 3, 1).detach().numpy(),
                               atol=2e-5)
    (witness * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(ti.grad.numpy(), wi.grad.permute(0, 2, 3, 1).numpy(),
                               atol=2e-5 * float(wi.grad.abs().max()))
    if mode != "nearest":
        np.testing.assert_allclose(tg.grad.numpy(), wg.grad.numpy(),
                                   atol=2e-5 * float(wg.grad.abs().max()))


@pytest.mark.parametrize("t", [0.0, 0.25, 0.999])
def test_cubic_coeffs(t):
    want = [float(v) for v in jax_warp.cubic_coeffs(jnp.float32(t))]
    got = [float(v) for v in warp.cubic_coeffs(torch.tensor(t))]
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(sum(got), 1.0, atol=1e-6)


@pytest.mark.parametrize("mode,padding_mode", [("bicubic", "border"), ("bilinear", "zeros"),
                                               ("bilinear", "border")])
def test_warp_affine_and_gradients(mode, padding_mode):
    r = np.random.RandomState(2)
    src = np.tanh(r.randn(2, 16, 24, 3)).astype(np.float32)
    th = _theta(2, seed=5)
    ct = r.randn(*src.shape).astype(np.float32)
    kw = dict(mode=mode, padding_mode=padding_mode, align_corners=True)

    def loss(s, t):
        return jnp.sum(jax_warp.warp_affine(s, t, **kw) * ct)

    want = np.asarray(jax_warp.warp_affine(jnp.asarray(src), jnp.asarray(th), **kw))
    want_gs, want_gt = jax.grad(loss, (0, 1))(jnp.asarray(src), jnp.asarray(th))
    ts = torch.from_numpy(src).requires_grad_()
    tt = torch.from_numpy(th).requires_grad_()
    got = warp.warp_affine(ts, tt, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_gs),
                               atol=2e-5 * np.abs(want_gs).max())
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_gt),
                               atol=2e-4 * np.abs(want_gt).max())
