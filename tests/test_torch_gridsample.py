"""The port's dense bilinear grid sampling (``ops/gridsample.py``) against the
JAX package, float32 on the CPU, on numpy inputs from a seed.

The port runs its plain version here (a CPU tensor never reaches a CUDA
kernel). Three oracles: the JAX Pallas kernel in interpret mode
(``grid_sample_dense(..., interpret=True)``), the JAX gather path
(``tfcgan_tpu.ops.warp.grid_sample``) and torch's own ``F.grid_sample`` on the
CPU (called here only, never in the port). The cases are those of
``tests/test_pallas_gridsample.py``. Tolerances: forward rtol = atol = 1e-5
(four products summed in another order), gradients to the image and to the
grid rtol = atol = 1e-4 (sums over channels and over all samples of a pixel).
``F.grid_sample`` clips the coordinate under border padding where the package
clamps the taps: the values are the same, and so are the gradients (zero
outside).

The autograd function around the kernels is checked on the CPU by pointing
its two kernel wrappers at the plain version and autograd of it: what is
checked is the plumbing (saved tensors, which gradients are asked for, the
cast of a bfloat16 image gradient), not the kernels, which only a card runs.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tfcgan_tpu.ops.pallas_kernels import grid_sample_dense as jax_grid_sample_dense
from tfcgan_tpu.ops.warp import affine_grid as jax_affine_grid
from tfcgan_tpu.ops.warp import grid_sample as jax_grid_sample
from tfcgan_tpu_torch.ops import gridsample
from tfcgan_tpu_torch.ops.gridsample import (GridSampleDense, grid_sample_dense,
                                             grid_sample_dense_plain)
from tfcgan_tpu_torch.ops.kernels import gridsample as kernels
from tfcgan_tpu_torch.ops.warp import affine_grid

PADDINGS = ("zeros", "border", "reflection")


def _rand_case(seed, n=2, h=24, w=40, hg=16, wg=33, c=3, scale=1.2):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, h, w, c).astype(np.float32)
    grid = rng.uniform(-scale, scale, size=(n, hg, wg, 2)).astype(np.float32)
    return img, grid


def _jax_oracles(img, grid, padding, align):
    ji, jg = jnp.asarray(img), jnp.asarray(grid)
    return (np.asarray(jax_grid_sample_dense(ji, jg, "bilinear", padding, align, interpret=True)),
            np.asarray(jax_grid_sample(ji, jg, "bilinear", padding, align)))


def _library(img, grid, padding, align):
    """torch's F.grid_sample on NHWC tensors (differentiable)."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode=padding,
                        align_corners=align)
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("align", [False, True])
def test_matches_the_jax_kernel_the_jax_gather_and_the_library(padding, align):
    img, grid = _rand_case(0)
    got = grid_sample_dense(torch.from_numpy(img), torch.from_numpy(grid), "bilinear", padding,
                            align).numpy()
    assert got.shape == (2, 16, 33, 3)
    for want in _jax_oracles(img, grid, padding, align):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    lib = _library(torch.from_numpy(img), torch.from_numpy(grid), padding, align).numpy()
    np.testing.assert_allclose(got, lib, rtol=1e-5, atol=1e-5)


def test_identity_grid_round_trip():
    img, _ = _rand_case(1, h=16, w=16, c=2)
    theta = np.broadcast_to(np.asarray([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (2, 2, 3))
    grid = affine_grid(torch.from_numpy(theta.copy()), (2, 16, 16), align_corners=False)
    want_grid = np.asarray(jax_affine_grid(jnp.asarray(theta), (2, 16, 16), align_corners=False))
    np.testing.assert_array_equal(grid.numpy(), want_grid)
    out = grid_sample_dense(torch.from_numpy(img), grid, "bilinear", "zeros", False)
    np.testing.assert_allclose(out.numpy(), img, rtol=1e-5, atol=1e-5)


def _both_grads(img, grid, cot, padding, align):
    """(d/dimg, d/dgrid) of sum(out * cot): the port, the JAX kernel, the JAX
    gather path, the library."""
    ti, tg = torch.from_numpy(img).requires_grad_(), torch.from_numpy(grid).requires_grad_()
    (grid_sample_dense(ti, tg, "bilinear", padding, align) * torch.from_numpy(cot)).sum().backward()
    got = (ti.grad.numpy(), tg.grad.numpy())

    def jax_grads(fn):
        def f(im, gr):
            return jnp.sum(fn(im, gr) * jnp.asarray(cot))
        return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(jnp.asarray(img),
                                                                   jnp.asarray(grid))]

    kernel = jax_grads(lambda im, gr: jax_grid_sample_dense(im, gr, "bilinear", padding, align,
                                                            interpret=True))
    gather = jax_grads(lambda im, gr: jax_grid_sample(im, gr, "bilinear", padding, align))
    li, lg = torch.from_numpy(img).requires_grad_(), torch.from_numpy(grid).requires_grad_()
    (_library(li, lg, padding, align) * torch.from_numpy(cot)).sum().backward()
    return got, kernel, gather, (li.grad.numpy(), lg.grad.numpy())


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("align", [False, True])
def test_gradients_to_image_and_grid(padding, align):
    img, grid = _rand_case(2, n=1, h=12, w=20, hg=10, wg=18, c=2)
    cot = np.random.RandomState(3).randn(1, 10, 18, 2).astype(np.float32)
    got, *oracles = _both_grads(img, grid, cot, padding, align)
    for name, want in zip(("jax kernel", "jax gather", "F.grid_sample"), oracles):
        for g, w, what in zip(got, want, ("image", "grid")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{name}: d/d{what}")


def test_identity_grid_with_zero_offsets_gives_the_same_grid_gradient():
    """Every sample sits on an integer coordinate, where the grid gradient is
    a one-sided difference: both packages must floor to the same side."""
    for size in (16, 24):  # 24: the unnormalized coordinates are not exact
        img, _ = _rand_case(7, n=2, h=size, w=size, c=3)
        theta = np.broadcast_to(np.asarray([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (2, 2, 3))
        grid = affine_grid(torch.from_numpy(theta.copy()), (2, size, size),
                           align_corners=False).numpy()
        cot = np.random.RandomState(8).randn(2, size, size, 3).astype(np.float32)
        got, kernel, gather, _ = _both_grads(img, grid, cot, "zeros", False)
        assert np.abs(gather[1]).max() > 1.0
        np.testing.assert_allclose(got[1], gather[1], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[0], gather[0], rtol=1e-4, atol=1e-4)
        if size == 16:  # exact coordinates: the interpreted kernel agrees too
            np.testing.assert_allclose(got[1], kernel[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("padding", PADDINGS)
def test_far_off_the_image(padding):
    img, grid = _rand_case(4)
    grid = grid * 5.0
    got = grid_sample_dense(torch.from_numpy(img), torch.from_numpy(grid), "bilinear", padding,
                            False).numpy()
    for want in _jax_oracles(img, grid, padding, False):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bfloat16_image_keeps_its_dtype_and_is_sampled_in_float32():
    img, grid = _rand_case(5, c=1)
    ti = torch.from_numpy(img).bfloat16()
    out = grid_sample_dense(ti, torch.from_numpy(grid), "bilinear", "zeros", False)
    assert out.dtype == torch.bfloat16
    want = jax_grid_sample_dense(jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(grid),
                                 "bilinear", "zeros", False, interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=8e-3, rtol=8e-3)  # one bf16 ulp: the final rounding
    exact = grid_sample_dense_plain(ti.float(), torch.from_numpy(grid)).bfloat16()
    assert torch.equal(out, exact)


def test_rejects_other_modes_and_paddings():
    img, grid = (torch.from_numpy(v) for v in _rand_case(6))
    with pytest.raises(ValueError, match="bilinear only"):
        grid_sample_dense(img, grid, "bicubic")
    with pytest.raises(ValueError, match="padding_mode"):
        grid_sample_dense(img, grid, "bilinear", "wrap")


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    img, grid = (torch.from_numpy(v) for v in _rand_case(6))
    before = (kernels.FWD_LAUNCHES, kernels.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gridsample_fwd(img, grid)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gridsample_bwd(torch.zeros(2, 16, 33, 3), img, grid)
    assert (kernels.FWD_LAUNCHES, kernels.BWD_LAUNCHES) == before


# ------------------------------------------------- the autograd function
def _plain_fwd(inp, grid, padding_mode, align_corners):
    return grid_sample_dense_plain(inp, grid, "bilinear", padding_mode, align_corners)


def _plain_bwd(g, inp, grid, padding_mode, align_corners, need_inp=True, need_grid=True):
    """``kernels.gridsample_bwd``'s contract through autograd of the plain
    version: float32 gradients, None for the one not asked for."""
    calls.append((need_inp, need_grid, g.dtype, g.is_contiguous()))
    with torch.enable_grad():
        i, gr = inp.detach().float().requires_grad_(), grid.detach().requires_grad_()
        out = grid_sample_dense_plain(i, gr, "bilinear", padding_mode, align_corners)
        d_inp, d_grid = torch.autograd.grad(out, (i, gr), g.float())
    return (d_inp if need_inp else None), (d_grid if need_grid else None)


calls: list = []


@pytest.fixture
def on_plain():
    calls.clear()
    with mock.patch.object(gridsample._kernel, "gridsample_fwd", _plain_fwd), \
            mock.patch.object(gridsample._kernel, "gridsample_bwd", _plain_bwd):
        yield calls


@pytest.mark.parametrize("padding,align", [("zeros", False), ("border", True),
                                           ("reflection", False)])
def test_autograd_function_matches_autograd_of_the_plain_version(on_plain, padding, align):
    img, grid = _rand_case(9, n=2, h=9, w=11, hg=7, wg=5, c=3)
    cot = torch.from_numpy(np.random.RandomState(10).randn(2, 7, 5, 3).astype(np.float32))
    ti, tg = torch.from_numpy(img).requires_grad_(), torch.from_numpy(grid).requires_grad_()
    out = GridSampleDense.apply(ti, tg, padding, align)
    # a strided output gradient reaches the backward as a contiguous tensor
    (out.permute(0, 2, 1, 3) * cot.permute(0, 2, 1, 3)).sum().backward()
    pi, pg = torch.from_numpy(img).requires_grad_(), torch.from_numpy(grid).requires_grad_()
    (grid_sample_dense_plain(pi, pg, "bilinear", padding, align) * cot).sum().backward()
    torch.testing.assert_close(ti.grad, pi.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tg.grad, pg.grad, rtol=1e-6, atol=1e-6)
    assert on_plain == [(True, True, torch.float32, True)]


def test_autograd_function_asks_only_for_the_gradients_it_needs(on_plain):
    img, grid = (torch.from_numpy(v) for v in _rand_case(11, n=1, h=8, w=8, hg=6, wg=6, c=2))
    tg = grid.clone().requires_grad_()
    GridSampleDense.apply(img, tg, "zeros", False).sum().backward()
    ti = img.clone().requires_grad_()
    GridSampleDense.apply(ti, grid, "zeros", False).sum().backward()
    assert [c[:2] for c in on_plain] == [(False, True), (True, False)]
    assert tg.grad is not None and ti.grad is not None
    # a bfloat16 image gets a bfloat16 gradient, the grid a float32 one
    tb, tg = img.bfloat16().requires_grad_(), grid.clone().requires_grad_()
    out = GridSampleDense.apply(tb, tg, "border", False)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert tb.grad.dtype == torch.bfloat16 and tg.grad.dtype == torch.float32
    assert on_plain[-1] == (True, True, torch.bfloat16, True)
