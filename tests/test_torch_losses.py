"""The port's fft_glo loss ops against the JAX package's, float32 on the CPU:
the relativistic BCE pair, the triplet, patches, the ``exact`` quantization,
the temperature LUT, HSV and ColorJitter (with the JAX draws rebuilt from
its key), the FFT amplitude/phase loss and the 2x2 max-pool.

Tolerances: values rtol 1e-5, gradients atol 1e-5 x max|g| (float32, sums in
another order), unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_parity_fftglo import fixed_batch
from tfcgan_tpu import ops as jops
from tfcgan_tpu.ops import color as jcolor
from tfcgan_tpu.ops import fftloss as jfft
from tfcgan_tpu.ops import pooling as jpooling
from tfcgan_tpu_torch.ops import color, fftloss, gan_losses, patches, pooling, quantize
from tfcgan_tpu_torch.ops import temperature, triplet


def jax_jitter_draws(key) -> tuple[np.ndarray, list[int]]:
    """The factors and op order ``tfcgan_tpu.ops.color.color_jitter`` draws
    from ``key``, for the port's ``color_jitter(x, factors, order)``."""
    kb, kc, ks, kh, kperm = jax.random.split(key, 5)
    factors = [jax.random.uniform(k, (), minval=lo, maxval=hi)
               for k, (lo, hi) in zip((kb, kc, ks, kh), color.JITTER_RANGES)]
    order = [int(i) for i in np.asarray(jax.random.permutation(kperm, 4))]
    return np.asarray(factors, np.float32), order


def _value_and_grad_port(fn, *arrays):
    """fn of float32 tensors made from ``arrays``; returns (value, grads)."""
    ts = [torch.from_numpy(np.array(a, np.float32)).requires_grad_() for a in arrays]
    out = fn(*ts)
    if not out.requires_grad:  # a zero-gradient op (exact quantization)
        return out.numpy(), [None] * len(ts)
    grads = torch.autograd.grad(out, ts, allow_unused=True)
    return out.detach().numpy(), [None if g is None else g.numpy() for g in grads]


def _value_and_grad_jax(fn, *arrays):
    args = [jnp.asarray(a, jnp.float32) for a in arrays]
    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(*args)
    return np.asarray(value), [np.asarray(g) for g in grads]


def _assert_value_and_grads(port_fn, jax_fn, *arrays, rtol=1e-5, grad_rtol=1e-5):
    v_p, g_p = _value_and_grad_port(port_fn, *arrays)
    v_j, g_j = _value_and_grad_jax(jax_fn, *arrays)
    np.testing.assert_allclose(v_p, v_j, rtol=rtol)
    for gp, gj in zip(g_p, g_j):
        gp = np.zeros_like(gj) if gp is None else gp
        np.testing.assert_allclose(gp, gj, atol=grad_rtol * max(np.abs(gj).max(), 1e-30))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


class TestGanLosses:
    def test_bce_with_logits(self):
        x = _rand(2, 16, 16, 1, seed=1, scale=3.0)
        for target in (0.0, 0.9, 1.0):
            _assert_value_and_grads(lambda t: gan_losses.bce_with_logits(t, target),
                                    lambda t: jops.bce_with_logits(t, target), x)

    def test_relativistic_pair(self):
        pf, pr = _rand(2, 16, 16, 1, seed=2), _rand(2, 16, 16, 1, seed=3)
        _assert_value_and_grads(gan_losses.relativistic_g_loss, jops.relativistic_g_loss, pf, pr)
        _assert_value_and_grads(gan_losses.relativistic_d_loss, jops.relativistic_d_loss, pr, pf)

    def test_g_loss_detaches_pred_real(self):
        pf, pr = _rand(1, 4, 4, 1, seed=4), _rand(1, 4, 4, 1, seed=5)
        _, (g_fake, g_real) = _value_and_grad_port(gan_losses.relativistic_g_loss, pf, pr)
        assert g_real is None and np.abs(g_fake).max() > 0


class TestTriplet:
    @pytest.mark.parametrize("axis", [2, -1])
    def test_matches_jax(self, axis):
        a, p, n = (_rand(2, 8, 8, 3, seed=s) for s in (6, 7, 8))
        _assert_value_and_grads(
            lambda *t: triplet.triplet_margin_loss(*t, axis=axis),
            lambda *t: jops.triplet_margin_loss(*t, axis=axis), a, p, n)

    def test_matches_torch_triplet_margin_loss_on_nchw(self):
        a, p, n = (_rand(2, 8, 8, 3, seed=s) for s in (9, 10, 11))
        want = torch.nn.TripletMarginLoss(margin=1.0, p=2)(
            *(torch.from_numpy(v).permute(0, 3, 1, 2) for v in (a, p, n)))
        got = triplet.triplet_margin_loss(*(torch.from_numpy(v) for v in (a, p, n)), axis=2)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("grid", [2, 4])
def test_patchify_round_trip_matches_jax(grid):
    x = _rand(2, 16, 12, 3, seed=12)
    got = patches.patchify(torch.from_numpy(x), grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.patchify(jnp.asarray(x), grid)))
    np.testing.assert_array_equal(patches.unpatchify(got, grid).numpy(), x)


class TestQuantizeAndTemperature:
    def test_exact_quantization_wraps_like_to_pil_image(self):
        x = np.array([-1.0, -0.5, -0.001, 0.0, 0.5, 0.999, 1.0], np.float32)
        got = quantize.quantize_uint8_torch(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jops.quantize_uint8_torch(jnp.asarray(x))))
        np.testing.assert_array_equal(got, [1, 129, 0, 0, 127, 254, 255])

    @pytest.mark.parametrize("mode", ["exact", "smooth", "eval"])
    def test_luma_matches_jax(self, mode):
        fake_b = fixed_batch(n=2, size=64)[0]
        got = quantize.rgb_to_luma_uint8(torch.from_numpy(fake_b), mode=mode).numpy()
        want = np.asarray(jops.rgb_to_luma_uint8(jnp.asarray(fake_b), mode=mode))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    @pytest.mark.parametrize("mode", ["exact", "smooth"])
    def test_temperature_lut(self, mode):
        fake_b = fixed_batch(n=2, size=64)[0]
        _assert_value_and_grads(lambda t: temperature.temperature_lut(t, mode).sum(),
                                lambda t: jops.temperature_lut(t, mode).sum(), fake_b)

    def test_temperature_lut_uint8(self):
        v = np.arange(256, dtype=np.float32)
        np.testing.assert_allclose(temperature.temperature_lut_uint8(torch.from_numpy(v)).numpy(),
                                   np.asarray(jops.temperature_lut_uint8(jnp.asarray(v))),
                                   rtol=1e-6)


class TestColor:
    def _img01(self, seed):
        # grays (r = g = b) and saturated pixels hit the HSV branches
        x = np.random.RandomState(seed).rand(2, 8, 8, 3).astype(np.float32)
        x[0, 0] = 0.4
        x[0, 1, :, 0], x[0, 1, :, 1:] = 1.0, 0.0
        return x

    def test_hsv_round_trip_matches_jax(self):
        x = self._img01(13)
        hsv = color.rgb_to_hsv(torch.from_numpy(x))
        np.testing.assert_allclose(hsv.numpy(), np.asarray(jcolor.rgb_to_hsv(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
        back = color.hsv_to_rgb(hsv).numpy()
        np.testing.assert_allclose(back, np.asarray(jcolor.hsv_to_rgb(jnp.asarray(hsv.numpy()))),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(back, x, atol=1e-5)

    @pytest.mark.parametrize("name,factor", [("brightness", 1.3), ("contrast", 0.4),
                                             ("saturation", 2.2), ("hue", -0.3),
                                             ("hue", 0.45)])
    def test_adjust_matches_jax(self, name, factor):
        port_fn, jax_fn = getattr(color, f"adjust_{name}"), getattr(jcolor, f"adjust_{name}")
        x = self._img01(14)
        np.testing.assert_allclose(port_fn(torch.from_numpy(x), factor).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(x), factor)), rtol=1e-5,
                                   atol=1e-6)
        # gradients on an image with no exact 0/1 values and no tied channels:
        # at such ties torch's clamp/maximum and JAX's clip split the gradient
        # differently (and the jitter negatives take no gradient in the loss)
        x = 0.05 + 0.9 * np.random.RandomState(15).rand(2, 8, 8, 3).astype(np.float32)
        _assert_value_and_grads(lambda t: port_fn(t, factor).square().sum(),
                                lambda t: jnp.sum(jax_fn(t, factor) ** 2), x)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_color_jitter_with_the_jax_draws(self, seed):
        key = jax.random.PRNGKey(seed)
        factors, order = jax_jitter_draws(key)
        real_b = fixed_batch(n=2, size=64, seed=seed)[2]
        got = color.color_jitter(torch.from_numpy(real_b), torch.from_numpy(factors), order)
        want = np.asarray(jcolor.color_jitter(key, jnp.asarray(real_b)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class TestFFT:
    @pytest.mark.parametrize("mode", ["exact", "smooth"])
    def test_amp_phase_and_l1_loss(self, mode):
        fake_b, _, real_b, _, _ = fixed_batch(n=2, size=64)
        amp, pha = fftloss.fft_amp_phase(torch.from_numpy(fake_b), mode)
        amp_j, pha_j = jfft.fft_amp_phase(jnp.asarray(fake_b), mode)
        np.testing.assert_allclose(amp.numpy(), np.asarray(amp_j), rtol=1e-4, atol=1e-3)
        # phase = atan2(imag, real): a bin whose imag part is a rounding-level
        # +-0 with a negative real part reads +pi in one FFT library and -pi in
        # the other, so differences of 2 pi are allowed where |imag| is tiny
        dp = np.abs(pha.numpy() - np.asarray(pha_j))
        flip = np.isclose(dp, 2 * np.pi, atol=1e-4) & (np.abs(np.asarray(amp_j)) > 0)
        assert (dp[~flip] < 1e-4).all(), dp[~flip].max()
        # loss values: a flipped bin moves the phase L1 by 2 pi / bins (1.5e-4 of
        # the mean here), so the phase part is held to rtol 5e-4
        got = [v.item() for v in fftloss.fft_l1_loss(torch.from_numpy(fake_b),
                                                       torch.from_numpy(real_b), mode)]
        want = [float(v) for v in jfft.fft_l1_loss(jnp.asarray(fake_b), jnp.asarray(real_b), mode)]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=5e-4)
        np.testing.assert_allclose(got[0], want[0], rtol=5e-4)

    def test_smooth_loss_gradient(self):
        fake_b, _, real_b, _, _ = fixed_batch(n=2, size=64)
        _assert_value_and_grads(
            lambda f: fftloss.fft_l1_loss(f, torch.from_numpy(real_b), "smooth")[1],
            lambda f: jfft.fft_l1_loss(f, jnp.asarray(real_b), "smooth")[1], fake_b)

    def test_exact_mode_has_no_gradient(self):
        fake_b, _, real_b, _, _ = fixed_batch(n=1, size=32)
        f = torch.from_numpy(fake_b).requires_grad_()
        loss = fftloss.fft_l1_loss(f, torch.from_numpy(real_b), "exact")[0]
        assert not loss.requires_grad


def test_pool22_with_crafted_ties():
    # values on a 0.5 grid: many 2x2 windows hold tied maxima, where the
    # gradient must go to the first maximum in row-major order
    x = np.round(_rand(2, 8, 8, 3, seed=15) * 2.0) / 2.0
    x[0, :2, :2, 0] = 1.0
    w = _rand(2, 4, 4, 3, seed=16)
    _assert_value_and_grads(
        lambda t: (pooling.pool22(t) * torch.from_numpy(w)).sum(),
        lambda t: jnp.sum(jpooling.pool22(t) * w), x, grad_rtol=0.0)
