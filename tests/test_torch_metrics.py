"""Grayscale, spectra and metrics of the port against the JAX package on
identical inputs.

Tolerances: rtol 1e-5 for the elementwise maps and metrics (float32 in
another summation order); SSIM rtol 1e-4, whose variance terms subtract
squares of up to 255² and lose digits there; log spectra atol 1e-4 (two FFT
libraries in float32, errors relative to the largest, DC, bin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.evaluation import suite as jax_suite
from tfcgan_tpu.ops import fftloss as jax_fftloss
from tfcgan_tpu.ops import metrics as jax_metrics
from tfcgan_tpu.ops import quantize as jax_quantize
from tfcgan_tpu_torch.evaluation import suite
from tfcgan_tpu_torch.ops import fftloss, metrics, quantize


def _pair(seed, n=3, size=32):
    rng = np.random.RandomState(seed)
    real = np.tanh(rng.randn(n, size, size, 3)).astype(np.float32)
    fake = np.clip(real + 0.3 * rng.randn(n, size, size, 3), -1, 1).astype(np.float32)
    return real, fake


def _t(x):
    return torch.from_numpy(x)


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("mode", ["eval", "smooth"])
def test_rgb_to_luma_matches_jax(mode):
    x, _ = _pair(0)
    x[0, 0, :4, 0] = [-1.0, 1.0, -0.999, 0.0]  # the clip and rounding edges
    got = quantize.rgb_to_luma_uint8(_t(x), mode=mode).numpy()
    want = np.asarray(jax_quantize.rgb_to_luma_uint8(_j(x), mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if mode == "eval":
        np.testing.assert_array_equal(got, want)


def test_rgb_to_luma_default_mode_matches_jax():
    """Called without ``mode``, both packages take "exact" (ToPILImage's
    wraparound): the two defaults once differed by 115 grey levels here."""
    x = np.random.RandomState(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    got = quantize.rgb_to_luma_uint8(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_quantize.rgb_to_luma_uint8(_j(x))))


def test_luma_pil_is_exact_on_all_corners():
    v = np.array(np.meshgrid(*[[0.0, 1.0, 127.0, 128.0, 254.0, 255.0]] * 3)).reshape(3, -1).T
    v = v.astype(np.float32)
    np.testing.assert_array_equal(quantize.luma_pil(_t(v)).numpy(),
                                  np.asarray(jax_quantize.luma_pil(_j(v))))


def test_unknown_luma_mode_raises():
    # "exact" is a mode now (the training losses' quantization)
    with pytest.raises(ValueError, match="unknown mode"):
        quantize.rgb_to_luma_uint8(torch.zeros(1, 2, 2, 3), mode="round")


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_fft_log_magnitude_matches_jax(kind):
    x, _ = _pair(1)
    if kind == "constant":  # |f| = 0 off DC: the tiny floor keeps it finite
        x = np.full_like(x, 0.25)
    got = fftloss.fft_log_magnitude(_t(x)).numpy()
    want = np.asarray(jax_fftloss.fft_log_magnitude(_j(x)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_psnr_matches_jax_including_identical_images():
    real, fake = _pair(2)
    fake[1] = real[1]  # mse == 0 -> 100
    r, f = (real * 0.5 + 0.5) * 255, (fake * 0.5 + 0.5) * 255
    got = metrics.psnr(_t(r), _t(f)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_metrics.psnr(_j(r), _j(f))), rtol=1e-5)
    assert got[1] == 100.0


@pytest.mark.parametrize("channels", [None, 3])
def test_ssim_matches_jax(channels):
    real, fake = _pair(3)
    r, f = (real * 0.5 + 0.5) * 255, (fake * 0.5 + 0.5) * 255
    if channels is None:
        r, f = r[..., 0], f[..., 0]
    np.testing.assert_allclose(metrics.ssim(_t(r), _t(f)).numpy(),
                               np.asarray(jax_metrics.ssim(_j(r), _j(f))), rtol=1e-4)


def test_bhattacharyya_matches_jax():
    real, fake = _pair(4)
    r, f = (real * 0.5 + 0.5) * 255, (fake * 0.5 + 0.5) * 255
    np.testing.assert_allclose(metrics.bhattacharyya(_t(r), _t(f)).numpy(),
                               np.asarray(jax_metrics.bhattacharyya(_j(r), _j(f))), rtol=1e-5)


@pytest.mark.parametrize("name", ["fft_mag_mse", "fft_mag_mae"])
def test_fft_metrics_match_jax(name):
    real, fake = _pair(5)
    got = getattr(metrics, name)(_t(real), _t(fake)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jax_metrics, name)(_j(real), _j(fake))),
                               rtol=1e-5)


def test_pair_metrics_match_jax():
    real, fake = _pair(6, n=2, size=48)
    got = suite.pair_metrics(_t(real), _t(fake))
    want = jax_suite.pair_metrics(_j(real), _j(fake))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4 if k.startswith("ssim") else 1e-5, err_msg=k)


def test_png_writer_reads_back_with_pil(tmp_path):
    from PIL import Image

    real, fake = _pair(7, n=2, size=24)
    path = str(tmp_path / "sub" / "grid.png")
    suite.save_image_grid([real[0], fake[0], real[1]], path)
    jax_path = str(tmp_path / "jax.png")
    jax_suite.save_image_grid([real[0], fake[0], real[1]], jax_path)
    got = np.asarray(Image.open(path))
    assert got.shape == (72, 24, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.open(jax_path)))


def test_crop_and_evaluate_dirs_match_jax(tmp_path):
    real, fake = _pair(8, n=3, size=32)
    stacks = tmp_path / "stacks"
    for i in range(3):
        suite.save_image_grid([real[i], fake[i], real[i]], str(stacks / f"{i:05d}.png"))
    roles = [str(tmp_path / r) for r in ("real_A", "fake_B", "real_B")]
    for f in sorted(stacks.iterdir()):
        suite.crop_stack(str(f), roles)
    csv_path = tmp_path / "m.csv"
    got = suite.evaluate_dirs(roles[1], roles[2], str(csv_path))
    want = jax_suite.evaluate_dirs(roles[1], roles[2])
    assert got["file"] == list(want["file"]) == ["00000.png", "00001.png", "00002.png"]
    for k in want.columns[1:]:
        np.testing.assert_allclose(got[k], want[k].to_numpy(),
                                   rtol=1e-4 if k.startswith("ssim") else 1e-5, err_msg=k)
    header = csv_path.read_text().splitlines()[0].split(",")
    assert header == ["file", *want.columns[1:]]
