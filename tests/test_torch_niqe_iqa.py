"""NIQE and the IQA stage of the port against the JAX package's, on the CPU.

The port's copy of ``niqe_pristine.npz`` holds the JAX file's arrays; NIQE
of three images (two sizes, RGB and gray) equals the JAX score to 1e-10
(both numpy/scipy in float64: the same operations); the learned metrics'
gates raise the same exception with the same message; ``cli eval --iqa
niqe`` writes the JAX CLI's columns and scores. About 10 s on one worker.
"""

import csv
import os

import numpy as np
import pytest
from PIL import Image

from tfcgan_tpu import cli as jax_cli
from tfcgan_tpu.evaluation import iqa as jax_iqa
from tfcgan_tpu.evaluation import niqe as jax_niqe
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.evaluation import iqa, niqe


def test_pristine_model_is_the_jax_packages():
    got, want = niqe.load_pristine_model(), jax_niqe.load_pristine_model()
    assert os.path.dirname(niqe._DEFAULT_MODEL).endswith(os.path.join("tfcgan_tpu_torch",
                                                                      "evaluation"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _images():
    rng = np.random.RandomState(0)
    smooth = np.asarray(Image.fromarray(rng.randint(0, 256, (48, 48, 3), np.uint8)).resize(
        (192, 192), Image.Resampling.BICUBIC)).astype(np.float32)
    noisy = rng.randint(0, 256, (200, 290, 3)).astype(np.float32)
    gray = rng.uniform(0, 255, (96, 192))
    return [smooth, noisy, gray]


def test_niqe_equals_the_jax_score():
    model = niqe.load_pristine_model()
    for img in _images():
        got = niqe.niqe(img, model)
        want = jax_niqe.niqe(img, jax_niqe.load_pristine_model())
        assert np.isfinite(got) and abs(got - want) <= 1e-10
    f = niqe.niqe_features(_images()[0], sharpness_threshold=0.5)
    np.testing.assert_allclose(f, jax_niqe.niqe_features(_images()[0], sharpness_threshold=0.5),
                               rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="smaller than one"):
        niqe.niqe_features(np.zeros((40, 40)))


def test_compute_iqa_and_the_gates():
    small = [img[:64, :80] for img in _images()]
    got, want = iqa.compute_iqa(small), jax_iqa.compute_iqa(small)
    assert list(got) == list(want) == ["niqe"]
    np.testing.assert_allclose(got["niqe"], want["niqe"], rtol=0, atol=1e-10)
    assert set(iqa.IQA_METRICS) == set(jax_iqa.IQA_METRICS)
    for name in ("maniqa", "dbcnn"):
        with pytest.raises(iqa.IQAWeightsUnavailable) as ours:
            iqa.compute_iqa(small, (name,))
        with pytest.raises(jax_iqa.IQAWeightsUnavailable) as theirs:
            jax_iqa.compute_iqa(small, (name,))
        assert isinstance(ours.value, RuntimeError)
        assert str(ours.value) == str(theirs.value)
        assert type(ours.value).__name__ == type(theirs.value).__name__


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([r[1:] for r in rows[1:]], np.float64)


def test_cli_eval_iqa_against_the_jax_cli(tmp_path):
    rng = np.random.RandomState(1)
    for d in ("fake", "real"):
        os.makedirs(tmp_path / d)
        for i in range(2):
            Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(
                tmp_path / d / f"{i:03d}.png")
    args = ["--fake-dir", str(tmp_path / "fake"), "--real-dir", str(tmp_path / "real"),
            "--iqa", "niqe"]
    cli.main(["eval", *args, "--out-csv", str(tmp_path / "port.csv"), "--device", "cpu"])
    jax_cli.main(["eval", *args, "--out-csv", str(tmp_path / "jax.csv"), "--cpu"])
    got, want = _read_csv(tmp_path / "port.csv"), _read_csv(tmp_path / "jax.csv")
    assert got[0] == want[0] and got[0][-2:] == ["niqe_fake", "niqe_real"]
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2][:, :-2], want[2][:, :-2], rtol=1e-4)  # pair metrics
    np.testing.assert_allclose(got[2][:, -2:], want[2][:, -2:], rtol=1e-12)  # NIQE, float64
    with pytest.raises(iqa.IQAWeightsUnavailable, match="MANIQA"):
        cli.main(["eval", *args[:4], "--iqa", "niqe,maniqa", "--device", "cpu"])
