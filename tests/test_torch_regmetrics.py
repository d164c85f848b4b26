"""The registration metrics of the port against the JAX package's, on the CPU.

``ncc``, ``mutual_information`` (the joint histogram counted exactly, in the
JAX bin order) and ``registration_metrics`` on the same seeded images, rtol
1e-5 (float32 sums in another order; MI atol 1e-6, where a constant plane's
0 comes out as 1.2e-7 in JAX); ``cli eval-reg`` against the JAX
CLI's CSV on the same PNG directories, with ``--plots-dir`` (matplotlib is
installed here) writing one figure an image. About 5 s on one worker.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tfcgan_tpu import cli as jax_cli
from tfcgan_tpu import ops as jax_ops
from tfcgan_tpu.evaluation.suite import registration_metrics as jax_registration_metrics
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.evaluation.suite import difference_plot, registration_metrics
from tfcgan_tpu_torch.ops.metrics import mutual_information, ncc


def _planes(seed, n=3, h=32, w=40):
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
    return base, np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("bins", [20, 7])
def test_ncc_and_mutual_information(bins):
    a, b = _planes(0)
    b[1] = 0.25  # a constant plane: MI 0, the span guard
    got = mutual_information(torch.from_numpy(a), torch.from_numpy(b), bins=bins).numpy()
    want = np.asarray(jax_ops.mutual_information(jnp.asarray(a), jnp.asarray(b), bins=bins))
    # atol: the constant plane's MI is 0 up to the rounding of a float32 column sum
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(got[1]) < 1e-6
    a, b = _planes(1)
    np.testing.assert_allclose(ncc(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_ops.ncc(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)


def _pairs(seed, n=3, size=32):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    reg = np.clip(a + rng.normal(0, 0.1, a.shape), -1, 1).astype(np.float32)
    return a, b, reg


def test_registration_metrics():
    arrays = _pairs(2)
    got = registration_metrics(*(torch.from_numpy(x) for x in arrays))
    want = jax_registration_metrics(*(jnp.asarray(x) for x in arrays))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    # registration moved reg_B towards A
    assert bool((got["ncc_after"] > got["ncc_before"]).all())


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([r[1:] for r in rows[1:]], np.float64)


def test_cli_eval_reg_against_the_jax_cli(tmp_path):
    dirs = {}
    for name, arr in zip(("real_A", "real_B", "reg_B"), _pairs(3, n=2, size=48)):
        dirs[name] = str(tmp_path / name)
        os.makedirs(dirs[name])
        for i, img in enumerate(arr):
            Image.fromarray(((img * 0.5 + 0.5) * 255).astype(np.uint8)).save(
                os.path.join(dirs[name], f"{i:03d}.png"))
    args = ["--real-a-dir", dirs["real_A"], "--real-b-dir", dirs["real_B"],
            "--reg-b-dir", dirs["reg_B"]]
    plots = str(tmp_path / "plots")
    cli.main(["eval-reg", *args, "--out-csv", str(tmp_path / "port.csv"), "--plots-dir", plots,
              "--device", "cpu"])
    jax_cli.main(["eval-reg", *args, "--out-csv", str(tmp_path / "jax.csv"), "--cpu"])
    got, want = _read_csv(tmp_path / "port.csv"), _read_csv(tmp_path / "jax.csv")
    assert got[0] == want[0] == ["file", "ssim_before", "ssim_after", "ncc_before", "ncc_after",
                                 "mi_before", "mi_after"]
    assert got[1] == want[1] == ["000.png", "001.png"]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    assert sorted(os.listdir(plots)) == ["000.png", "001.png"]
    with Image.open(os.path.join(plots, "000.png")) as fig:
        assert fig.size[0] > 500 and fig.size[1] > 100  # the 5-panel figure


def test_difference_plot_names_matplotlib_when_it_is_missing(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(ImportError, match="difference_plot needs matplotlib"):
        difference_plot(img, img, img, str(tmp_path / "x.png"))
