"""The fft_glo serve slice of the port against the JAX package, end to end:
G forward, stacked PNGs and spectra, pair metrics, the CLI, the weight
export, and the port's independence from JAX.

float32 throughout (``compute_dtype="float32"``). Tolerances: G outputs atol
2e-4 (as ``tests/test_models.py``); written PNG pixels within 1 (an output
near a uint8 step may truncate to its neighbour); pair metrics rtol 1e-3
(they inherit the G difference).
"""

import dataclasses
import importlib.util
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.data.pairs import PairedImageDataset as JaxPairedImageDataset
from tfcgan_tpu.data.pairs import batch_iterator as jax_batch_iterator
from tfcgan_tpu.data.synth import synthetic_batch as jax_synthetic_batch
from tfcgan_tpu.evaluation.suite import pair_metrics as jax_pair_metrics
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.recipes import build_recipe
import tfcgan_tpu_torch
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import generator_from_flax, load_generator_npz
from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.evaluation.suite import pair_metrics
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.recipes.tfcgan import build_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_g_params", os.path.join(REPO, "tools", "export_g_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def slice_setup():
    """fft_glo in float32, its JAX recipe and G params (normal(0, 0.02) from
    numpy), and the JAX Inferencer."""
    cfg = get_experiment("fft_glo")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    recipe = build_recipe(cfg)
    shapes = jax.eval_shape(recipe.G.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.02).astype(np.float32), shapes)
    return cfg, params, JaxInferencer(cfg, recipe, {"G": params})


def _port_inferencer(cfg, params):
    g = build_generator(cfg, "cpu")
    g.load_state_dict(generator_from_flax(params))
    return Inferencer(cfg, g)


def _pngs(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs if f.endswith(".png"))


def _assert_same_pngs(got_dir, want_dir, count):
    names = _pngs(want_dir)
    assert _pngs(got_dir) == names and len(names) == count
    for name in names:
        got = np.asarray(Image.open(os.path.join(got_dir, name))).astype(int)
        want = np.asarray(Image.open(os.path.join(want_dir, name))).astype(int)
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1, name


def test_synthetic_batch_is_the_jax_stream():
    got, want = synthetic_batch(3, 32, seed=5, with_labels=True), \
        jax_synthetic_batch(3, 32, seed=5, with_labels=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_serve_slice_matches_jax(slice_setup, tmp_path):
    cfg, params, jax_inf = slice_setup
    inf = _port_inferencer(cfg, params)
    batch = synthetic_batch(batch_size=2, image_size=64, seed=1)
    got = inf(batch)
    want = np.asarray(jax_inf(batch))
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)

    assert inf.run_test_set([batch], str(tmp_path / "port"), save_spectra=True) == 2
    assert jax_inf.run_test_set([batch], str(tmp_path / "jax"), save_spectra=True) == 2
    _assert_same_pngs(str(tmp_path / "port"), str(tmp_path / "jax"), 4)

    m_got = pair_metrics(torch.from_numpy(batch["B"]), got)
    m_want = jax_pair_metrics(jnp.asarray(batch["B"]), jnp.asarray(want))
    for k in m_want:
        np.testing.assert_allclose(m_got[k].numpy(), np.asarray(m_want[k]), rtol=1e-3,
                                   err_msg=k)


def _write_pairs(root, n=2, size=64):
    rng = np.random.RandomState(11)
    os.makedirs(os.path.join(root, "test"))
    for i in range(n):
        img = (rng.rand(size // 4, size // 2, 3) * 255).astype(np.uint8)
        img = Image.fromarray(img).resize((2 * size, size), Image.Resampling.BILINEAR)
        img.save(os.path.join(root, "test", f"{i:03d}.png"))


def test_cli_test_prep_crop_eval(slice_setup, tmp_path):
    cfg, params, jax_inf = slice_setup
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    _write_pairs(root)
    npz = str(tmp_path / "g_params.npz")
    _load_export_tool().save_g_params(params, npz)

    proc = subprocess.run(
        [sys.executable, "-m", "tfcgan_tpu_torch.cli", "test", "--device", "cpu",
         "--params", npz, "--data-root", root, "--image-size", "64", "--dtype", "float32",
         "--out-dir", out, "--spectra"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 2 stacks" in proc.stdout

    # the JAX package on the same files and weights
    ds = JaxPairedImageDataset(root, "test", 64)
    jax_out = str(tmp_path / "jax_out")
    jax_inf.run_test_set(jax_batch_iterator(ds, 8, shuffle=False, epochs=1, drop_last=False),
                         jax_out, save_spectra=True)
    _assert_same_pngs(out, jax_out, 4)

    # the port's loader gives the JAX loader's batches
    got = next(batch_iterator(PairedImageDataset(root, "test", 64), 2, shuffle=False))
    want = next(jax_batch_iterator(ds, 2, shuffle=False))
    for k in ("A", "B", "T_B"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)

    crops = str(tmp_path / "crops")
    cli.main(["prep-crop", "--stack-dir", out, "--out-root", crops])
    assert sorted(os.listdir(crops)) == ["fake_B", "real_A", "real_B"]
    csv_path = str(tmp_path / "m.csv")
    cli.main(["eval", "--fake-dir", os.path.join(crops, "fake_B"),
              "--real-dir", os.path.join(crops, "real_B"), "--out-csv", csv_path,
              "--device", "cpu"])
    assert len(open(csv_path).read().splitlines()) == 3


def test_cli_defaults_to_cuda_and_refuses_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["test", "--init-seed", "0", "--data-root", str(tmp_path)])


def test_export_tool_round_trips_a_fresh_jax_g(slice_setup, tmp_path):
    cfg, _, jax_inf = slice_setup
    recipe = build_recipe(cfg)
    fresh = jax.jit(recipe.G.init)(jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3)))["params"]
    npz = str(tmp_path / "g_params.npz")
    _load_export_tool().save_g_params(fresh, npz)
    g = build_generator(cfg, "cpu")
    g.load_state_dict(load_generator_npz(npz))
    x = synthetic_batch(batch_size=1, image_size=64, seed=2)["A"]
    want = np.asarray(jax.jit(lambda p, a: recipe.G.apply({"params": p}, a))(fresh, x))
    with torch.inference_mode():
        np.testing.assert_allclose(g(torch.from_numpy(x)).numpy(), want, atol=2e-4)


def test_port_imports_without_jax():
    modules = [m.name for m in pkgutil.walk_packages(tfcgan_tpu_torch.__path__,
                                                     "tfcgan_tpu_torch.")]
    assert "tfcgan_tpu_torch.ops.kernels.blurpool" in modules and len(modules) >= 20
    code = ("import sys, importlib\n"
            "for name in ('tfcgan_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {['tfcgan_tpu_torch', *modules]!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [m for m in sys.modules if m.startswith('tfcgan_tpu')\n"
            "          and not m.startswith('tfcgan_tpu_torch') and sys.modules[m] is not None]\n"
            "assert loaded == [], loaded\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_cuda_or_the_port(where, tmp_path):
    """chip_smoke.py imports nothing of JAX (blocked here) and prints no result
    without a card, or when it stands in a directory without the port."""
    src = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_bytes(open(src, "rb").read())
        cwd, src = str(tmp_path), str(script)
    else:
        cwd = REPO
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = [{src!r}]\n"
            f"runpy.run_path({src!r}, run_name='__main__')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    if where == "repo":
        assert "torch.cuda.is_available() is false" in proc.stderr, proc.stderr
    else:
        assert "ModuleNotFoundError: No module named 'tfcgan_tpu_torch'" in proc.stderr
