"""``tools/fit_niqe_pristine_torch.py`` against the committed model and the
JAX package's fit, on the CPU.

The tool's fit over its corpus (32 textured faces of 288², RandomState(7)),
written under ``tmp_path``, equals ``tfcgan_tpu_torch/evaluation/
niqe_pristine.npz`` bit for bit, arrays and file bytes; on a 4-face corpus the
port's ``fit_niqe_model`` equals the JAX one bit for bit. About 3 s.
"""

import importlib.util
import os

import numpy as np

from tfcgan_tpu.data.synth import textured_face_scene as jax_textured_face_scene
from tfcgan_tpu.evaluation.niqe import fit_niqe_model as jax_fit_niqe_model
from tfcgan_tpu_torch.evaluation.niqe import fit_niqe_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "tfcgan_tpu_torch", "evaluation", "niqe_pristine.npz")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "fit_niqe_pristine_torch", os.path.join(ROOT, "tools", "fit_niqe_pristine_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_fit_reproduces_the_committed_model(tmp_path):
    out = str(tmp_path / "niqe_pristine.npz")
    mu, cov = _tool().main(out)
    with np.load(out) as got, np.load(COMMITTED) as want:
        for k, v in (("mu", mu), ("cov", cov)):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            assert np.array_equal(v, want[k]), k
    with open(out, "rb") as f, open(COMMITTED, "rb") as g:
        assert f.read() == g.read()


def test_the_fit_equals_the_jax_fit_on_a_small_corpus():
    rng = np.random.RandomState(3)
    images = list(jax_textured_face_scene(rng, 4, 192) * 255.0)
    assert np.array_equal(np.stack(images), np.stack(_tool().corpus(4, 192, 3)))
    mu, cov = fit_niqe_model(images)
    jmu, jcov = jax_fit_niqe_model(images)
    assert np.array_equal(mu, np.asarray(jmu)) and np.array_equal(cov, np.asarray(jcov))
