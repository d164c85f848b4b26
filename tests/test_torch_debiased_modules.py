"""The debiased family's modules and data path, the port against the JAX
package, float32 on the CPU, with the same flax-initialised weights carried
over by ``bridge``: ``ConditionalGeneratorUNet`` (64², batch 2),
``AuxClassifierDiscriminator`` with one and with three heads, ``ResNet18``
in both norm forms, outputs and input gradients within 2e-4 (of max|g| for
the gradients); ``saliency_mask`` within 1e-5 and its gradient within 1e-4
x max|g|; ``debias_axes``; ``load_annotations_csv`` against the JAX one
(pandas); the labels through ``PairedImageDataset``, ``batch_iterator``,
``DevicePool`` and the uint8 prefetch path bit for bit; and the exported
conditional G (``tools/export_g_params.py`` -> ``load_generator_npz``) and
the mask G served by ``Inferencer`` against the JAX ``Inferencer``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli_train import _assert_bits_equal, _write_pairs
from test_torch_debiased_entries import _draw, entry_cfg
from test_torch_serve import _load_export_tool
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.data.pairs import PairedImageDataset as JaxPairedImageDataset
from tfcgan_tpu.data.pairs import batch_iterator as jax_batch_iterator
from tfcgan_tpu.data.pairs import load_annotations_csv as jax_load_annotations_csv
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.models.discriminator import AuxClassifierDiscriminator as JaxAuxD
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu.models.resnet import ResNet18 as JaxResNet18
from tfcgan_tpu.models.unet import ConditionalGeneratorUNet as JaxCondG
from tfcgan_tpu.ops.saliency import saliency_mask as jax_saliency_mask
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.recipes.tfcgan import debias_axes as jax_debias_axes
from tfcgan_tpu_torch.bridge import (aux_discriminator_from_flax, conditional_generator_from_flax,
                                     generator_from_flax, load_generator_npz, resnet18_from_flax)
from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator, load_annotations_csv
from tfcgan_tpu_torch.data.pool import DevicePool
from tfcgan_tpu_torch.data.prefetch import PrefetchLoader, device_prefetch
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.models.discriminator import AuxClassifierDiscriminator
from tfcgan_tpu_torch.models.resnet import ResNet18
from tfcgan_tpu_torch.models.unet import ConditionalGeneratorUNet
from tfcgan_tpu_torch.ops.saliency import saliency_mask
from tfcgan_tpu_torch.recipes.tfcgan import build_generator, debias_axes


def _noise(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _variables(module, prefix: str, *args) -> dict:
    """The module's flax variables from ``_draw`` (``prefix`` picks its
    distributions), without running flax's init."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *map(jnp.asarray, args))
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(prefix + jax.tree_util.keystr(p), s.shape), dict(shapes))


def _compare(jax_fn, port_fn, inputs, weights, atol=2e-4):
    """jax_fn and port_fn of the numpy ``inputs`` -> their outputs within
    ``atol``, and the gradients of sum(output_i * weights_i) to every input
    within ``atol`` x max|g|."""
    def loss(*xs):
        outs = jax_fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), outs

    (_, want), want_g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs))), has_aux=True))(*map(jnp.asarray, inputs))
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    got = port_fn(*ts)
    got = got if isinstance(got, tuple) else (got,)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(got, weights)).backward()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol)
    for t, w in zip(ts, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=atol * np.abs(w).max())


def test_conditional_generator_matches_jax():
    x, lab = _noise((2, 64, 64, 3), 0), np.array([[1, 2, 0], [0, 3, 2]], np.float32)
    jg = JaxCondG()
    params = _variables(jg, "['G']", x, lab)["params"]
    g = ConditionalGeneratorUNet(image_size=64).eval()
    g.load_state_dict(conditional_generator_from_flax(params))
    _compare(lambda a, b: jg.apply({"params": params}, a, b), g, [x, lab],
             [_noise((2, 64, 64, 3), 1)])


@pytest.mark.parametrize("num_gender,num_age", [(0, 0), (2, 3)])
def test_aux_discriminator_matches_jax(num_gender, num_age):
    a, b = _noise((2, 64, 64, 3), 2), _noise((2, 64, 64, 3), 3)
    jd = JaxAuxD(num_classes=4, num_gender=num_gender, num_age=num_age)
    variables = _variables(jd, "['D']", a, b)
    # u and v unit vectors, then sigma near W's top singular value, as in training
    spectral = jax.tree.map(lambda v: v / np.linalg.norm(v), variables["spectral"])
    spectral = jax.jit(lambda p, s: functools.reduce(
        lambda s, _: jax_power_iteration(p, s), range(5), s))(variables["params"], spectral)
    variables = {"params": variables["params"], "spectral": spectral}
    d = AuxClassifierDiscriminator(6, 64, 4, num_gender, num_age)
    d.load_state_dict(aux_discriminator_from_flax(variables["params"], variables["spectral"]))

    def flat(out):  # (logits, probs) -> a flat tuple
        logits, probs = out
        return (logits, *(probs if isinstance(probs, tuple) else (probs,)))

    heads = 3 if num_gender else 1
    weights = [_noise((2, 4, 4, 1), 4)] + [_noise((2, k), 5 + i) for i, k in
                                           enumerate((2, 4, 3) if heads == 3 else (4,))]
    _compare(lambda x, y: flat(jd.apply(variables, x, y)), lambda x, y: flat(d(x, y)),
             [a, b], weights)


@pytest.mark.parametrize("norm", ["gn", "folded"])
def test_resnet18_matches_jax(norm):
    # the 128² run's hair band: at 64² the 25-row band reaches the last stage
    # as 1 x 2 maps, where the two-value GroupNorm cancels in float32 in both
    # packages (see test_torch_debiased_entries.entry_size)
    x = _noise((2, 50, 128, 3), 9)
    jr = JaxResNet18(num_classes=4, norm=norm)
    params = _variables(jr, f"['cnn_{norm}']", x)["params"]
    # positive shifts (the norms' or, folded, the convs' biases) keep the
    # ReLUs' inputs off 0, where float32 rounding would flip a kink: zero
    # shifts put half of them there
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(2.0, 3.0, v.shape).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("['bias']") and v.ndim == 1 and
        not jax.tree_util.keystr(p).startswith("['fc']") else v, params)
    r = ResNet18(4, norm=norm).eval()
    r.load_state_dict(resnet18_from_flax(params))
    _compare(lambda v: jr.apply({"params": params}, v), r, [x], [_noise((2, 4), 10)])


def test_saliency_mask_matches_jax():
    _compare(jax_saliency_mask, saliency_mask, [_noise((2, 64, 64, 3), 11)],
             [_noise((2, 64, 64, 1), 13)], atol=1e-5)
    # the synthetic batch's constant 8 x 8 blocks: the Laplacian's minimum is
    # a tie of thousands of zeros (exact in one package, 1 ulp off in the
    # other), so its gradient goes elsewhere; the masks themselves agree
    x = synthetic_batch(2, 64, seed=12)["A"]
    np.testing.assert_allclose(saliency_mask(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_saliency_mask(jnp.asarray(x))), atol=1e-5)


def test_debias_axes_match_jax():
    for v in range(1, 8):
        lc = get_experiment("fft_patch_debiased").loss
        lc = type(lc)(**{**lc.__dict__, "debias_version": v})
        assert debias_axes(lc) == jax_debias_axes(lc), v
    for v in (0, 8):
        with pytest.raises(ValueError):
            debias_axes(type(lc)(**{**lc.__dict__, "debias_version": v}))


def test_load_annotations_csv_matches_jax(tmp_path):
    rows = ["file,gender,ethnicity,age,extra", "data/train/000.png,1,2,0,x",
            "/abs/001.png,0,3,2,y", "", "002.png,1,0,1.0,z"]
    path = tmp_path / "annots.csv"
    path.write_text("\n".join(rows) + "\n")
    for kw in ({"label_cols": (1, 2, 3)}, {}, {"label_col": 1}, {"file_col": 0, "label_col": 3}):
        got = load_annotations_csv(str(path), **kw)
        want = jax_load_annotations_csv(str(path), **kw)
        assert got == want and list(got) == ["000.png", "001.png", "002.png"], kw
        assert all(type(v) is type(want[k]) for k, v in got.items())


@pytest.fixture(scope="module")
def labelled_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("labelled"))
    _write_pairs(root, "train", 5, 16, seed=20)
    labels = {f"{i:03d}.png": (i % 2, i % 4, (i + 1) % 3) for i in range(5)}
    return root, labels


def _check_labels_through_the_input_paths(labelled_set, size=16, **kw):
    root, labels = labelled_set
    ds = PairedImageDataset(root, "train", size, labels=labels, **kw)
    jds = JaxPairedImageDataset(root, "train", size, labels=labels, **kw)
    assert set(ds[0]) == {"A", "B", "T_B", "LAB3", "LAB"} and ds[0]["LAB3"].dtype == np.int32
    want = list(jax_batch_iterator(jds, 2, seed=3, epochs=2))
    got = list(batch_iterator(ds, 2, seed=3, epochs=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_bits_equal(g, w)
    pool = DevicePool(ds, "cpu")
    for idx, w in zip(pool.index_batches(2, seed=3, epochs=2), want, strict=True):
        _assert_bits_equal(pool.batch(idx), w)
    raw = PrefetchLoader(ds, 2, num_workers=2, seed=3, epochs=2, raw=True)
    for g, w in zip(device_prefetch(iter(raw), "cpu", via_uint8=True), want, strict=True):
        _assert_bits_equal(g, w)
    # a file the annotations lack: label 0 and no LAB3, as in the JAX loader
    partial = {k: v for k, v in labels.items() if k != "001.png"}
    item = PairedImageDataset(root, "train", size, labels=partial, **kw)[1]
    jitem = JaxPairedImageDataset(root, "train", size, labels=partial, **kw)[1]
    assert set(item) == set(jitem) == {"A", "B", "T_B", "LAB"} and item["LAB"] == jitem["LAB"] == 0
    _assert_bits_equal(item, jitem)


def test_labels_through_the_input_paths(labelled_set):
    _check_labels_through_the_input_paths(labelled_set, use_native=False)


def test_labels_through_the_input_paths_native_default(labelled_set):
    # both packages' default decoder, at the file's size and resized from it
    _check_labels_through_the_input_paths(labelled_set)
    _check_labels_through_the_input_paths(labelled_set, size=12)


@pytest.mark.parametrize("name", ["fft_patch_debiased", "fft_patch_mask"])
def test_served_g_matches_the_jax_inferencer(name, tmp_path):
    cfg = entry_cfg(name, size=64)
    recipe = jax_build_recipe(cfg)
    batch = synthetic_batch(2, 64, seed=21, with_labels=True)
    args = (jnp.asarray(batch["A"]), jnp.asarray(batch["LAB3"], jnp.float32))
    params = _variables(recipe.G, f"['{name}']", *(
        args if cfg.loss.conditional else (np.zeros((1, 64, 64, 4), np.float32),)))["params"]
    want = np.asarray(JaxInferencer(cfg, recipe, {"G": params})(batch))
    g = build_generator(cfg, "cpu")
    if cfg.loss.conditional:  # the export tool's npz, as a user carries weights over
        npz = str(tmp_path / "g_params.npz")
        _load_export_tool().save_g_params(params, npz)
        g.load_state_dict(load_generator_npz(npz))
        assert sorted(np.load(npz).files)[:2] == ["label_fc/bias", "label_fc/kernel"]
    else:
        g.load_state_dict(generator_from_flax(params))
    got = Inferencer(cfg, g)(batch).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    if cfg.loss.conditional:
        with pytest.raises(ValueError, match="LAB3"):
            Inferencer(cfg, g)({"A": batch["A"]})
        assert os.path.exists(npz)
