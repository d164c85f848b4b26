"""Converted weights (the README's "Pretrained weights" drop-in) in the port:
``weights_msgpack.read_flax_msgpack`` (flax's msgpack without the ``msgpack``
package), ``models.lpips.load_lpips_params`` and
``models.resnet.load_resnet18_backbone``, and the recipes that load them
where the JAX recipes do.

The JAX side writes the files under ``tmp_path``: ``flax.serialization.to_bytes``
of a JAX LPIPS init and of a ``ResNet18(norm="folded")`` backbone (no
``fc``), and ``TFCGAN_LPIPS_WEIGHTS`` / ``TFCGAN_RESNET_WEIGHTS`` point at
them. The port's reader gives the tree ``msgpack`` + flax give; the port's
loaders give the JAX loaders' trees through the bridge, bit for bit; a
truncated, misshaped, extra or missing leaf raises. fft_glo, stn_newmodel3
(``perceptual="auto"``: LPIPS when the weights exist), and in
test_torch_weights_regional.py V4 and V7 (the regional ResNet-18s in the
folded form) build in both packages; the port's
``init`` loads LPIPS and the backbones bit for bit as the files hold them
(V4's and V7's heads stay drawn), and the g_loss terms at one JAX state
(path-seeded draws, its frozen trees from the JAX loaders) and step 0's
draws agree within rtol 1e-4, the bound of test_torch_tfcgan_entries.py;
64², batch 2, float32, deterministic G (the folded CNNs have no norm, so the
64² bands need no 128², unlike test_torch_debiased_entries.py's GroupNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_debiased_entries import entry_batch, entry_cfg, jax_state, jax_step_draws
from tfcgan_tpu.models.lpips import LPIPS as JaxLPIPS
from tfcgan_tpu.models.lpips import load_lpips_params as jax_load_lpips
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu.models.resnet import ResNet18 as JaxResNet18
from tfcgan_tpu.models.resnet import load_resnet18_backbone as jax_load_backbone
from tfcgan_tpu_torch.bridge import lpips_from_flax, resnet18_from_flax, train_state_from_flax
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.models.lpips import load_lpips_params
from tfcgan_tpu_torch.models.resnet import load_resnet18_backbone
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.stn import STNStepDraws
from tfcgan_tpu_torch.train.trainer import _frozen
from tfcgan_tpu_torch.weights_msgpack import read_flax_msgpack

ENTRIES = ("fft_glo", "stn_newmodel3")  # V4 and V7: test_torch_weights_regional.py
VIT = dict(vit_depth=2, vit_dim=96, vit_heads=4, vit_mlp=192)  # test_torch_stn_train.py's


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    lpips = jax.jit(JaxLPIPS().init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
                                     jnp.zeros((1, 64, 64, 3)))
    backbone = jax.jit(JaxResNet18(num_classes=None, norm="folded").init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)))["params"]
    paths = {"lpips": root / "lpips_flax.msgpack", "resnet": root / "resnet18_flax.msgpack"}
    paths["lpips"].write_bytes(serialization.to_bytes(lpips))
    paths["resnet"].write_bytes(serialization.to_bytes(backbone))
    files = {k: str(v) for k, v in paths.items()}
    # what the JAX loaders read from them (each builds its template: read once)
    files["jax_lpips"] = jax.device_get(jax_load_lpips(files["lpips"]))
    files["jax_resnet"] = jax.device_get(jax_load_backbone(files["resnet"]))
    return files


def _assert_same_tree(got, want, path=""):
    assert isinstance(got, dict) and sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, f"{path}/{k}"
            assert np.array_equal(got[k], want[k]), f"{path}/{k}"


def _bits_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32)), k


def test_reader_and_loaders_equal_flax_and_the_jax_loaders(weight_files):
    for path in (weight_files["lpips"], weight_files["resnet"]):
        with open(path, "rb") as f:
            _assert_same_tree(read_flax_msgpack(path), serialization.msgpack_restore(f.read()))
    _bits_equal(load_lpips_params(weight_files["lpips"]), lpips_from_flax(weight_files["jax_lpips"]))
    _bits_equal(load_resnet18_backbone(weight_files["resnet"]),
                resnet18_from_flax(weight_files["jax_resnet"]))


def test_broken_files_raise(weight_files, tmp_path):
    data = open(weight_files["lpips"], "rb").read()
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(data[:-100])
    with pytest.raises(ValueError, match="truncated"):
        load_lpips_params(str(cut))
    tree = serialization.msgpack_restore(open(weight_files["resnet"], "rb").read())
    for name, edit in (("misshaped", lambda t: t["layer0_0"]["conv1"].update(
                            kernel=np.zeros((3, 3, 64, 32), np.float32))),
                       ("extra", lambda t: t.update(head={"kernel": np.zeros((2, 2), np.float32)})),
                       ("missing", lambda t: t["layer1_1"].pop("conv2"))):
        broken = jax.tree_util.tree_map(np.asarray, tree)
        edit(broken)
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(serialization.msgpack_serialize(broken))
        with pytest.raises(ValueError, match=name if name != "extra" else "flax path|extra"):
            load_resnet18_backbone(str(path))


def _cfg(name):
    cfg = entry_cfg(name, size=64)
    if cfg.recipe == "stn":
        cfg = cfg.replace(extra={**cfg.extra, **VIT})
    return cfg


def assert_recipe_loads_the_weights_and_matches_jax(name, weight_files, monkeypatch):
    monkeypatch.setenv("TFCGAN_LPIPS_WEIGHTS", weight_files["lpips"])
    monkeypatch.setenv("TFCGAN_RESNET_WEIGHTS", weight_files["resnet"])
    cfg = _cfg(name)
    recipe, state = jax_state(cfg)
    assert recipe.perceptual == "lpips"
    # the JAX init's frozen trees: the files, as its loaders read them
    frozen = dict(state.frozen)
    frozen["lpips"] = weight_files["jax_lpips"]
    regional = cfg.recipe == "tfcgan" and cfg.loss.conditional
    backbone = weight_files["jax_resnet"] if regional else None
    for k in ("cnn_hair", "cnn_eyes") if regional else ():
        if f"{k}_bb" in frozen:  # V4: the backbone frozen, the head with G
            frozen[f"{k}_bb"] = backbone
        else:  # V7: all frozen, the head drawn
            frozen[k] = {**backbone, "fc": frozen[k]["fc"]}
    state = state.replace(frozen=frozen)

    # the port's own init loads the same tensors
    port = build_recipe(cfg, "cpu")
    assert port.perceptual == "lpips"
    port.init(torch.Generator().manual_seed(0))
    _bits_equal(port.lpips.state_dict(), lpips_from_flax(frozen["lpips"]))
    if regional:
        want = resnet18_from_flax(backbone)
        for cnn in port.cnns.values():
            got = {k: v for k, v in cnn.state_dict().items() if not k.startswith("fc.")}
            _bits_equal(got, want)
            assert cnn.stem.bias is not None  # the folded form

    # g_loss at the JAX state's weights
    train_state_from_flax(state, port, torch.Generator())
    batch = entry_batch(cfg)
    g_rng, _ = jax.random.split(jax.random.fold_in(state.rng, 0))
    spectral = jax_power_iteration(state.d_params, state.spectral)
    _, (_, want) = jax.jit(recipe.g_loss)(state.g_params, state.d_params, spectral,
                                          state.frozen, batch, g_rng)
    if cfg.recipe == "stn":
        draws = STNStepDraws(None, None, None)
        tb = {k: torch.from_numpy(batch[k]) for k in ("A", "B")}
    else:
        draws = jax_step_draws(state.rng, 0, cfg)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    spectral_power_iteration(port.D, order="vu")
    with torch.no_grad(), _frozen(port.D):
        _, _, got = port.g_loss(tb, draws)
    want = {k: float(v) for k, v in want.items() if not k.startswith("_")}
    assert sorted(got) == sorted(want) and "g_lpips" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ENTRIES)
def test_recipes_load_the_weights_and_match_jax(name, weight_files, monkeypatch):
    assert_recipe_loads_the_weights_and_matches_jax(name, weight_files, monkeypatch)
