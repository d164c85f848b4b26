"""The port's augmentations and offline data prep against the JAX package's,
on the CPU.

Augment: ``random_hflip``, ``random_vflip``, ``random_erasing`` and
``test_time_augment`` (with and without erasing) given the JAX functions'
own draws (the uniforms of their keys) equal the JAX outputs bit for bit.
Prep: ``combine_a_and_b`` and ``crop_stacks`` write files whose decoded
pixels equal the JAX package's; ``make_registered_dataset`` through the
port's stn_newmodel3 ``Inferencer`` (64², small ViT, weights bridged from
the JAX state) against the JAX one: every pixel within 1 grey level and at
least 99 % equal (the float32 warps of the two packages differ by up to 5e-4,
test_torch_stn_train.py, which can move a value across a truncation). About
10 s on one worker.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_stn_train import _cfg as stn_cfg
from test_torch_stn_train import _jax_state as stn_jax_state
from tfcgan_tpu.data import augment as jax_augment
from tfcgan_tpu.data import prep as jax_prep
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu_torch.bridge import stn_generators_from_flax
from tfcgan_tpu_torch.data import augment, prep
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.recipes.stn import build_generators


def _images(n=6, h=24, w=40, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, h, w, 3)).astype(np.float32)


def _bits(x):
    return np.asarray(x).tobytes()


def _erase_draws(key, n):
    """The five unit uniforms ``jax_augment.random_erasing`` draws from ``key``."""
    keys = jax.random.split(key, 6)[:5]
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys]))


def _flip_mask(key, n, p=0.5):
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,)) < p))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flips_and_erasing_give_the_jax_bits(seed):
    x = _images(seed=seed)
    key = jax.random.PRNGKey(seed)
    t = torch.from_numpy(x)
    assert _bits(augment.random_hflip(t, _flip_mask(key, 6))) == _bits(
        jax_augment.random_hflip(key, jnp.asarray(x)))
    assert _bits(augment.random_vflip(t, _flip_mask(key, 6, 0.3))) == _bits(
        jax_augment.random_vflip(key, jnp.asarray(x), p=0.3))
    for kw in ({}, {"p": 1.0, "value": -1.0}, {"p": 0.8, "scale": (0.3, 0.6), "ratio": (0.5, 2.0)}):
        got = augment.random_erasing(t, _erase_draws(key, 6), **kw)
        want = jax_augment.random_erasing(key, jnp.asarray(x), **kw)
        assert _bits(got) == _bits(want), kw
    # erasing did erase somewhere at p = 1
    assert bool((augment.random_erasing(t, _erase_draws(key, 6), p=1.0, value=5.0) == 5.0).any())


@pytest.mark.parametrize("erase", [False, True])
def test_test_time_augment_gives_the_jax_bits(erase):
    batch = {"A": _images(8, 32, 32, seed=3), "B": _images(8, 32, 32, seed=4),
             "T_B": np.zeros((8, 32, 32), np.float32)}
    key = jax.random.PRNGKey(7)
    kh, kv, ke = jax.random.split(key, 3)
    draws = {"hflip": _flip_mask(kh, 8), "vflip": _flip_mask(kv, 8),
             "erase": _erase_draws(ke, 8)}
    got = augment.test_time_augment(batch, draws, erase=erase)
    want = jax_augment.test_time_augment(key, {k: jnp.asarray(v) for k, v in batch.items()},
                                         erase=erase)
    for k in ("A", "B"):
        assert _bits(got[k]) == _bits(want[k]), k
    assert got["T_B"] is batch["T_B"]


def test_draw_helpers():
    gen = torch.Generator().manual_seed(0)
    draws = augment.draw_test_time_augment(gen, 5)
    assert draws["hflip"].dtype == torch.bool and draws["hflip"].shape == (5,)
    assert draws["erase"].shape == (5, 5) and float(draws["erase"].max()) < 1.0
    again = augment.draw_test_time_augment(torch.Generator().manual_seed(0), 5)
    assert all(torch.equal(draws[k], again[k]) for k in draws)


def _decoded(d):
    return {f: np.asarray(Image.open(os.path.join(d, f)).convert("RGB"))
            for f in sorted(os.listdir(d))}


def _assert_same_dirs(got_dir, want_dir):
    got, want = _decoded(got_dir), _decoded(want_dir)
    assert list(got) == list(want) and got
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def test_combine_a_and_b_and_crop_stacks_decode_to_the_jax_pixels(tmp_path):
    rng = np.random.RandomState(5)
    for d in ("A", "B"):
        os.makedirs(tmp_path / d)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (20, 24, 3), np.uint8)).save(tmp_path / "A" / f"{i}.png")
        # B at another size: resized to A's
        Image.fromarray(rng.randint(0, 256, (30, 17, 3), np.uint8)).save(tmp_path / "B" / f"{i}.png")
    Image.fromarray(rng.randint(0, 256, (20, 24, 3), np.uint8)).save(tmp_path / "A" / "only_a.png")
    for name, fn in (("port", prep.combine_a_and_b), ("jax", jax_prep.combine_a_and_b)):
        assert fn(str(tmp_path / "A"), str(tmp_path / "B"), str(tmp_path / f"ab_{name}")) == 3
    _assert_same_dirs(tmp_path / "ab_port", tmp_path / "ab_jax")
    assert prep.combine_a_and_b(str(tmp_path / "A"), str(tmp_path / "B"),
                                str(tmp_path / "ab_serial"), workers=1) == 3
    _assert_same_dirs(tmp_path / "ab_serial", tmp_path / "ab_jax")

    os.makedirs(tmp_path / "stacks")
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (3 * 16, 16, 3), np.uint8)).save(
            tmp_path / "stacks" / f"{i:05d}.png")
    roles = ["real_A", "fake_B", "real_B"]
    assert prep.crop_stacks(str(tmp_path / "stacks"), str(tmp_path / "port"), roles) == 2
    assert jax_prep.crop_stacks(str(tmp_path / "stacks"), str(tmp_path / "jax"), roles) == 2
    for r in roles:
        _assert_same_dirs(tmp_path / "port" / r, tmp_path / "jax" / r)


def test_make_registered_dataset_against_the_jax_one(tmp_path):
    cfg = stn_cfg()
    recipe, state = stn_jax_state(cfg)
    nets = build_generators(cfg, "cpu")
    nets.load_state_dict(stn_generators_from_flax(state.g_params))
    batches = [synthetic_batch(batch_size=2, image_size=64, seed=s) for s in (1, 2)]
    assert prep.make_registered_dataset(Inferencer(cfg, nets), batches,
                                        str(tmp_path / "port")) == 4
    assert jax_prep.make_registered_dataset(JaxInferencer(cfg, recipe, state.g_params), batches,
                                            str(tmp_path / "jax")) == 4
    got, want = _decoded(tmp_path / "port"), _decoded(tmp_path / "jax")
    assert list(got) == list(want) == [f"{i:05d}.png" for i in range(4)]
    for f in want:
        g, w = got[f].astype(int), want[f].astype(int)
        assert g.shape == w.shape == (64, 128, 3)
        assert np.abs(g - w).max() <= 1 and (g == w).mean() >= 0.99, f
        assert np.array_equal(g[:, :64], w[:, :64])  # A is copied, not warped
    # the warp moved B
    b0 = np.clip((batches[0]["B"][0] * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    assert not np.array_equal(got["00000.png"][:, 64:], b0)
