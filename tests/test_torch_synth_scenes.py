"""The port's ``data/synth.py`` against the JAX package's.

The scene, registration and iterator functions draw from the same
``np.random.RandomState`` stream as ``tfcgan_tpu.data.synth``, so their
arrays must be equal bit for bit (``np.array_equal``), the ground truth's
theta and B_aligned too. ``synthetic_batch_device`` draws on a device from a
torch generator: held to the host batch's shapes, types, ranges and LUT, and
to itself for one seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tfcgan_tpu.data import synth as jax_synth
from tfcgan_tpu_torch import data as port_data
from tfcgan_tpu_torch.data import synth
from tfcgan_tpu_torch.ops.temperature import TEMP_MAX_C, TEMP_MIN_C

SEEDS = (0, 1, 9999)


def _assert_trees_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("seed", SEEDS)
def test_face_scene_matches_jax(seed, size):
    got = synth._face_scene(np.random.RandomState(seed), 3, size)
    want = jax_synth._face_scene(np.random.RandomState(seed), 3, size)
    assert got.dtype == want.dtype and got.shape == (3, size, size)
    assert np.array_equal(got, want)
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("seed", SEEDS)
def test_textured_face_scene_matches_jax(seed, size):
    got = synth.textured_face_scene(np.random.RandomState(seed), 2, size)
    want = jax_synth.textured_face_scene(np.random.RandomState(seed), 2, size)
    assert got.dtype == want.dtype and got.shape == (2, size, size)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("misalign", [True, False], ids=["misaligned", "aligned"])
@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("seed", SEEDS)
def test_registration_batch_matches_jax(seed, size, misalign):
    kw = {} if misalign else {"max_translate": 0.0, "max_rotate": 0.0}
    batch, truth = synth.synthetic_registration_batch(3, size, seed=seed, **kw)
    want_batch, want_truth = jax_synth.synthetic_registration_batch(3, size, seed=seed, **kw)
    _assert_trees_equal(batch, want_batch)
    _assert_trees_equal(truth, want_truth)
    if not misalign:  # the identity theta: B is B_aligned resampled in place
        assert np.array_equal(truth["theta"][:, :, :2], np.broadcast_to(np.eye(2), (3, 2, 2)))
        np.testing.assert_allclose(batch["B"], truth["B_aligned"], atol=1e-5)  # grid rounding
    else:
        assert not np.array_equal(batch["B"], truth["B_aligned"])


@pytest.mark.parametrize("kw", [dict(batch_size=2, image_size=16),
                                dict(batch_size=2, image_size=16, with_labels=True)],
                         ids=["plain", "labelled"])
def test_synthetic_iterator_matches_jax(kw):
    got = list(port_data.synthetic_iterator(3, **kw))
    want = list(jax_synth.synthetic_iterator(3, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    _assert_trees_equal(got[1], synth.synthetic_batch(seed=1, **kw))  # seeds 0, 1, 2


def test_registration_iterator_matches_jax():
    got = list(synth.synthetic_registration_iterator(3, batch_size=2, image_size=32))
    want = list(jax_synth.synthetic_registration_iterator(3, batch_size=2, image_size=32))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    # seeds 1, 2, 3
    _assert_trees_equal(got[0], synth.synthetic_registration_batch(2, 32, seed=1)[0])


@pytest.mark.parametrize("with_labels", [False, True], ids=["plain", "labelled"])
def test_synthetic_batch_device(with_labels):
    n, size, classes = 4, 32, 5
    batch = synth.synthetic_batch_device(n, size, seed=3, with_labels=with_labels,
                                         num_classes=classes, device="cpu")
    host = synth.synthetic_batch(n, size, seed=3, with_labels=with_labels, num_classes=classes)
    assert sorted(batch) == sorted(host)
    for k, v in batch.items():
        assert v.device.type == "cpu" and tuple(v.shape) == host[k].shape, k
        assert v.dtype == torch.from_numpy(host[k]).dtype, k
    for k in ("A", "B"):
        x = batch[k]
        assert -1.0 <= float(x.min()) and float(x.max()) <= 1.0
        # constant 8 x 8 blocks, as the host batch has
        assert torch.equal(x, x[:, ::8, ::8].repeat_interleave(8, 1).repeat_interleave(8, 2))
    red_u8 = torch.round((batch["B"][..., 0] * 0.5 + 0.5) * 255.0)
    torch.testing.assert_close(batch["T_B"], TEMP_MIN_C + red_u8 * (TEMP_MAX_C - TEMP_MIN_C)
                               / 255.0, rtol=0, atol=0)
    assert TEMP_MIN_C <= float(batch["T_B"].min()) and float(batch["T_B"].max()) <= TEMP_MAX_C
    if with_labels:
        lab3 = batch["LAB3"]
        for col, high in enumerate((2, classes, 3)):
            assert 0 <= int(lab3[:, col].min()) and int(lab3[:, col].max()) < high
        assert torch.equal(batch["LAB"], lab3[:, 1])
    again = synth.synthetic_batch_device(n, size, seed=3, with_labels=with_labels,
                                         num_classes=classes, device="cpu")
    other = synth.synthetic_batch_device(n, size, with_labels=with_labels, num_classes=classes,
                                         device="cpu",
                                         generator=torch.Generator().manual_seed(3))
    for k in batch:
        assert torch.equal(batch[k], again[k]) and torch.equal(batch[k], other[k]), k
    differs = synth.synthetic_batch_device(n, size, seed=4, device="cpu")
    assert not torch.equal(batch["A"], differs["A"])
