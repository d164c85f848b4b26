"""The port's native pair decoder and its default dataset, against the JAX
package's, on the CPU.

The decoder (``tfcgan_tpu_torch/csrc/fastpair.cpp``, built by g++) is the
JAX package's ``native/fastpair.cpp``, byte for byte: on the shapes of
``tests/test_native.py`` and on noise it gives the JAX decoder's bits, and the
default ``PairedImageDataset`` (``use_native=True`` in both packages) gives
the JAX default's items, ``raw_item``, ``BtoA``, cached and labelled items
bit for bit, on pairs that need a resize and pairs that do not. The PIL path
(``use_native=False``) is held to the JAX PIL path the same way. A build
that fails raises, naming ``use_native=False``. About 3 s on one worker.
"""

import filecmp
import os

import numpy as np
import pytest
from PIL import Image

from tfcgan_tpu.data import native as jax_native
from tfcgan_tpu.data.pairs import PairedImageDataset as JaxPairedImageDataset
from tfcgan_tpu.data.pairs import batch_iterator as jax_batch_iterator
from tfcgan_tpu_torch.data import native
from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
from tfcgan_tpu_torch.ops.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(h, w, seed, content):
    """(h, w, 3) uint8: bilinear-upscaled coarse noise ("smooth") or noise
    upscaled 4x ("noise": the case where the decoder is furthest from PIL)."""
    rng = np.random.RandomState(seed)
    coarse = 4 if content == "smooth" else 1
    base = rng.randint(0, 256, (max(1, h // (4 * coarse)), max(1, w // (4 * coarse)), 3),
                       np.uint8)
    return np.asarray(Image.fromarray(base, "RGB").resize((w, h), Image.Resampling.BILINEAR))


def _assert_bits_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_decoder_source_is_the_jax_packages():
    assert filecmp.cmp(os.path.join(REPO, "native", "fastpair.cpp"),
                       os.path.join(REPO, "tfcgan_tpu_torch", "csrc", "fastpair.cpp"),
                       shallow=False)


@pytest.mark.parametrize("content", ["smooth", "noise"])
@pytest.mark.parametrize("in_hw,out", [((64, 256), 64), ((100, 300), 128), ((256, 512), 256)])
def test_process_pair_gives_the_jax_decoders_bits(in_hw, out, content):
    assert jax_native.available() and native.available()
    img = _image(*in_hw, seed=in_hw[0], content=content)
    got, want = native.process_pair(img, out), jax_native.process_pair(img, out)
    for g, w, name in zip(got, want, ("A", "B", "T_B")):
        assert g.dtype == np.float32 and g.tobytes() == w.tobytes(), name


def test_batch_equals_single_and_the_jax_batch():
    imgs = np.stack([_image(72, 160, seed=i, content="noise") for i in range(6)])
    got = native.process_pair_batch(imgs, 64, threads=4)
    want = jax_native.process_pair_batch(imgs, 64, threads=4)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    for i in range(6):
        for g, single in zip(got, native.process_pair(imgs[i], 64)):
            assert g[i].tobytes() == single.tobytes()
    with pytest.raises(ValueError, match="A|B"):
        native.process_pair(imgs[0, ..., 0], 64)


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    """A|B files of three sizes: 64x128 (no resize at 64), 80x200 and 48x96
    (resized up and down), smooth and noise."""
    root = str(tmp_path_factory.mktemp("native_pairs"))
    os.makedirs(os.path.join(root, "train"))
    for i, (h, w, content) in enumerate([(64, 128, "noise"), (80, 200, "noise"),
                                         (48, 96, "smooth"), (80, 200, "smooth"),
                                         (64, 128, "smooth")]):
        Image.fromarray(_image(h, w, 30 + i, content)).save(
            os.path.join(root, "train", f"{i:03d}.png"))
    return root


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("direction,cache", [("AtoB", False), ("AtoB", True), ("BtoA", False)])
def test_dataset_gives_the_jax_datasets_bits(pair_root, use_native, direction, cache):
    labels = {f"{i:03d}.png": (i % 2, i % 4, i % 3) for i in range(4)}  # 004.png unlabelled
    kw = dict(direction=direction, labels=labels, use_native=use_native, cache=cache)
    ours = PairedImageDataset(pair_root, "train", 64, **kw)
    theirs = JaxPairedImageDataset(pair_root, "train", 64, **kw)
    assert (ours._native is None) == (theirs._native is None) == (not use_native)
    for i in range(len(theirs)):
        _assert_bits_equal(ours[i], theirs[i])
        _assert_bits_equal(ours.raw_item(i), theirs.raw_item(i))
    for g, w in zip(batch_iterator(ours, 2, seed=1, epochs=1),
                    jax_batch_iterator(theirs, 2, seed=1, epochs=1), strict=True):
        _assert_bits_equal(g, w)


def test_default_differs_from_pil_where_the_jax_default_does(pair_root):
    """The resized noise pair: the decoder is levels away from PIL, in both
    packages alike; the unresized pair is equal."""
    native_items = PairedImageDataset(pair_root, "train", 64)
    pil_items = PairedImageDataset(pair_root, "train", 64, use_native=False)
    resized = np.abs(native_items.raw_item(1)["A_u8"].astype(int)
                     - pil_items.raw_item(1)["A_u8"].astype(int)).max()
    unresized = np.abs(native_items.raw_item(0)["A_u8"].astype(int)
                       - pil_items.raw_item(0)["A_u8"].astype(int)).max()
    assert resized >= 1 and unresized == 0


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """Loads and builds start from nothing, into ``tmp_path``."""
    native.load.cache_clear()
    _build.load_library.cache_clear()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    yield monkeypatch
    native.load.cache_clear()
    _build.load_library.cache_clear()


def test_a_failed_build_raises(fresh_build, pair_root, tmp_path):
    fresh_build.setattr(_build, "GXX", str(tmp_path / "no-such-g++"))
    assert not native.available()
    with pytest.raises(RuntimeError, match="use_native=False") as info:
        PairedImageDataset(pair_root, "train", 64)
    assert "no-such-g++" in str(info.value.__cause__)
    assert not list((tmp_path / "_build").glob("*"))  # no half-written library is left
    # a broken source fails in the compiler, with its log
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fastpair.cpp").write_text("this is not C++\n")
    fresh_build.setattr(_build, "GXX", "g++")
    fresh_build.setattr(_build, "CSRC_DIR", csrc)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for fastpair.cpp"):
        native.load()
    assert PairedImageDataset(pair_root, "train", 64, use_native=False)[0]["A"].shape == (
        64, 64, 3)


def test_concurrent_builds_load_one_whole_library(fresh_build):
    """Builders that start together (test workers) each rename a whole
    library into place; every one of them loads."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda _: _build.build_libraries(["fastpair"]), range(4)))
    assert [p.name for p in _build.BUILD_DIR.iterdir()] == [_build.library_path("fastpair").name]
    img = _image(64, 128, 0, "noise")
    assert native.process_pair(img, 64)[0].tobytes() == jax_native.process_pair(img, 64)[0].tobytes()
