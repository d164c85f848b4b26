"""``cli train`` of the port and the input paths it picks, on the CPU.

(e) ``DevicePool`` (index order and on-device assembly), ``PrefetchLoader``
(float and uint8 items) through ``device_prefetch`` and ``BalancedMixture``,
each bit for bit against ``batch_iterator`` or the JAX package's
counterpart on one PNG set and seed; (g) the journey ``cli train`` (fft_glo,
64², batch 2, float32: step 0 on the first batch, then 2 epochs of 2 steps,
the JAX CLI's step arithmetic), ``--resume``, ``test --checkpoint`` and the
``needs_extra_root`` refusal; the tfc_diff journey (``train`` with the
sample hook, then ``gen --checkpoint``) at a 4-step chain. The stn and nemar
journeys (``train`` with the sample hook, then ``test --checkpoint``) are in
the slow tier.

About 13 s on one worker with the imports; the slow tier 24 s more.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tfcgan_tpu.data.mixture import BalancedMixture as JaxBalancedMixture
from tfcgan_tpu.data.pairs import PairedImageDataset as JaxPairedImageDataset
from tfcgan_tpu.data.pairs import batch_iterator as jax_batch_iterator
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.data.mixture import BalancedMixture
from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
from tfcgan_tpu_torch.data.pool import DevicePool
from tfcgan_tpu_torch.data.prefetch import PrefetchLoader, device_prefetch, is_device_batch
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.evaluation.suite import save_image_grid
from tfcgan_tpu_torch.train.checkpoint import latest_checkpoint


def _write_pairs(root, split, count, size, seed):
    """``count`` synthetic A|B PNG pairs at ``size``² under ``root/split``."""
    pairs = synthetic_batch(batch_size=count, image_size=size, seed=seed)
    noise = np.random.RandomState(seed).uniform(-0.2, 0.2, pairs["A"].shape).astype(np.float32)
    for i in range(count):
        save_image_grid([np.clip(pairs["A"][i] + noise[i], -1, 1), pairs["B"][i]],
                        os.path.join(root, split, f"{i:03d}.png"), axis=1)


def _assert_bits_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g.view(np.uint32 if w.dtype == np.float32 else w.dtype),
                              w.view(np.uint32 if w.dtype == np.float32 else w.dtype)), k


@pytest.fixture(scope="module")
def pair_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pairs"))
    _write_pairs(root, "train", 7, 32, seed=0)
    _write_pairs(os.path.join(root, "second"), "train", 5, 32, seed=1)
    return root


def test_pool_batches_equal_batch_iterator(pair_set):
    ds = PairedImageDataset(pair_set, "train", 32)
    pool = DevicePool(ds, "cpu")
    assert pool.n == 7 and pool.steps_per_epoch(2) == 3
    want = list(batch_iterator(ds, 2, seed=5, epochs=2))
    indices = list(pool.index_batches(2, seed=5, epochs=2))
    assert len(indices) == len(want) == 6
    for idx, w in zip(indices, want):
        got = pool.batch(idx)
        assert is_device_batch(got, "cpu")
        _assert_bits_equal(got, w)


def test_prefetch_paths_equal_batch_iterator(pair_set):
    ds = PairedImageDataset(pair_set, "train", 32, direction="BtoA", cache=True)
    want = list(batch_iterator(ds, 3, seed=2, epochs=2))
    # 2 batches of 3 an epoch: 6 or 7 pairs decoded, once each
    cached = sorted(ds._cache)
    assert 6 <= len(cached) <= 7 and ds._raw_pair(cached[0]) is ds._cache[cached[0]]
    floats = PrefetchLoader(ds, 3, num_workers=3, seed=2, epochs=2)
    assert len(floats) == 2
    for got, w in zip(device_prefetch(iter(floats), "cpu"), want, strict=True):
        _assert_bits_equal(got, w)
    raw = PrefetchLoader(ds, 3, num_workers=2, seed=2, epochs=2, raw=True)
    for got, w in zip(device_prefetch(iter(raw), "cpu", via_uint8=True), want, strict=True):
        _assert_bits_equal(got, w)

    class Broken:
        def __len__(self):
            return 7

        def __getitem__(self, idx):
            if idx == 3:
                raise ValueError("unreadable pair 3")
            return ds[idx]

    with pytest.raises(ValueError, match="unreadable pair 3"):
        list(device_prefetch(iter(PrefetchLoader(Broken(), 2, num_workers=2, epochs=1)), "cpu"))


def _check_mixture(roots, **kw):
    ours = [PairedImageDataset(r, "train", 32, **kw) for r in roots]
    theirs = [JaxPairedImageDataset(r, "train", 32, **kw) for r in roots]
    got = BalancedMixture([lambda d=d: batch_iterator(d, 2, seed=42, epochs=1) for d in ours],
                          4, seed=42)
    want = JaxBalancedMixture(
        [lambda d=d: jax_batch_iterator(d, 2, seed=42, epochs=1) for d in theirs], 4, seed=42)
    for _ in range(5):  # past the second set's epoch of 2 batches: its iterator refills
        _assert_bits_equal(next(got), next(want))


def test_mixture_equals_the_jax_mixture(pair_set):
    _check_mixture([pair_set, os.path.join(pair_set, "second")], use_native=False)


def test_mixture_equals_the_jax_mixture_native_default(pair_set, tmp_path):
    """Both packages' default decoder, on the set and on a copy of its second
    root that needs a resize (40 x 80 files at image size 32)."""
    from PIL import Image

    resized = str(tmp_path / "resized")
    os.makedirs(os.path.join(resized, "train"))
    for f in sorted(glob.glob(os.path.join(pair_set, "second", "train", "*.png"))):
        with Image.open(f) as img:
            img.resize((80, 40), Image.Resampling.BILINEAR).save(
                os.path.join(resized, "train", os.path.basename(f)))
    _check_mixture([pair_set, os.path.join(pair_set, "second")])
    _check_mixture([pair_set, resized])


def _log_steps(out):
    with open(os.path.join(out, "logs", "fft_glo.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert all(np.isfinite(r[k]) for r in rows for k in r if k not in ("ts", "step"))
    return [r["step"] for r in rows]


def test_train_resume_and_serve_journey(tmp_path):
    data, runs, resumed, results = (str(tmp_path / d) for d in ("data", "runs", "resumed",
                                                                 "results"))
    _write_pairs(data, "train", 5, 64, seed=3)
    _write_pairs(data, "test", 4, 64, seed=4)
    common = ["--experiment", "fft_glo", "--data-root", data, "--image-size", "64",
              "--batch-size", "2", "--dtype", "float32", "--device", "cpu"]
    # 5 pairs at batch 2: 2 steps an epoch; step 0 on the first batch, then
    # epochs ending at steps 3 and 5, a checkpoint after each (the final save
    # is step 5 again)
    cli.main(["train", *common, "--n-epochs", "2", "--checkpoint-interval", "1",
              "--sample-interval", "2", "--out-dir", runs])
    assert sorted(d for d in os.listdir(runs) if d.startswith("step_")) == [
        "step_00000003", "step_00000005"]
    assert _log_steps(runs) == [1, 2, 4]  # each fit logs its first step
    assert sorted(os.listdir(os.path.join(runs, "samples"))) == [
        "0000002.png", "0000004.png", "index.html"]

    # a resume restarts the data order, so only the step count and the log are checked
    cli.main(["train", *common, "--n-epochs", "1", "--checkpoint-interval", "1",
              "--out-dir", resumed, "--resume", os.path.join(runs, "step_00000003")])
    assert latest_checkpoint(resumed) == os.path.join(resumed, "step_00000005")
    assert _log_steps(resumed) == [4]

    cli.main(["test", *common, "--checkpoint", latest_checkpoint(resumed), "--out-dir",
              results])
    assert len(glob.glob(os.path.join(results, "*.png"))) == 4
    with pytest.raises(SystemExit, match="exactly one"):
        cli.main(["test", *common, "--checkpoint", latest_checkpoint(resumed),
                  "--init-seed", "0", "--out-dir", results])

    with pytest.raises(SystemExit, match="--extra-root"):
        cli.main(["train", "--experiment", "triptemp_ed", "--data-root", data,
                  "--image-size", "64", "--dtype", "float32", "--device", "cpu",
                  "--out-dir", str(tmp_path / "refused")])
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["train", "--data-root", data, "--out-dir", str(tmp_path / "refused")])


def _family_journey(tmp_path, experiment, size):
    """``cli train`` of a family with a test split (the sample hook after the
    epoch's step, and the gallery), then its serve command (``test``, or
    ``gen`` for a diffusion experiment) on the checkpoint."""
    data, runs, served = (str(tmp_path / d) for d in ("data", "runs", "served"))
    _write_pairs(data, "train", 2, size, seed=5)
    _write_pairs(data, "test", 2, size, seed=6)
    common = ["--experiment", experiment, "--data-root", data, "--image-size", str(size),
              "--batch-size", "2", "--dtype", "float32", "--device", "cpu"]
    cli.main(["train", *common, "--n-epochs", "1", "--checkpoint-interval", "1",
              "--sample-interval", "1", "--out-dir", runs])
    assert latest_checkpoint(runs) == os.path.join(runs, "step_00000002")
    with open(os.path.join(runs, "logs", f"{experiment}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss_G"]) for r in rows)
    assert sorted(os.listdir(os.path.join(runs, "samples"))) == [
        "0000002.png", "index.html"]  # step 0's fit samples nothing

    serve = "gen" if experiment.startswith("tfc_diff") else "test"
    cli.main([serve, *common, "--checkpoint", latest_checkpoint(runs), "--out-dir", served])
    assert len(glob.glob(os.path.join(served, "*.png"))) == 2


@pytest.mark.slow
@pytest.mark.parametrize("experiment,size", [("stn_newmodel3", 64), ("nemar", 128)])
def test_train_journey_of_the_other_families(tmp_path, experiment, size):
    _family_journey(tmp_path, experiment, size)


def test_tfc_diff_train_sample_and_gen_journey(tmp_path, monkeypatch):
    """tfc_diff at 32² on a 4-step chain: the hook samples the whole chain."""
    from tfcgan_tpu_torch import config

    registry = config.get_experiment
    monkeypatch.setattr(config, "get_experiment", lambda name: (
        lambda cfg: cfg.replace(extra={**cfg.extra, "timesteps": 4}))(registry(name)))
    _family_journey(tmp_path, "tfc_diff", 32)
