"""``cli train --spatial 2 --annots`` for the debiased chain on the CPU: two
gloo ranks under ``torchrun`` (one data share, each rank holding rows 0-31
or 32-63 of every image, and the labels whole) against one process.

fft_patch_debiased_v2 (three aux heads, no regional CNNs) at 64², float32,
global batch 2, one epoch of 1 step after step 0 on 2 synthetic A|B PNG
pairs with their labels CSV, once with the pool staging (the labels staged
whole beside the rank's rows of the uint8 images) and once streamed
(``PrefetchLoader``, ``device_prefetch``): both JSONL logs (rank 0 writes)
hold steps 1 and 2, step 1's terms within rel 1e-5 / abs 1e-6 of one
process's and step 2's within the lockstep bounds of
``test_torch_parallel_cli.py`` (rel 3e-3 / abs 1e-4); the summary line names
the mesh. The pair's checkpoint after the epoch resumes in one process, and
its step 3 is held to that of one process resumed from its own checkpoint
within the lockstep bounds. Each checkpoint is deleted once read.
"""

import os
import shutil

from test_torch_cli_train import _write_pairs
from test_torch_debiased_cli import _write_annots
from test_torch_parallel_spatial_cli_baselines import LOCKSTEP, NEAR, _close, _log, _spatial_run
from tfcgan_tpu_torch import cli

NAME = "fft_patch_debiased_v2"


def test_debiased_train_on_a_spatial_pair_resumes_in_one_process(tmp_path):
    data = str(tmp_path / "data")
    _write_pairs(data, "train", 2, 64, seed=9)
    annots = str(tmp_path / "annots.csv")
    _write_annots(annots, [os.path.join("train", f)
                           for f in sorted(os.listdir(os.path.join(data, "train")))])
    train = ["train", "--experiment", NAME, "--data-root", data, "--annots", annots,
             "--image-size", "64", "--batch-size", "2", "--dtype", "float32", "--device", "cpu",
             "--n-epochs", "1", "--sample-interval", "100", "--checkpoint-interval", "1"]
    one = str(tmp_path / "one")
    cli.main([*train, "--out-dir", one])
    w1 = _log(one, NAME)
    assert [r["step"] for r in w1] == [1, 2]
    for staging in ("pool", "stream"):
        two = str(tmp_path / staging)
        extra = ("--num-workers", "1") if staging == "stream" else ()
        _spatial_run([*train, *extra], two)
        w2 = _log(two, NAME)
        assert [r["step"] for r in w2] == [1, 2] and sorted(w2[0]) == sorted(w1[0]), staging
        _close(w2[0], w1[0], NEAR)
        _close(w2[1], w1[1], LOCKSTEP)
    resumed = {}
    for side, ckpt in (("pair", os.path.join(str(tmp_path / "pool"), "step_00000002")),
                       ("one", os.path.join(one, "step_00000002"))):
        out = str(tmp_path / f"resumed_{side}")
        cli.main([*train, "--out-dir", out, "--resume", ckpt])
        resumed[side] = _log(out, NAME)
        shutil.rmtree(os.path.join(out, "step_00000003"))
    assert [r["step"] for r in resumed["pair"]] == [r["step"] for r in resumed["one"]] == [3]
    _close(resumed["pair"][0], resumed["one"][0], LOCKSTEP)
    for out in (one, str(tmp_path / "pool"), str(tmp_path / "stream")):
        shutil.rmtree(os.path.join(out, "step_00000002"))
