"""Replicas of the port's data axis on the CPU: two gloo ranks, spawned by
``torch_dist_ranks.spawn``, against one process.

CycleGAN (64², 2 ResNet blocks, global batch 4, the buffers all but two
slots full and the slots forced to collide): 2 steps (the first fills the
last two slots and swaps into full buffers, the second swaps with colliding
slots); the replicas stay
bit for bit equal (parameters' checksums, buffers); against one process
over the same steps, the same slots are written, the buffers (fakes in
[-1, 1]) agree to 5e-2 and the metrics to rel 3e-3 / abs 1e-4, the
lockstep bounds of test_torch_cyclegan_train.py and test_torch_train.py
(float32 summation order, which Adam's first steps turn into +-lr
updates); a world-2 checkpoint after the first step, restored into one
process, repeats the second step to 1e-4 (buffers) and rel 1e-4 (metrics).
"""

import dataclasses

import numpy as np
import pytest

import torch_dist_ranks as ranks
from tfcgan_tpu_torch.config import get_experiment


def _close_metrics(got, want, rel, abs_):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rel, abs=abs_), (k, got[k], want[k])


def _cyclegan_cfg():
    cfg = get_experiment("cyclegan")
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=4, image_size=64),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={**cfg.extra, "resnet_blocks": 2})


def test_cyclegan_replicas_buffers_and_a_world_two_checkpoint(tmp_path):
    cfg = _cyclegan_cfg()
    kw = dict(cfg=cfg, steps=2, prefill=2, save_at=1, tmp=str(tmp_path))
    w2 = ranks.spawn("cyclegan_steps", 2, tmp_path, **kw)
    w1 = ranks.cyclegan_steps(0, 1, **{**kw, "save_at": None})
    for i, (a, b, c) in enumerate(zip(*w2, w1)):
        # the replicas: bit for bit equal parameters and buffers
        assert a["sum"] == b["sum"] and a["metrics"] == b["metrics"]
        for name in ("buf_A", "buf_B"):
            (da, ca), (db, cb), (dc, cc) = a["buffers"][name], b["buffers"][name], c["buffers"][name]
            np.testing.assert_array_equal(da, db)
            assert ca == cb == cc
            # the slots one process writes, with its values
            np.testing.assert_allclose(da, dc, atol=5e-2)
            if i:
                prev2, prev1 = w2[0][i - 1]["buffers"][name][0], w1[i - 1]["buffers"][name][0]
                np.testing.assert_array_equal((da != prev2).any(axis=(1, 2, 3)),
                                              (dc != prev1).any(axis=(1, 2, 3)))
        _close_metrics(a["metrics"], c["metrics"], 3e-3, 1e-4)
    assert w2[0][-1]["buffers"]["buf_A"][1] == 50  # the buffers filled and then swapped

    # the world-2 checkpoint after step 1, restored into one process: step 2
    resumed = ranks.cyclegan_steps(0, 1, cfg=cfg, steps=1, resume=str(tmp_path / "ckpt_2" /
                                                                     "step_00000001"))
    _close_metrics(resumed[0]["metrics"], w2[0][1]["metrics"], 1e-4, 1e-6)
    for name in ("buf_A", "buf_B"):
        np.testing.assert_allclose(resumed[0]["buffers"][name][0], w2[0][1]["buffers"][name][0],
                                   atol=1e-4)
