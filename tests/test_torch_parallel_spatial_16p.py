"""The port's spatial axis on the CPU beyond fft_glo's (2 data x 2 spatial)
step: ``original_16p`` (the contract of
``tests/test_train.py::TestSpatialMesh::test_dp_x_spatial_step``) and the
spatial axis composed with the tensor axis. Four gloo ranks each, spawned
by ``torch_dist_ranks.spawn``, one step at 64², float32, from the port's
init (seed 1), against one process:

- ``original_16p``, global B=4, on (2 data x 2 spatial), with the recipe's
  own draws: G in training mode, so the dropout keep-masks of down3, down4,
  up2 and up3 are drawn for the global batch and cut to each rank's samples
  and rows; the 4 x 4 patch triplet and the temperature triplet read the
  gathered images. ``loss_G`` and ``loss_D`` finite, every metric within
  rel 1e-5 / abs 1e-6 of one process's;
- fft_glo, global B=4, on (1 data x 2 spatial x 2 tensor): each conv fetches
  its halo rows and then computes its out-channel slice.

Every G and D gradient (reduced, and gathered over the tensor group) within
1e-4 of its tensor's max|g| of one process's, from a second pair of runs in
float64 (``test_torch_parallel_spatial.py`` says why: in float32 a leaky
ReLU input within rounding of 0 flips its slope in one run and not the
other).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_train import _cfg as fftglo_cfg
from tfcgan_tpu_torch.config import get_experiment


def _original_16p():
    cfg = get_experiment("original_16p")
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=4, image_size=64),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"))


@pytest.mark.parametrize("case", ["original_16p", "fft_glo_spatial_tensor"])
def test_spatial_steps_match_one_process(tmp_path, case):
    if case == "original_16p":
        cfg, axes = _original_16p(), dict(spatial=2)
    else:
        cfg, axes = fftglo_cfg(64, 4), dict(spatial=2, tensor=2)
    kw = dict(cfg=cfg, steps=1)
    w4 = ranks.spawn("fftglo_steps", 4, tmp_path, **axes, **kw)
    w1 = ranks.fftglo_steps(0, 1, **kw)
    m4, m1 = w4[0]["metrics"][0], w1["metrics"][0]
    assert all(w["metrics"] == w4[0]["metrics"] for w in w4)
    assert np.isfinite(m4["loss_G"]) and np.isfinite(m4["loss_D"])
    assert sorted(m4) == sorted(m1)
    for k in m1:
        assert m4[k] == pytest.approx(m1[k], rel=1e-5, abs=1e-6), (k, m4[k], m1[k])
    kw64 = dict(kw, tmp=str(tmp_path), float64=True)
    ranks.spawn("fftglo_steps", 4, tmp_path, **axes, **kw64)
    ranks.fftglo_steps(0, 1, **kw64)
    for m in "gd":
        got, want = (torch.load(tmp_path / f"{m}_grads_{w}_f64.pt") for w in "41")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == torch.float64, (case, m, k)
            scale = float(want[k].abs().max()) + 1e-12
            np.testing.assert_allclose(got[k].numpy() / scale, want[k].numpy() / scale,
                                       atol=1e-4, err_msg=f"{case} {m} {k}")
    for f in tmp_path.glob("*_grads_*.pt"):
        f.unlink()
