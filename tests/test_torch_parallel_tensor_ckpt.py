"""Checkpoints across the tensor axis (CPU, gloo ranks): the port's form of
``tests/test_train.py::TestTensorMesh::test_restore_dp_checkpoint_onto_tensor_mesh``.

fft_glo at 64², global batch 8, float32, the port's init from seed 1:

- two data ranks take steps 1-3 on batches 0-2 and save after steps 1 and 2;
- four ranks as (2 data x 2 tensor) restore the data-mesh checkpoint of
  step 1 (``place_state`` keeps each rank's slices of the weights and of both
  Adam moments: half of ``G.down1.conv``'s 64 out-channels), save at once,
  take step 2 and save again;
- the tensor mesh's checkpoint of step 1 is the data mesh's key for key, bit
  for bit (the slices gathered before rank 0 writes), and its step-2 metrics
  are the data mesh's continuation (rel 1e-5 / abs 1e-6, the bound of
  ``test_torch_parallel_tensor.py``);
- its checkpoint of step 2 has the data mesh's keys, shapes and dtypes, and
  the weights within the float32 noise of one step apart (1e-5 of each
  tensor's max|x|, or 2 x lr where an Adam update of a near-zero gradient
  flips its sign; the moments of such gradients are noise, so only their
  shapes are held here, their gathering bit for bit at step 1);
- it restores into one process, whose step 3 is the data mesh's (rel 1e-4:
  the states differ by that noise).

The 423 MiB checkpoints are deleted once read.
"""

import shutil

import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_train import _cfg as fftglo_cfg


def _close_metrics(got, want, rel, abs_):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rel, abs=abs_), (k, got[k], want[k])


def _tensors(tree, prefix=""):
    """{path: tensor} of a checkpoint's nested dicts (the generator state too)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _tensors(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _tensors(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _load(path):
    return _tensors(torch.load(path / "state.pt", map_location="cpu", weights_only=True))


def test_data_mesh_checkpoint_onto_the_tensor_mesh_and_back_to_one_process(tmp_path):
    cfg = fftglo_cfg(64, 8)
    w2 = ranks.spawn("fftglo_steps", 2, tmp_path, cfg=cfg, steps=3, save_at=(1, 2),
                     tmp=str(tmp_path))
    data = tmp_path / "ckpt_2"
    w4 = ranks.spawn("fftglo_steps", 4, tmp_path, cfg=cfg, steps=1, batch_seeds=[1],
                     save_at=(1, 2), tmp=str(tmp_path), tensor=2,
                     resume=str(data / "step_00000001"))
    tensor = tmp_path / "ckpt_4"
    for w in w4:  # restored and placed: half the out-channels and half the moments
        assert w["shapes"] == ([(32, 3, 4, 4)] * 3, [(32, 3, 4, 4)] * 3), w["shapes"]
    _close_metrics(w4[0]["metrics"][0], w2[0]["metrics"][1], 1e-5, 1e-6)

    a, b = _load(data / "step_00000001"), _load(tensor / "step_00000001")
    assert sorted(a) == sorted(b)
    for k in a:
        same = torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
        assert same, k
    del a, b
    for d in (data, tensor):
        shutil.rmtree(d / "step_00000001")

    a, b = _load(data / "step_00000002"), _load(tensor / "step_00000002")
    assert sorted(a) == sorted(b)
    lr = cfg.optim.lr
    for k in a:
        if not isinstance(a[k], torch.Tensor):
            assert a[k] == b[k], k
            continue
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if k.startswith(("/G/", "/D/", "/lpips/")):
            # a weight: one Adam update of a near-zero gradient may flip sign
            bound = max(1e-5 * float(a[k].abs().max()), 2 * lr + 1e-7)
            assert float((a[k] - b[k]).abs().max()) <= bound, k
    del a, b
    shutil.rmtree(data)

    w1 = ranks.fftglo_steps(0, 1, cfg=cfg, steps=1, batch_seeds=[2],
                            resume=str(tensor / "step_00000002"))
    shutil.rmtree(tensor)
    _close_metrics(w1["metrics"][0], w2[0]["metrics"][2], 1e-4, 1e-6)
