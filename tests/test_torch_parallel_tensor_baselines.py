"""ThermalGAN, CycleGAN and the debiased chain on the tensor axis (CPU): one
step of thermalgan_bn, cyclegan and V7 (``fft_patch_debiased``) on two gloo
ranks as a (1 data x 2 tensor) mesh, against one process from the same init, batch and
draws: every metric within rel 1e-5 / abs 1e-6 (the bound of
``test_torch_parallel_tensor.py``; the two differ only in the float32 order
of the partial sums over the out-channel slices). Each family's sharded
layers run column-parallel: ``TrainBatchNorm`` over the data group behind
sharded convs and transposed convs (thermalgan_bn), the ResNet generators
and PatchGANs, whose replay buffers take each sample once (cyclegan), and
the regional-KL softmax's gather with the regional ResNet-18s sharded too
(V7). test_torch_parallel_tensor_families.py holds the other families.
"""

import dataclasses

import pytest

import torch_dist_ranks as ranks
from tfcgan_tpu_torch.config import get_experiment

FAMILIES = {  # name: (image side, batch, extra)
    "thermalgan_bn": (256, 2, {}),
    "cyclegan": (64, 2, {"resnet_blocks": 2}),
    "fft_patch_debiased": (128, 2, {}),
}


def _cfgs():
    out = {}
    for name, (size, batch, extra) in FAMILIES.items():
        cfg = get_experiment(name)
        out[name] = cfg.replace(
            data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size),
            train=dataclasses.replace(cfg.train, compute_dtype="float32"),
            extra={**cfg.extra, **extra})
    return out


def test_baselines_and_debiased_on_a_tensor_pair_match_one_process(tmp_path):
    cfgs = _cfgs()
    two = ranks.spawn("family_steps", 2, tmp_path, cfgs=cfgs, tensor=2)
    one = ranks.family_steps(0, 1, cfgs=cfgs)
    for name in cfgs:
        assert two[0][name]["metrics"] == two[1][name]["metrics"], name
        assert two[0][name]["sharded"] > 0 and one[name]["sharded"] == 0, name
        got, want = two[0][name]["metrics"], one[name]["metrics"]
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), (name, k, got[k], want[k])

