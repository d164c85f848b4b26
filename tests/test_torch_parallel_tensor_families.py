"""The STN, NeMAR and TFC-Diff families on the tensor axis (CPU): one step
of stn_newmodel3, nemar and tfc_diff on two gloo ranks as a (1 data x 2
tensor) mesh, against one process from the same init, batch and
draws: every metric within rel 1e-5 / abs 1e-6 (the bound of
``test_torch_parallel_tensor.py``; the two differ only in the float32 order
of the partial sums over the out-channel slices). Each family's sharded
layers run column-parallel: the ViT localizer's q/k/v, patch embedding and
CLS/positional embeddings (stn), the ResNet generator and the PatchGANs
(nemar), the denoiser's attention and time projections (tfc_diff).
test_torch_parallel_tensor_baselines.py holds the other families.

``Trainer.fit``'s hooks on a (1 x 2) pair, as ``cli train`` runs them
(cyclegan): the sample hook runs on both ranks of rank 0's tensor group
and sees G's whole state (one process's after the same step, within 1e-5
of each tensor's max|x| or 2 x lr, where an Adam step of a near-zero
gradient flips sign), and rank 0's histogram record holds every G and D
tensor whole (its counts sum to one process's tensor sizes).
"""

import dataclasses
import json

import numpy as np
import pytest

import torch_dist_ranks as ranks
from tfcgan_tpu_torch.config import get_experiment

VIT = dict(vit_depth=2, vit_dim=96, vit_heads=4, vit_mlp=192)
FAMILIES = {  # name: (image side, batch, extra)
    "stn_newmodel3": (64, 2, VIT),
    "nemar": (128, 2, {"resnet_blocks": 2}),
    "tfc_diff": (32, 2, {}),
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


def test_stn_nemar_diffusion_on_a_tensor_pair_match_one_process(tmp_path):
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


def test_fit_hooks_gather_the_slices(tmp_path):
    cfg = get_experiment("cyclegan")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=2, image_size=64),
                      train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                      extra={**cfg.extra, "resnet_blocks": 2})
    two = ranks.spawn("fit_with_hooks", 2, tmp_path, cfg=cfg, tmp=str(tmp_path), tensor=2)
    one = ranks.fit_with_hooks(0, 1, cfg=cfg, tmp=str(tmp_path))
    assert len(two[0]) == len(two[1]) == len(one) == 1
    assert sorted(two[0][0]) == sorted(one[0])
    for k, want in one[0].items():  # G after one step; an Adam step of a near-zero
        got = two[0][0][k]          # gradient may flip sign: 2 x lr
        np.testing.assert_array_equal(got, two[1][0][k])
        assert got.shape == want.shape, k
        bound = max(1e-5 * float(np.abs(want).max()), 2 * cfg.optim.lr + 1e-7)
        assert float(np.abs(got - want).max()) <= bound, k
    records = {}
    for world in (1, 2):
        with open(tmp_path / f"hists_{world}.jsonl") as f:
            records[world] = [json.loads(line) for line in f]
    assert [r["kind"] for r in records[2]] == [r["kind"] for r in records[1]] == ["weights", "grads"]
    for got, want in zip(records[2], records[1]):
        assert sorted(got["leaves"]) == sorted(want["leaves"])
        for k, h in want["leaves"].items():
            assert sum(got["leaves"][k]["counts"]) == sum(h["counts"]), k
