"""``tools/train_stn_anchor_torch.py`` on the CPU, and the warp it needs.

- ``reg_metrics`` equals the JAX anchor's formula
  (``tools/train_stn_anchor_tpu.py:65-81``, a module-level script, so its
  formula is restated here) through ``tfcgan_tpu.ops.metrics`` on the same
  arrays: SSIM and NCC within 1e-5 (float32 reductions in another order),
  MI within 1e-5, the L1s exactly.
- ``run_anchor`` takes 2 steps at 64², B=2 (a small ViT) with an
  evaluation at each and writes finite metrics and an ``ok`` field.
- A registration batch's B is a non-contiguous array (the torch CPU warp's
  NCHW result seen as NHWC, as in the JAX package), and
  ``warp_affine_separable`` takes it: the result equals the contiguous
  copy's. It used to refuse it (``view`` of a non-contiguous tensor).
- ``data.prefetch.stage_batch``, which places the anchor's pool and a host
  batch of ``Trainer.step`` on the device, gives contiguous float32 images
  and int64 labels of the same values, and drops other keys.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.ops import metrics as M
from tfcgan_tpu_torch.data.prefetch import stage_batch
from tfcgan_tpu_torch.data.synth import synthetic_registration_batch
from tfcgan_tpu_torch.ops.resample import warp_affine_separable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_VIT = dict(vit_depth=2, vit_dim=96, vit_heads=4, vit_mlp=192)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "train_stn_anchor_torch", os.path.join(REPO, "tools", "train_stn_anchor_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


anchor = _tool()


def _jax_reg_metrics(a, b_obs, warped, b_aligned):
    """The JAX anchor's ``reg_metrics``, as written there."""
    def gray01(x):
        return np.asarray(x * 0.5 + 0.5, dtype=np.float32).mean(-1)

    gt, gb, gw = gray01(b_aligned), gray01(b_obs), gray01(np.asarray(warped))
    out = {}
    for name, fn in (("ssim", M.ssim), ("ncc", M.ncc), ("mi", M.mutual_information)):
        out[f"{name}_before"] = float(np.mean(np.asarray(fn(jnp.asarray(gt), jnp.asarray(gb)))))
        out[f"{name}_after"] = float(np.mean(np.asarray(fn(jnp.asarray(gt), jnp.asarray(gw)))))
    out["l1_truth_before"] = float(np.mean(np.abs(b_obs - b_aligned)))
    out["l1_truth_after"] = float(np.mean(np.abs(np.asarray(warped, np.float32) - b_aligned)))
    return out


@pytest.mark.parametrize("seed", [0, 9999])
def test_reg_metrics_match_jax(seed):
    batch, truth = synthetic_registration_batch(3, 64, seed=seed)
    rng = np.random.RandomState(seed)
    # a "registered" B: the truth plus noise, so that every metric moves
    warped = (truth["B_aligned"] + 0.05 * rng.randn(*batch["B"].shape)).astype(np.float32)
    got = anchor.reg_metrics(batch["A"], batch["B"], warped, truth["B_aligned"])
    want = _jax_reg_metrics(batch["A"], batch["B"], warped, truth["B_aligned"])
    assert list(got) == list(want)
    for k in want:
        tol = 0.0 if k.startswith("l1") else 1e-5
        assert got[k] == pytest.approx(want[k], rel=tol, abs=tol), k
    assert got["l1_truth_after"] < got["l1_truth_before"]


def test_two_steps_with_an_evaluation_each(tmp_path):
    out = str(tmp_path / "stn_anchor_run.json")
    rec = anchor.run_anchor("cpu", size=64, batch=2, steps=2, pool=2, eval_every=1,
                            out_path=out, extra=SMALL_VIT, log=lambda msg: None)
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(rec))
    assert isinstance(written["ok"], bool)
    assert written["config"]["perceptual"] == "msrecon"
    assert [row["step"] for row in written["history"]] == [1, 2]
    keys = {"step", "loss_G", "loss_D", "g_morph", "g_lpips", "theta_t_absmean",
            *written["before"]}
    for row in written["history"]:
        assert set(row) == keys
        assert all(math.isfinite(v) for v in row.values()), row
    assert all(math.isfinite(v) for v in written["before"].values())
    assert written["ok"] == anchor.verdict(written["history"][-1])


def test_warp_takes_a_non_contiguous_source():
    batch, truth = synthetic_registration_batch(2, 32, seed=5)
    src = torch.from_numpy(batch["B"])
    assert not src.is_contiguous()
    theta = torch.from_numpy(truth["theta"])
    got = warp_affine_separable(src, theta)
    want = warp_affine_separable(src.contiguous(), theta)
    assert torch.equal(got, want)
    src.requires_grad_(True)
    g, = torch.autograd.grad(warp_affine_separable(src, theta).square().sum(), src)
    assert g.shape == src.shape and bool(torch.isfinite(g).all())


def test_stage_batch_gives_contiguous_images_and_int64_labels():
    batch, _ = synthetic_registration_batch(2, 32, seed=5)
    assert not batch["B"].flags.c_contiguous
    batch = {**batch, "LAB": np.array([1, 3], np.int32), "name": np.zeros(2)}
    got = stage_batch(batch, "cpu")
    assert set(got) == {"A", "B", "T_B", "LAB"}
    for k in ("A", "B", "T_B"):
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        assert np.array_equal(got[k].numpy(), batch[k])
    assert got["LAB"].dtype == torch.int64 and got["LAB"].tolist() == [1, 3]
