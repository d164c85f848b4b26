"""The VTF-STN anchor run on the card, port of ``tools/train_stn_anchor_tpu.py``.

Trains ``stn_newmodel3`` (256², batch 32, bf16, the reference config
``TFC-STN/0302_STN21_Devcom_NewModel.sh``) for 1200 steps on misaligned
visible/thermal face pairs with each sample's affine ground truth
(``data/synth.synthetic_registration_batch``), with the fixed msrecon
perceptual anchor: with no LPIPS weights, ``perceptual="auto"`` resolves to
msrecon. The pool is 60 batches (seeds 1-60) staged on the device once; the
evaluation batch has seed 9999.

Every ``eval_every`` steps (and once before training) it records, against
the ground truth B_aligned, SSIM / NCC / MI of B as observed ("before") and
of the warped B ("after"), the L1 of both to the truth, and the mean |t| of
theta's translation. ``ok``: loss_G finite, SSIM and NCC after above
before, and the L1 to the truth after below before.

The record goes to ``tools/artifacts/torch/stn_anchor_run.json`` with the
card's ``nvidia-smi`` name and power limit. ``STN_SIZE``, ``STN_BATCH``,
``STN_STEPS`` and ``STN_POOL`` in the environment override the run's shape.

    python tools/train_stn_anchor_torch.py [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_TOOLS), _TOOLS]

import numpy as np
import torch

from family_journey_torch import OUT_DIR, _eval_mode, _host, card_line
from tfcgan_tpu_torch.data.prefetch import stage_batch

EVAL_SEED = 9999


def gray01(x) -> np.ndarray:
    return np.asarray(np.asarray(x) * 0.5 + 0.5, dtype=np.float32).mean(-1)


def reg_metrics(a: np.ndarray, b_obs: np.ndarray, warped: np.ndarray, b_aligned: np.ndarray
                ) -> dict:
    """Registration against the synthetic ground truth: metric(B_aligned,
    B_observed) before, metric(B_aligned, warped B) after. One modality on
    both sides, so larger SSIM / NCC / MI is better. ``a`` is not read (the
    JAX tool's signature)."""
    from tfcgan_tpu_torch.ops import metrics as M

    gt, gb, gw = (torch.from_numpy(gray01(x)) for x in (b_aligned, b_obs, warped))
    out = {}
    for name, fn in (("ssim", M.ssim), ("ncc", M.ncc), ("mi", M.mutual_information)):
        out[f"{name}_before"] = float(fn(gt, gb).mean())
        out[f"{name}_after"] = float(fn(gt, gw).mean())
    out["l1_truth_before"] = float(np.mean(np.abs(b_obs - b_aligned)))
    out["l1_truth_after"] = float(np.mean(np.abs(np.asarray(warped, np.float32) - b_aligned)))
    return out


def warp_eval(recipe, a: torch.Tensor, b: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(warped B, theta) of the current weights: fake_A1 = G2(B) with no
    dropout, theta = STN(A, fake_A1), B warped by it."""
    with torch.no_grad(), _eval_mode(recipe.G):
        fake_a1 = recipe.G2(b)
        theta = recipe.STN.theta(a, fake_a1)
        warped = recipe.STN(a, fake_a1, b)
    return _host(warped), _host(theta)


def verdict(final: dict) -> bool:
    return bool(math.isfinite(final["loss_G"])
                and final["ssim_after"] > final["ssim_before"]
                and final["ncc_after"] > final["ncc_before"]
                and final["l1_truth_after"] < final["l1_truth_before"])


def run_anchor(device, size: int = 256, batch: int = 32, steps: int = 1200, pool: int = 60,
               eval_every: int = 100, out_path: str | None = None, extra: dict | None = None,
               log=print) -> dict:
    """Train and return the record; with ``out_path`` also write it there.
    ``extra`` updates ``cfg.extra`` (the CPU tests shrink the ViT)."""
    from tfcgan_tpu_torch.config import DataConfig, TrainConfig, get_experiment
    from tfcgan_tpu_torch.data.synth import synthetic_registration_batch
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    cfg = get_experiment("stn_newmodel3")
    cfg = cfg.replace(data=DataConfig(batch_size=batch, image_size=size),
                      train=TrainConfig(compute_dtype="bfloat16"))
    if extra:
        cfg = cfg.replace(extra={**cfg.extra, **extra})
    recipe = build_recipe(cfg, device)
    if recipe.perceptual != "msrecon":
        raise AssertionError(f"the anchor trains with msrecon, got {recipe.perceptual!r}")
    trainer = Trainer(cfg, recipe)
    state = trainer.init_state(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    eval_batch, eval_truth = synthetic_registration_batch(batch, size, seed=EVAL_SEED)
    ea, eb = (torch.from_numpy(eval_batch[k]).to(device) for k in ("A", "B"))
    w0, _ = warp_eval(recipe, ea, eb)
    before = reg_metrics(eval_batch["A"], eval_batch["B"], w0, eval_truth["B_aligned"])
    log("step 0 (untrained STN): " + json.dumps(before))

    t0 = time.perf_counter()
    staged = [stage_batch(synthetic_registration_batch(batch, size, seed=i + 1)[0], device)
              for i in range(pool)]
    sync()
    log(f"pool of {pool} batches on the device in {time.perf_counter() - t0:.1f} s")

    history, eval_s = [], 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        m = trainer.step(state, staged[i % pool])
        if (i + 1) % eval_every == 0:
            sync()
            t_eval = time.perf_counter()
            w, th = warp_eval(recipe, ea, eb)
            rec = {"step": i + 1,
                   **{k: float(m[k]) for k in ("loss_G", "loss_D")},
                   "g_morph": float(m.get("g_morph", math.nan)),
                   "g_lpips": float(m["g_lpips"]),
                   "theta_t_absmean": float(np.abs(th[:, :, 2]).mean()),
                   **reg_metrics(eval_batch["A"], eval_batch["B"], w, eval_truth["B_aligned"])}
            history.append(rec)
            log(json.dumps(rec))
            eval_s += time.perf_counter() - t_eval
    sync()
    elapsed = time.perf_counter() - t0
    ok = verdict(history[-1])
    log(f"{steps} steps in {elapsed:.0f} s ({batch * steps / (elapsed - eval_s):.1f} img/s "
        f"without the evaluations)")
    log("VERDICT: " + ("CONVERGED (registration improved, no collapse)" if ok
                       else "NOT CONVERGED"))
    out = {"what": "stn_newmodel3 anchor run (tools/train_stn_anchor_torch.py)",
           "platform": "gpu" if device.type == "cuda" else "cpu",
           "card": card_line() if device.type == "cuda" else "",
           "config": {"size": size, "batch": batch, "steps": steps, "pool": pool,
                      "compute_dtype": "bfloat16", "perceptual": recipe.perceptual},
           "before": before, "history": history, "elapsed_s": elapsed,
           "ms_per_step": 1e3 * (elapsed - eval_s) / steps, "ok": ok}
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        log(f"wrote {out_path}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "stn_anchor_run.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on the host")
    env = os.environ.get
    run_anchor(device, size=int(env("STN_SIZE", "256")), batch=int(env("STN_BATCH", "32")),
               steps=int(env("STN_STEPS", "1200")), pool=int(env("STN_POOL", "60")),
               out_path=args.out)


if __name__ == "__main__":
    main()
