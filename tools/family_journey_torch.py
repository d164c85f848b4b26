"""A bounded learning journey for one recipe family on the card, port of
``tools/family_journey.py``.

Trains cyclegan, thermalgan, nemar or tfc_diff for a few hundred bf16 steps
(``Trainer.init_state(0)``, then ``Trainer.step``) on synthetic scenes: a
pool of 4 batches (seeds 1-4) staged on the device once, and a held-out
batch (seed 99). At step 1 and every ``interval`` steps it records loss_G,
loss_D and the family's task metric on the held-out batch:

- cyclegan: ``cycle_psnr`` (A -> B -> A and B -> A -> B) and ``fakeB_psnr``;
- thermalgan: ``fakeB_psnr`` and ``fakeB_l1`` of G2(G1(A, T_B)), no dropout;
- nemar (misaligned pairs): ``reg_ncc_gt``, the NCC of R's registered A
  against A warped by the true affine, beside ``reg_ncc_init`` (A itself),
  and ``fakeTRB_psnr`` of T(registered A) against B;
- tfc_diff (labelled batches): ``held_noise_mse``, the noise MSE at fixed
  noise and timesteps, and at the end ``sample_psnr_vs_B`` of the ancestral
  sampler at B=4.

The trajectory goes to ``OUT/<family>_journey.json`` (the JAX tool's keys,
plus the card's ``nvidia-smi`` name and power limit and the steps' ms) and a
sample grid to ``OUT/<family>_journey_sample.png``; OUT defaults to
``tools/artifacts/torch``.

    python tools/family_journey_torch.py --family nemar [--steps N] [--out-dir DIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

_T0 = time.monotonic()
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts", "torch")

FAMILIES = {
    "cyclegan": dict(experiment="cyclegan", size=128, batch=16, steps=600, interval=50),
    "thermalgan": dict(experiment="thermalgan", size=256, batch=8, steps=600, interval=50),
    "nemar": dict(experiment="nemar", size=128, batch=16, steps=600, interval=50),
    "tfc_diff": dict(experiment="tfc_diff", size=128, batch=16, steps=800, interval=50),
}
POOL_SEEDS = (1, 2, 3, 4)
HELD_SEED = 99
TASK_SEED = 7     # the tfc_diff task's fixed noise and timesteps
SAMPLE_SEED = 11  # the tfc_diff sampler's draws
SAMPLE_BATCH = 4


def say(msg: str) -> None:
    print(f"journey [{time.monotonic() - _T0:6.0f}s] {msg}", flush=True)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or "" off one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def _psnr(x, y) -> float:
    mse = float(np.mean((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))  # [-1, 1] range: peak 2


def _ncc(x, y) -> float:
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    y = np.asarray(y, np.float64).reshape(y.shape[0], -1)
    x = x - x.mean(1, keepdims=True)
    y = y - y.mean(1, keepdims=True)
    denom = np.sqrt((x**2).sum(1) * (y**2).sum(1)) + 1e-12
    return float(((x * y).sum(1) / denom).mean())


def _scene_pairs(n: int, size: int, seed: int, misalign: bool = False):
    """Visible/thermal face-scene pairs (aligned unless ``misalign``)."""
    from tfcgan_tpu_torch.data.synth import synthetic_registration_batch

    kw = {} if misalign else {"max_translate": 0.0, "max_rotate": 0.0}
    return synthetic_registration_batch(n, size, seed=seed, **kw)


def _gt_warped_a(batch_a, theta) -> np.ndarray:
    """A warped by the true misalignment theta, as B was made from B_aligned."""
    from tfcgan_tpu_torch.data.synth import warp_affine_host

    return warp_affine_host(batch_a, theta)


@contextlib.contextmanager
def _eval_mode(*modules):
    """The modules in eval mode inside the block (no dropout), their modes after."""
    modes = [m.training for m in modules]
    try:
        for m in modules:
            m.eval()
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


# ------------------------------------------------------ the task metrics
def cyclegan_task(nets, held: dict, held_dev: dict) -> tuple[dict, dict]:
    """``nets``: {"G_AB", "G_BA"}; cycle PSNR and fake-B PSNR on ``held``."""
    with torch.no_grad():
        fb = nets["G_AB"](held_dev["A"])
        fa = nets["G_BA"](held_dev["B"])
        o = {"fake_B": fb, "fake_A": fa, "cyc_A": nets["G_BA"](fb), "cyc_B": nets["G_AB"](fa)}
    o = {k: _host(v) for k, v in o.items()}
    return {"cycle_psnr": 0.5 * (_psnr(o["cyc_A"], held["A"]) + _psnr(o["cyc_B"], held["B"])),
            "fakeB_psnr": _psnr(o["fake_B"], held["B"])}, o


def thermalgan_task(nets, held: dict, held_dev: dict) -> tuple[dict, dict]:
    """``nets``: {"G1", "E", "G2"}; G2(G1(A, normalized T_B)) with no dropout."""
    from tfcgan_tpu_torch.models.thermalgan import normalized_temps

    with torch.no_grad(), _eval_mode(nets["G2"]):
        fs = nets["G1"](held_dev["A"], normalized_temps(held_dev["T_B"]))
        o = {"fake_S": _host(fs), "fake_B": _host(nets["G2"](fs))}
    return {"fakeB_psnr": _psnr(o["fake_B"], held["B"]),
            "fakeB_l1": float(np.mean(np.abs(np.asarray(o["fake_B"], np.float64)
                                             - held["B"])))}, o


def nemar_task(nets, held: dict, held_dev: dict, a_gt: np.ndarray) -> tuple[dict, dict]:
    """``nets``: {"T", "R"}; R's registration of A against the true warp
    ``a_gt`` and T(registered A) against B."""
    from tfcgan_tpu_torch.recipes.nemar import nemar_forward

    with torch.no_grad():
        images, _ = nemar_forward(nets, held_dev["A"], held_dev["B"])
    o = {"reg_A": images["registered_A"], "fake_RT_B": images["fake_RT_B"],
         "fake_TR_B": images["fake_TR_B"], "fake_B": images["fake_B"]}
    o = {k: _host(v) for k, v in o.items()}
    return {"reg_ncc_gt": _ncc(o["reg_A"], a_gt), "reg_ncc_init": _ncc(held["A"], a_gt),
            "fakeTRB_psnr": _psnr(o["fake_TR_B"], held["B"])}, o


def diffusion_task(recipe, held_dev: dict, draws) -> tuple[dict, None]:
    """The noise MSE of the recipe's loss on the held batch at fixed ``draws``."""
    with torch.no_grad():
        _, _, m = recipe.g_loss(held_dev, draws)
    return {"held_noise_mse": float(m["g_noise_mse"])}, None


# ------------------------------------------------------------- the run
def journey_cfg(family: str, size: int | None = None, batch: int | None = None,
                extra: dict | None = None):
    """The family's registry entry at the journey's size and batch, bf16;
    the other data and train fields at their defaults, as the JAX tool has
    them. ``extra`` updates ``cfg.extra`` (the CPU tests cut widths and
    timesteps)."""
    from tfcgan_tpu_torch.config import DataConfig, TrainConfig, get_experiment

    spec = FAMILIES[family]
    cfg = get_experiment(spec["experiment"])
    cfg = cfg.replace(data=DataConfig(batch_size=batch or spec["batch"],
                                      image_size=size or spec["size"]),
                      train=TrainConfig(compute_dtype="bfloat16"))
    if extra:
        cfg = cfg.replace(extra={**cfg.extra, **extra})
    return cfg


def journey_data(family: str, size: int, batch: int) -> tuple[list, dict, dict | None]:
    """(the pool's 4 host batches, the held-out batch, its truth or None)."""
    from tfcgan_tpu_torch.data.synth import synthetic_batch

    if family == "tfc_diff":
        pool = [synthetic_batch(batch, size, seed=s, with_labels=True) for s in POOL_SEEDS]
        return pool, synthetic_batch(batch, size, seed=HELD_SEED, with_labels=True), None
    misalign = family == "nemar"
    pool = [_scene_pairs(batch, size, seed=s, misalign=misalign)[0] for s in POOL_SEEDS]
    held, truth = _scene_pairs(batch, size, seed=HELD_SEED, misalign=misalign)
    return pool, held, truth


def run_journey(family: str, device, steps: int | None = None, size: int | None = None,
                batch: int | None = None, interval: int | None = None,
                out_dir: str | None = None, extra: dict | None = None,
                on_event=None, log=say) -> dict:
    """Train ``family`` and return its record (the JSON's content). With
    ``out_dir`` the JSON and the sample grid are written there (tfc_diff also
    samples); without, the run only trains and evaluates.
    ``on_event(kind, step)`` is called after each step ("step", before any
    evaluation) and after each evaluation ("eval")."""
    from tfcgan_tpu_torch.data.prefetch import stage_batch
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    spec = FAMILIES[family]
    steps = steps or spec["steps"]
    interval = interval or spec["interval"]
    cfg = journey_cfg(family, size, batch, extra)
    size, bs = cfg.data.image_size, cfg.data.batch_size
    device = torch.device(device)
    on_event = on_event or (lambda kind, step: None)
    log(f"{family}: device {device} steps={steps} b{bs}@{size}^2")
    recipe = build_recipe(cfg, device)
    trainer = Trainer(cfg, recipe)

    pool_host, held, truth = journey_data(family, size, bs)
    pool = [stage_batch(b, device) for b in pool_host]
    held_dev = stage_batch(held, device)
    log("data pool staged on the device")
    state = trainer.init_state(0)

    if family == "cyclegan":
        def task():
            return cyclegan_task(recipe.G, held, held_dev)
    elif family == "thermalgan":
        def task():
            return thermalgan_task(recipe.G, held, held_dev)
    elif family == "nemar":
        a_gt = _gt_warped_a(held["A"], truth["theta"])

        def task():
            return nemar_task(recipe.G, held, held_dev, a_gt)
    else:
        gen = torch.Generator(device).manual_seed(TASK_SEED)
        draws = recipe.draw(gen, held_dev)  # drawn once: every evaluation sees them

        def task():
            return diffusion_task(recipe, held_dev, draws)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the steps' time on the host's clock, synchronised after step 1, at each
    # evaluation and at the end; the first step (the kernels' build, cuDNN's
    # choices) and the evaluations are left out of ms_per_step
    history, eval_s, first_s = [], 0.0, 0.0
    t_loop = time.perf_counter()
    for i in range(steps):
        m = trainer.step(state, pool[i % len(pool)])
        on_event("step", i + 1)
        if i == 0:
            sync()
            first_s = time.perf_counter() - t_loop
        if (i + 1) % interval == 0 or i == 0:
            sync()
            t_eval = time.perf_counter()
            lg = float(m["loss_G"])
            ld = float(m.get("loss_D", math.nan))
            tm, _ = task()
            on_event("eval", i + 1)
            row = {"step": i + 1, "loss_G": lg, "loss_D": ld, **tm}
            history.append(row)
            log(" ".join(f"{k}={v:.4f}" for k, v in row.items()))
            if not math.isfinite(lg):
                raise FloatingPointError(f"{family}: loss_G not finite: {row}")
            eval_s += time.perf_counter() - t_eval
    sync()
    seconds = time.perf_counter() - t_loop
    ms_per_step = 1e3 * (seconds - first_s - eval_s) / max(steps - 1, 1)
    rec = {
        "what": f"{family} on-card learning journey (tools/family_journey_torch.py)",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "card": card_line() if device.type == "cuda" else "",
        "config": {"experiment": spec["experiment"], "steps": steps, "batch": bs,
                   "image_size": size, "compute_dtype": "bfloat16",
                   "scene": "procedural visible/thermal face pairs"
                            + (" (misaligned)" if family == "nemar" else "")
                   if family != "tfc_diff" else "smooth random pairs, labelled"},
        "history": history,
        "ms_per_step": ms_per_step,
        "first_step_s": first_s,
        "seconds": seconds,
    }
    if out_dir is None:
        return rec

    from tfcgan_tpu_torch.evaluation.suite import save_image_grid

    os.makedirs(out_dir, exist_ok=True)
    sample_path = os.path.join(out_dir, f"{family}_journey_sample.png")
    if family == "tfc_diff":
        log("sampling (the ancestral chain on the device) ...")
        small = {k: v[:SAMPLE_BATCH] for k, v in held_dev.items()}
        gen = torch.Generator(device).manual_seed(SAMPLE_SEED)
        out = _host(recipe.sample(small, gen))
        out3 = out.repeat(3, -1) if out.shape[-1] == 1 else out
        save_image_grid([held["A"][0], out3[0], held["B"][0]], sample_path)
        rec["sample_psnr_vs_B"] = _psnr(out3, held["B"][:SAMPLE_BATCH])
    else:
        _, o = task()
        keys = {"cyclegan": ["fake_B", "fake_A", "cyc_A"],
                "thermalgan": ["fake_S", "fake_B"],
                "nemar": ["reg_A", "fake_B", "fake_TR_B"]}[family]

        def rgb(x):
            x = np.asarray(x, np.float32)
            return x.repeat(3, -1) if x.shape[-1] == 1 else x

        save_image_grid([held["A"][0]] + [rgb(o[k][0]) for k in keys] + [held["B"][0]],
                        sample_path)
    out_json = os.path.join(out_dir, f"{family}_journey.json")
    with open(out_json, "w") as f:
        json.dump(rec, f, indent=1)
    log(f"wrote {out_json} + {sample_path}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", required=True, choices=sorted(FAMILIES))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on the host")
    run_journey(args.family, device, steps=args.steps, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
