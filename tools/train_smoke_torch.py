"""Learning smoke test on the card, port of ``tools/train_smoke_tpu.py``: fit
fft_glo to a deterministic mapping for a few hundred bf16 steps and check
that the generator learns it.

The mapping: A is smooth random 8 x 8 blocks through tanh, B = -roll(A) over
the channels, T_B from B's red channel (24-38 degrees). fft_glo at 128², B=32,
bf16, ``Trainer.init_state(0)``, 300 steps over the batches of seeds 0-49.
The evaluation PSNR of G(A) (no dropout) against B on the batch of seed 999
is reported before and after, and must rise by more than 3 dB. It prints
img/s over the 300 steps beside the card's ``nvidia-smi`` name and power
limit, and checks that every step launches K1's forward and backward 27 and
23 times and every evaluation forward 11 times (the blur-pool kernels of G
and D).

    python tools/train_smoke_torch.py [--steps 300]

``--device cpu`` runs the plain path on the host, for the tests only: no
kernel is launched there, and the rate is not a card's.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

SIZE, B = 128, 32
STEPS = 300
EVAL_SEED = 999
BATCH_SEEDS = 50
MIN_GAIN_DB = 3.0
K1_STEP = {"fwd": 27, "bwd": 23}  # blur-pool launches an fft_glo step
K1_FORWARD = {"fwd": 11, "bwd": 0}  # an evaluation: one G forward


def make_batch(seed: int, size: int = SIZE, batch: int = B) -> dict[str, np.ndarray]:
    r = np.random.RandomState(seed)
    a = r.randn(batch, size // 8, size // 8, 3).astype(np.float32)
    a = np.tanh(a.repeat(8, 1).repeat(8, 2))
    b = -np.roll(a, 1, axis=-1)  # the deterministic target mapping
    red = np.round((b[..., 0] * 0.5 + 0.5) * 255.0)
    t_b = (24.0 + red * 14.0 / 255.0).astype(np.float32)
    return {"A": a, "B": b, "T_B": t_b}


def _k1() -> dict[str, int]:
    from tfcgan_tpu_torch.ops.kernels import blurpool

    return {"fwd": blurpool.LAUNCHES, "bwd": blurpool.BWD_LAUNCHES}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run(device: str = "cuda", steps: int = STEPS, size: int = SIZE, batch: int = B,
        log=print) -> dict:
    """Train and evaluate; returns the PSNRs, the rate and the launch counts."""
    from tfcgan_tpu_torch.config import get_experiment
    from tfcgan_tpu_torch.data.prefetch import stage_batch
    from tfcgan_tpu_torch.ops.metrics import psnr
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        sys.exit("train_smoke_torch: no CUDA card (--device cpu is for the tests)")
    cfg = get_experiment("fft_glo")
    cfg = cfg.replace(data=cfg.data.__class__(batch_size=batch, image_size=size),
                      train=cfg.train.__class__(compute_dtype="bfloat16"))
    recipe = build_recipe(cfg, device)
    trainer = Trainer(cfg, recipe)
    state = trainer.init_state(0)
    batches = [stage_batch(make_batch(s, size, batch), device) for s in range(BATCH_SEEDS)]
    held = make_batch(EVAL_SEED, size, batch)
    held_a = torch.as_tensor(held["A"], device=device)
    real = torch.as_tensor(held["B"] * 0.5 + 0.5) * 255.0
    want_step = K1_STEP if on_card else dict.fromkeys(K1_STEP, 0)
    want_eval = K1_FORWARD if on_card else dict.fromkeys(K1_FORWARD, 0)

    def launches(fn, want, what):
        before = _k1()
        out = fn()
        got = {k: v - before[k] for k, v in _k1().items()}
        if got != want:
            raise AssertionError(f"{what}: K1 launches {got}, want {want}")
        return out

    def report(tag: str) -> float:
        g = recipe.G
        mode = g.training
        g.eval()
        try:
            with torch.no_grad():
                fake = launches(lambda: g(held_a), want_eval, f"evaluation {tag}")
        finally:
            g.train(mode)
        p = float(psnr(real, (fake.float().cpu() * 0.5 + 0.5) * 255.0).mean())
        log(f"{tag}: eval PSNR(fake_B, B) = {p:.2f} dB")
        return p

    p0 = report("step 0")
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        m = launches(lambda: trainer.step(state, batches[i % BATCH_SEEDS]), want_step,
                     f"step {i + 1}")
        if i % 100 == 0:
            log(f"  step {i}: loss_G={float(m['loss_G']):.3f} loss_D={float(m['loss_D']):.3f} "
                f"lpips={float(m['g_lpips']):.4f}")
    float(m["loss_G"])
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    p1 = report(f"step {steps}")
    rate = steps * batch / seconds
    where = f"[{_card()}]" if on_card else "[CPU, the plain path: not a card's rate]"
    log(f"throughput: {rate:.1f} img/s @ {size}^2, B={batch}, bf16, {steps} steps in "
        f"{seconds:.2f} s {where} | PSNR gain: {p1 - p0:+.2f} dB | K1 launches a step "
        f"{want_step}, an evaluation {want_eval}")
    return {"psnr_before": p0, "psnr_after": p1, "img_per_s": rate, "seconds": seconds,
            "k1_step": want_step, "k1_eval": want_eval}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="cuda (default); cpu for the tests")
    args = ap.parse_args(argv)
    out = run(args.device, args.steps)
    if not out["psnr_after"] > out["psnr_before"] + MIN_GAIN_DB:
        raise AssertionError("the generator failed to learn the synthetic mapping: "
                             f"{out['psnr_before']:.2f} -> {out['psnr_after']:.2f} dB")
    print("LEARNING SMOKE: PASS")
    return out


if __name__ == "__main__":
    main()
