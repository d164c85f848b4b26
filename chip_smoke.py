#!/usr/bin/env python3
"""Drive the PyTorch port's fft_glo serve path and train step on one CUDA card.

    python3 chip_smoke.py [--params g_params.npz] [--init-seed 0]

Phases, one line or more each; any failure raises and exits non-zero:

1. environment: torch/CUDA versions, the card, its power limit; TF32 off.
2. build: nvcc builds ``tfcgan_tpu_torch/csrc/blurpool.cu``, which holds both
   kernels of the path (blur-pool forward and backward); the build seconds.
3. kernel vs plain: the blur-pool forward kernel against ``blur_pool_padded``
   and the backward kernel against ``torch.autograd.grad`` of it, at the 11
   blur shapes of the 256² generator at batch 8 (both strides; the first four
   stride-2 shapes are also the discriminator's), odd shapes and 1-3 pixel
   maps, float32 (atol 1e-5) and bfloat16 (against the plain version in
   float32 from the same bf16 input or output gradient, rounded: atol = rtol
   = 8e-3, one bf16 ulp), with kernel and plain times at the path's shapes.
4. serve: the full-width ``GeneratorUNet`` (random weights from --init-seed,
   or --params) through ``Inferencer`` and ``run_test_set(save_spectra=True)``
   on 4 synthetic batches of 8 at 256² in bfloat16, and ``pair_metrics`` on
   the card.
5. cli: ``python -m tfcgan_tpu_torch.cli`` ``test`` (8 A|B PNG pairs at 256²,
   batch 4, bfloat16, spectra), ``prep-crop`` and ``eval``, in-process on the
   card. The forward kernel's launch count of phases 4 and 5 is 11 per G
   forward.
6. compare: the same G weights in float32 through the kernel and through the
   plain path on the card (atol 1e-4), and G-forward images/s at batch 8, 32
   and 128.
7. train: the full-width fft_glo recipe (G, spectral-norm D, random-weight
   LPIPS-VGG16, every loss term, two Adams) in bfloat16 on the card,
   ``Trainer.fit`` for 3 steps at batch 8, 256², draws from a CUDA
   ``torch.Generator``: finite losses that move, and exactly 27 forward and
   23 backward blur-pool launches per step.
8. train compare: one step's losses and G- and D-phase gradients in float32
   at batch 2, 256², through the kernels and through the plain blur, from one
   set of weights and draws (loss terms rtol 1e-4; every gradient within
   1e-3 x max|g_plain| + 1e-7).
9. train rate: train-step images/s and peak memory at batch 32 and 128
   (bfloat16, 2 warm-up and 5 timed steps, CUDA events), kernel and plain path.
10. the card's ``nvidia-smi`` line, one JSON line per kernel, and last
   ``{"ok": true, "device": {...}}``.

In the kernel JSON, ``launches`` is the count of phase 7 (the train step, the
path this script drives last); ``ms``/``plain_ms`` are sums over the 11
bfloat16 blur calls of one batch-8 G forward (for the backward: of one G
backward); ``max_abs_err`` is the largest error of phase 3.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import load_generator_npz
from tfcgan_tpu_torch.config import get_experiment
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.evaluation.suite import pair_metrics, save_image_grid
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.models import discriminator, layers
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.models.unet import GeneratorUNet
from tfcgan_tpu_torch.ops.blurpool import blur_pool_padded
from tfcgan_tpu_torch.ops.kernels import _build
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.tfcgan import build_generator
from tfcgan_tpu_torch.train.trainer import Trainer

STRIDE2_SHAPES = [(8, 255, 255, 64), (8, 127, 127, 128), (8, 63, 63, 256), (8, 31, 31, 512),
                  (8, 15, 15, 512), (8, 7, 7, 512)]
STRIDE1_SHAPES = [(8, 8, 8, 512), (8, 16, 16, 512), (8, 32, 32, 256), (8, 64, 64, 128),
                  (8, 128, 128, 64)]
EXTRA_SHAPES = [(1, 15, 17, 5), (1, 255, 9, 2), (2, 31, 31, 8),
                (2, 1, 1, 8), (2, 2, 2, 8), (2, 3, 3, 8)]
THROUGHPUT_BATCHES = (8, 32, 128)
TRAIN_RATE_BATCHES = (32, 128)
TRAIN_TERMS = ("g_adv", "g_triplet", "g_temp", "g_lpips", "g_fft", "loss_G", "loss_D")
# blur-pool launches of one default fft_glo step: G 11 + 4 D forwards x 4
# forward; G 11 + D(fake) 4 in the G phase and 4 + 4 in the D phase backward
# (D(real) of the G phase is detached)
FWD_PER_STEP, BWD_PER_STEP = 27, 23


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """got (kernel, its dtype) against want (plain, float32, rounded to got's
    dtype); returns the max abs error."""
    dtype = got.dtype
    got, want = got.float(), want.to(dtype).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 if dtype == torch.float32 else 8e-3 + 8e-3 * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max abs err {float(err.max())}")
    return float(err.max())


def check_blurpool(x: torch.Tensor, stride: int) -> float:
    return _check(kernel.blur_pool_fwd(x, stride), blur_pool_padded(x.float(), stride),
                  f"blurpool fwd {x.dtype} s{stride} {tuple(x.shape)}")


def _plain_grad(dy: torch.Tensor, h: int, w: int, stride: int) -> torch.Tensor:
    x = torch.zeros((dy.shape[0], h, w, dy.shape[3]), device=dy.device, requires_grad=True)
    return torch.autograd.grad(blur_pool_padded(x, stride), x, dy.float())[0]


def check_blurpool_bwd(shape, stride: int, dtype, gen) -> float:
    n, h, w, c = shape
    dy = torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                     device=gen.device, generator=gen).to(dtype)
    return _check(kernel.blur_pool_bwd(dy, h, w, stride), _plain_grad(dy, h, w, stride),
                  f"blurpool bwd {dtype} s{stride} {tuple(shape)}")


def in_turns(plain, kern, iters: int = 20) -> tuple[float, float]:
    """(kernel ms, plain ms): plain, kernel, kernel, plain, averaged."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels(device) -> tuple[tuple[float, float, float], tuple[float, float, float]]:
    """Forward and backward kernel vs plain; ((max_err, ms, plain_ms) fwd, bwd)."""
    gen = torch.Generator(device=device).manual_seed(0)
    fwd, bwd = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    path = [(s, 2) for s in STRIDE2_SHAPES] + [(s, 1) for s in STRIDE1_SHAPES]
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        for shape, stride in path:
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            errs = [check_blurpool(x, s) for s in (1, 2)]
            errs_b = [check_blurpool_bwd(shape, s, dtype, gen) for s in (1, 2)]
            fwd[0], bwd[0] = max(fwd[0], *errs), max(bwd[0], *errs_b)
            k, p = in_turns(lambda: blur_pool_padded(x, stride),
                            lambda: kernel.blur_pool_fwd(x, stride))
            n, h, w, c = shape
            dy = torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                             device=device, generator=gen).to(dtype)
            xg = x.detach().requires_grad_()
            y = blur_pool_padded(xg, stride)
            kb, pb = in_turns(lambda: torch.autograd.grad(y, xg, dy, retain_graph=True),
                              lambda: kernel.blur_pool_bwd(dy, h, w, stride))
            if dtype == torch.bfloat16:
                fwd[1], fwd[2], bwd[1], bwd[2] = fwd[1] + k, fwd[2] + p, bwd[1] + kb, bwd[2] + pb
            print(f"kernel blurpool {name} s{stride} {shape}: max_abs_err fwd s1 {errs[0]:.3g} "
                  f"s2 {errs[1]:.3g}, bwd s1 {errs_b[0]:.3g} s2 {errs_b[1]:.3g}; "
                  f"fwd kernel {k:.4f} ms, plain {p:.4f} ms ({p / k:.2f}x); "
                  f"bwd kernel {kb:.4f} ms, plain {pb:.4f} ms ({pb / kb:.2f}x)")
        for shape in EXTRA_SHAPES:
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            errs = [check_blurpool(x, s) for s in (1, 2)]
            errs_b = [check_blurpool_bwd(shape, s, dtype, gen) for s in (1, 2)]
            fwd[0], bwd[0] = max(fwd[0], *errs), max(bwd[0], *errs_b)
            print(f"kernel blurpool {name} {shape}: max_abs_err fwd s1 {errs[0]:.3g} "
                  f"s2 {errs[1]:.3g}, bwd s1 {errs_b[0]:.3g} s2 {errs_b[1]:.3g}")
    print(f"kernel blurpool: all cases within tolerance, max_abs_err fwd {fwd[0]:.3g}, "
          f"bwd {bwd[0]:.3g}; one bf16 B=8 G forward's 11 calls: kernel {fwd[1]:.4f} ms, "
          f"plain {fwd[2]:.4f} ms; their backward: kernel {bwd[1]:.4f} ms, "
          f"plain {bwd[2]:.4f} ms")
    return tuple(fwd), tuple(bwd)


def phase_serve(device, args) -> tuple[GeneratorUNet, list, int]:
    """Inferencer + run_test_set + pair_metrics; returns G, its batches and G forwards."""
    cfg = get_experiment("fft_glo")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    g = build_generator(cfg, device, torch.Generator().manual_seed(args.init_seed))
    if args.params:
        g.load_state_dict(load_generator_npz(args.params))
    inf = Inferencer(cfg, g)
    batches = [synthetic_batch(batch_size=8, image_size=256, seed=i) for i in range(4)]

    t0 = time.perf_counter()
    metrics, forwards = [], 0
    for b in batches:
        fake = inf(b)
        forwards += 1
        if fake.shape != (8, 256, 256, 3) or fake.dtype != torch.bfloat16:
            raise AssertionError(f"G output {tuple(fake.shape)} {fake.dtype}")
        if not bool(torch.isfinite(fake).all()) or float(fake.abs().max()) > 1.0:
            raise AssertionError("G output not finite or outside [-1, 1]")
        metrics.append(pair_metrics(torch.as_tensor(b["B"], device=device), fake))
    with tempfile.TemporaryDirectory() as out:
        written = inf.run_test_set(batches, out, save_spectra=True)
        forwards += len(batches)
        stacks = [f for f in os.listdir(out) if f.endswith(".png")]
        spectra = [f for f in os.listdir(os.path.join(out, "spectra")) if f.endswith(".png")]
    seconds = time.perf_counter() - t0
    if written != 32 or len(stacks) != 32 or len(spectra) != 32:
        raise AssertionError(f"wrote {written} ({len(stacks)} stacks, {len(spectra)} spectra)")
    means = {}
    for k in metrics[0]:
        v = torch.cat([m[k] for m in metrics])
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"metric {k} not finite")
        means[k] = float(v.mean())
    print(f"serve: 4 batches x 8 at 256² bf16 in {seconds:.2f} s: {forwards} G forwards, "
          f"{len(stacks)} stacks, {len(spectra)} spectra; metric means "
          + ", ".join(f"{k} {v:.4f}" for k, v in means.items()))
    return g, batches, forwards


def phase_cli(args) -> int:
    """The user's commands on the card: ``cli test`` over 8 A|B PNG pairs at 256²
    (batch 4, bf16, spectra), then ``prep-crop`` and ``eval``; returns G forwards."""
    pairs = synthetic_batch(batch_size=8, image_size=256, seed=10)
    weights = ["--params", args.params] if args.params else ["--init-seed", str(args.init_seed)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data, out, crops = (os.path.join(tmp, d) for d in ("data", "out", "crops"))
        for i in range(8):
            save_image_grid([pairs["A"][i], pairs["B"][i]],
                            os.path.join(data, "test", f"{i:03d}.png"), axis=1)
        cli.main(["test", "--experiment", "fft_glo", "--data-root", data, "--image-size", "256",
                  "--batch-size", "4", "--dtype", "bfloat16", "--out-dir", out, "--spectra",
                  "--device", "cuda", *weights])
        cli.main(["prep-crop", "--stack-dir", out, "--out-root", crops])
        csv_path = os.path.join(tmp, "metrics.csv")
        cli.main(["eval", "--fake-dir", os.path.join(crops, "fake_B"),
                  "--real-dir", os.path.join(crops, "real_B"), "--out-csv", csv_path,
                  "--device", "cuda"])
        stacks = [f for f in os.listdir(out) if f.endswith(".png")]
        spectra = os.listdir(os.path.join(out, "spectra"))
        with open(csv_path, newline="") as f:
            rows = list(csv.reader(f))
    values = np.array([r[1:] for r in rows[1:]], dtype=np.float64)
    if len(stacks) != 8 or len(spectra) != 8 or values.shape != (8, len(rows[0]) - 1):
        raise AssertionError(f"cli: {len(stacks)} stacks, {len(spectra)} spectra, "
                             f"metrics {values.shape}")
    if not np.isfinite(values).all():
        raise AssertionError("cli eval: metric not finite")
    print(f"cli: test (8 PNG pairs, batch 4, bf16, spectra) + prep-crop + eval on cuda in "
          f"{time.perf_counter() - t0:.2f} s: {len(stacks)} stacks, {len(spectra)} spectra, "
          f"{values.shape[0]} x {values.shape[1]} finite metrics")
    return 2


def phase_compare(device, g: GeneratorUNet, batches: list, card: str) -> None:
    """The same weights in float32, kernel path vs plain path; G-forward img/s."""
    # float32, the same weights: kernel path vs plain path on the card, and vs the CPU
    g32 = GeneratorUNet(dtype=torch.float32, device=device).eval()
    g32.load_state_dict(g.state_dict())
    x = torch.as_tensor(batches[0]["A"][:2], device=device)
    with torch.inference_mode():
        y_kernel = g32(x)
        with mock.patch.object(layers, "blur_pool", blur_pool_padded):
            y_plain = g32(x)
        g32_cpu = GeneratorUNet(dtype=torch.float32).eval()
        g32_cpu.load_state_dict(g32.state_dict())
        y_cpu = g32_cpu(x.cpu())
    err = float((y_kernel - y_plain).abs().max())
    err_cpu = float((y_kernel.cpu() - y_cpu).abs().max())
    if err > 1e-4:
        raise AssertionError(f"fp32 G: kernel path vs plain path max abs err {err}")
    if err_cpu > 2e-3:
        raise AssertionError(f"fp32 G: card vs CPU max abs err {err_cpu}")
    print(f"serve fp32 G (2 x 256²): kernel path vs plain path on the card max abs err "
          f"{err:.3g} (atol 1e-4); card vs CPU {err_cpu:.3g} (atol 2e-3, cuDNN vs CPU convs)")

    gen = torch.Generator(device=device).manual_seed(1)
    for bsz in THROUGHPUT_BATCHES:
        xb = torch.rand((bsz, 256, 256, 3), device=device, generator=gen) * 2 - 1
        with torch.inference_mode():
            def fwd():
                return g(xb)
            with mock.patch.object(layers, "blur_pool", blur_pool_padded):
                p1 = cuda_ms(fwd, 10)
            k1 = cuda_ms(fwd, 10)
            k2 = cuda_ms(fwd, 10)
            with mock.patch.object(layers, "blur_pool", blur_pool_padded):
                p2 = cuda_ms(fwd, 10)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"G forward bf16 B={bsz}: kernel path {k:.3f} ms = {bsz * 1000 / k:.1f} img/s, "
              f"plain path {p:.3f} ms = {bsz * 1000 / p:.1f} img/s [{card}]")


def _fft_glo(dtype: str):
    cfg = get_experiment("fft_glo")
    return cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def _device_batch(batch_size: int, seed: int, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device)
            for k, v in synthetic_batch(batch_size=batch_size, image_size=256, seed=seed).items()}


class _Rows:
    """Trainer logger: each step's metrics with the blur-pool launch counts."""

    def __init__(self):
        self.rows = []

    def write(self, row: dict) -> None:
        self.rows.append({**row, "fwd": kernel.LAUNCHES, "bwd": kernel.BWD_LAUNCHES})


def phase_train(device, args) -> tuple[int, int]:
    """3 bf16 steps of the full-width fft_glo recipe at B=8, 256²; returns the
    blur-pool forward and backward launches of the run."""
    cfg = _fft_glo("bfloat16")
    recipe = build_recipe(cfg, device)
    log = _Rows()
    trainer = Trainer(cfg, recipe, logger=log)
    state = trainer.init_state(args.init_seed)
    batches = [_device_batch(8, 20 + i, device) for i in range(3)]
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer.fit(state, batches, num_steps=3, log_every=1, check_finite=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = kernel.LAUNCHES, kernel.BWD_LAUNCHES
    for i, row in enumerate(log.rows, 1):
        if (row["fwd"], row["bwd"]) != (FWD_PER_STEP * i, BWD_PER_STEP * i):
            raise AssertionError(f"after step {i}: blurpool launches fwd {row['fwd']}, bwd "
                                 f"{row['bwd']}; want {FWD_PER_STEP} and {BWD_PER_STEP} a step")
        print(f"train step {row['step']}: " + ", ".join(f"{k} {row[k]:.5g}" for k in TRAIN_TERMS))
    losses = [row["loss_G"] for row in log.rows]
    if len(log.rows) != 3 or state.step != 3 or len(set(losses)) != 3:
        raise AssertionError(f"train: {len(log.rows)} rows, step {state.step}, loss_G {losses}")
    print(f"train: 3 bf16 fft_glo steps at B=8, 256² in {seconds:.2f} s (first steps include "
          f"set-up), all terms finite, loss_G moves; blurpool launches fwd {fwd} "
          f"({FWD_PER_STEP} a step), bwd {bwd} ({BWD_PER_STEP} a step)")
    return fwd, bwd


def _step_terms_and_grads(recipe, batch, draws) -> tuple[dict, dict]:
    """One step's loss terms and G- and D-phase gradients, no update."""
    for p in [*recipe.G.parameters(), *recipe.D.parameters()]:
        p.grad = None
    recipe.D.requires_grad_(False)
    loss_g, aux, terms = recipe.g_loss(batch, draws)
    loss_g.backward()
    recipe.D.requires_grad_(True)
    loss_d, d_terms = recipe.d_loss(batch, aux)
    loss_d.backward()
    grads = {f"{prefix}.{n}": p.grad.detach().clone()
             for prefix, m in (("G", recipe.G), ("D", recipe.D)) for n, p in m.named_parameters()}
    return {k: float(v.detach()) for k, v in {**terms, **d_terms}.items()}, grads


def phase_train_compare(device, args) -> None:
    """fp32, TF32 off: one step's losses and gradients at B=2, 256², through the
    kernels and through the plain blur, from one set of weights and draws."""
    cfg = _fft_glo("float32")
    recipe = build_recipe(cfg, device)
    recipe.init(torch.Generator().manual_seed(args.init_seed))
    batch = _device_batch(2, 30, device)
    draws = recipe.draw(torch.Generator(device).manual_seed(args.init_seed), batch)
    spectral_power_iteration(recipe.D, order="vu")
    k_terms, k_grads = _step_terms_and_grads(recipe, batch, draws)
    launches = (kernel.LAUNCHES, kernel.BWD_LAUNCHES)
    with mock.patch.object(layers, "blur_pool", blur_pool_padded), \
            mock.patch.object(discriminator, "blur_pool", blur_pool_padded):
        p_terms, p_grads = _step_terms_and_grads(recipe, batch, draws)
    torch.cuda.synchronize()
    if (kernel.LAUNCHES, kernel.BWD_LAUNCHES) != launches:
        raise AssertionError("the plain path launched a blur-pool kernel")
    for k in TRAIN_TERMS:
        if abs(k_terms[k] - p_terms[k]) > 1e-4 * abs(p_terms[k]):
            raise AssertionError(f"train fp32 {k}: kernel path {k_terms[k]}, plain {p_terms[k]}")
    worst, worst_name = 0.0, ""
    for name, g in p_grads.items():
        bound = 1e-3 * float(g.abs().max()) + 1e-7
        ratio = float((k_grads[name] - g).abs().max()) / bound
        if ratio > worst:
            worst, worst_name = ratio, name
    if worst > 1.0:
        raise AssertionError(f"train fp32 gradient {worst_name}: max|diff| is {worst:.3g} x "
                             "(1e-3 max|g_plain| + 1e-7)")
    print(f"train compare fp32 (B=2, 256², TF32 off), kernel path vs plain path: "
          f"{len(TRAIN_TERMS)} loss terms within rtol 1e-4 (max rel "
          f"{max(abs(k_terms[k] - p_terms[k]) / abs(p_terms[k]) for k in TRAIN_TERMS):.3g}); "
          f"{len(p_grads)} gradients within 1e-3 max|g_plain| + 1e-7, worst "
          f"{worst:.3g} of the bound ({worst_name})")


def phase_train_rate(device, args, card: str) -> None:
    """Train-step img/s and peak memory, bf16, kernel path and plain path."""
    cfg = _fft_glo("bfloat16")
    for bsz in TRAIN_RATE_BATCHES:
        recipe = build_recipe(cfg, device)
        trainer = Trainer(cfg, recipe)
        state = trainer.init_state(args.init_seed)
        batch = _device_batch(bsz, 40, device)
        for path in ("kernel", "plain"):
            with contextlib.ExitStack() as stack:
                if path == "plain":
                    for mod in (layers, discriminator):
                        stack.enter_context(mock.patch.object(mod, "blur_pool", blur_pool_padded))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(2):
                    trainer.step(state, batch)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    metrics = trainer.step(state, batch)
                end.record()
                end.synchronize()
            ms = start.elapsed_time(end) / 5
            if not all(bool(torch.isfinite(v)) for v in metrics.values()):
                raise AssertionError(f"train rate B={bsz} {path}: a loss is not finite")
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"train step bf16 B={bsz} {path} path: {ms:.2f} ms = {bsz * 1000 / ms:.1f} "
                  f"img/s, peak memory {peak:.2f} GiB [{card}]")
        del recipe, trainer, state, batch, metrics
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--params", default=None, help="g_params.npz (tools/export_g_params.py)")
    p.add_argument("--init-seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")

    # 1. environment
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; TF32 off")
    print(card)

    # 2. build: one library holds the forward and the backward kernel
    t0 = time.perf_counter()
    lib = _build.load_library("blurpool")
    for symbol in ("tfcgan_blurpool_fwd", "tfcgan_blurpool_bwd"):
        getattr(lib, symbol)
    print(f"build: blurpool.cu (tfcgan_blurpool_fwd, tfcgan_blurpool_bwd) in "
          f"{time.perf_counter() - t0:.2f} s -> {_build.library_path('blurpool')}")

    # 3. kernel vs plain, forward and backward
    fwd, bwd = phase_kernels(device)

    # 4. serve and 5. the CLI: the serve path, with the forward kernel's launches counted
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    g, batches, forwards = phase_serve(device, args)
    forwards += phase_cli(args)
    torch.cuda.synchronize()
    launches = kernel.LAUNCHES
    if launches != 11 * forwards or kernel.BWD_LAUNCHES != 0:
        raise AssertionError(f"blurpool launches {launches} != 11 x {forwards} G forwards "
                             f"(backward {kernel.BWD_LAUNCHES})")
    print(f"serve path: {forwards} G forwards, blurpool launches {launches} (11 per forward)")

    # 6. float32 kernel path vs plain path, and G-forward img/s
    phase_compare(device, g, batches, card)
    del g, batches
    torch.cuda.empty_cache()

    # 7. the train step, with both kernels' launches counted
    fwd_launches, bwd_launches = phase_train(device, args)

    # 8. float32 train step, kernel path vs plain path
    phase_train_compare(device, args)

    # 9. train-step img/s
    phase_train_rate(device, args, card)

    # 10. result
    print(card)
    source = "tfcgan_tpu_torch/csrc/blurpool.cu"
    print(json.dumps({"kernels": [
        {"name": "blurpool_fwd", "route": "cuda", "source": source,
         "replaces": "tfcgan_tpu/ops/pallas_kernels/blurpool.py:158", "launches": fwd_launches,
         "max_abs_err": fwd[0], "ms": fwd[1], "plain_ms": fwd[2]},
        {"name": "blurpool_bwd", "route": "cuda", "source": source,
         "replaces": "tfcgan_tpu/ops/pallas_kernels/blurpool.py:266", "launches": bwd_launches,
         "max_abs_err": bwd[0], "ms": bwd[1], "plain_ms": bwd[2]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
