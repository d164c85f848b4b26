#!/usr/bin/env python3
"""Drive the PyTorch port's fft_glo serve path once on one CUDA card.

    python3 chip_smoke.py [--params g_params.npz] [--init-seed 0]

Phases, one line or more each; any failure raises and exits non-zero:

1. environment: torch/CUDA versions, the card, its power limit; TF32 off.
2. build: nvcc builds every kernel of the path from ``tfcgan_tpu_torch/csrc``.
3. kernel vs plain: the blur-pool kernel against ``blur_pool_padded`` at the
   11 blur shapes of the 256² generator at batch 8 (both strides), odd shapes
   and 1-3 pixel maps, float32 (atol 1e-5) and bfloat16 (against the plain
   version in float32 from the same bf16 input, rounded: atol = rtol = 8e-3,
   one bf16 ulp), with kernel and plain times at the path's own shapes.
4. serve: the full-width ``GeneratorUNet`` (random weights from --init-seed,
   or --params) through ``Inferencer`` and ``run_test_set(save_spectra=True)``
   on 4 synthetic batches of 8 at 256² in bfloat16, and ``pair_metrics`` on
   the card.
5. cli: ``python -m tfcgan_tpu_torch.cli`` ``test`` (8 A|B PNG pairs at 256²,
   batch 4, bfloat16, spectra), ``prep-crop`` and ``eval``, in-process on the
   card. The blur-pool launch count of phases 4 and 5 is 11 per G forward.
6. compare: the same weights in float32 through the kernel and through the
   plain path on the card (atol 1e-4), and G-forward images/s at batch 8, 32
   and 128.
7. the card's ``nvidia-smi`` line, one JSON line per kernel run, and last
   ``{"ok": true, "device": {...}}``.

The kernel JSON's ``ms``/``plain_ms`` are the sums over the 11 bfloat16 blur
calls of one batch-8 G forward; ``max_abs_err`` is the largest error of phase 3.
"""

from __future__ import annotations

import argparse
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
from tfcgan_tpu_torch.models import layers
from tfcgan_tpu_torch.models.unet import GeneratorUNet
from tfcgan_tpu_torch.ops.blurpool import blur_pool_padded
from tfcgan_tpu_torch.ops.kernels import _build
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel
from tfcgan_tpu_torch.recipes.tfcgan import build_generator

STRIDE2_SHAPES = [(8, 255, 255, 64), (8, 127, 127, 128), (8, 63, 63, 256), (8, 31, 31, 512),
                  (8, 15, 15, 512), (8, 7, 7, 512)]
STRIDE1_SHAPES = [(8, 8, 8, 512), (8, 16, 16, 512), (8, 32, 32, 256), (8, 64, 64, 128),
                  (8, 128, 128, 64)]
EXTRA_SHAPES = [(1, 15, 17, 5), (1, 255, 9, 2), (2, 31, 31, 8),
                (2, 1, 1, 8), (2, 2, 2, 8), (2, 3, 3, 8)]
THROUGHPUT_BATCHES = (8, 32, 128)


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


def check_blurpool(x: torch.Tensor, stride: int) -> float:
    got = kernel.blur_pool_fwd(x, stride).float()
    want = blur_pool_padded(x.float(), stride).to(x.dtype).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 if x.dtype == torch.float32 else 8e-3 + 8e-3 * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"blurpool {x.dtype} s{stride} {tuple(x.shape)}: "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def phase_kernels(device) -> tuple[float, float, float]:
    gen = torch.Generator(device=device).manual_seed(0)
    max_err, ms, plain_ms = 0.0, 0.0, 0.0
    path = [(s, 2) for s in STRIDE2_SHAPES] + [(s, 1) for s in STRIDE1_SHAPES]
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        for shape, path_stride in path:
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            errs = [check_blurpool(x, s) for s in (1, 2)]
            max_err = max(max_err, *errs)
            # plain, kernel, kernel, plain: the two versions in turns
            p1 = cuda_ms(lambda: blur_pool_padded(x, path_stride))
            k1 = cuda_ms(lambda: kernel.blur_pool_fwd(x, path_stride))
            k2 = cuda_ms(lambda: kernel.blur_pool_fwd(x, path_stride))
            p2 = cuda_ms(lambda: blur_pool_padded(x, path_stride))
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            if dtype == torch.bfloat16:
                ms, plain_ms = ms + k, plain_ms + p
            print(f"kernel blurpool {name} s{path_stride} {shape}: max_abs_err s1 {errs[0]:.3g} "
                  f"s2 {errs[1]:.3g}; kernel {k:.4f} ms, plain {p:.4f} ms ({p / k:.2f}x)")
        for shape in EXTRA_SHAPES:
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            errs = [check_blurpool(x, s) for s in (1, 2)]
            max_err = max(max_err, *errs)
            print(f"kernel blurpool {name} {shape}: max_abs_err s1 {errs[0]:.3g} s2 {errs[1]:.3g}")
    print(f"kernel blurpool: all cases within tolerance, max_abs_err {max_err:.3g}; "
          f"one bf16 B=8 G forward's 11 calls: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return max_err, ms, plain_ms


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

    # 2. build
    t0 = time.perf_counter()
    _build.load_library("blurpool")
    print(f"build: blurpool.cu in {time.perf_counter() - t0:.2f} s "
          f"-> {_build.library_path('blurpool')}")

    # 3. kernel vs plain
    max_err, ms, plain_ms = phase_kernels(device)

    # 4. serve and 5. the CLI: the main path, with the kernel's launches counted
    kernel.LAUNCHES = 0
    g, batches, forwards = phase_serve(device, args)
    forwards += phase_cli(args)
    torch.cuda.synchronize()
    launches = kernel.LAUNCHES
    if launches != 11 * forwards:
        raise AssertionError(f"blurpool launches {launches} != 11 x {forwards} G forwards")
    print(f"main path: {forwards} G forwards, blurpool launches {launches} (11 per forward)")

    # 6. float32 kernel path vs plain path, and G-forward img/s
    phase_compare(device, g, batches, card)

    # 7. result
    print(card)
    print(json.dumps({"kernels": [{
        "name": "blurpool_fwd", "route": "cuda", "source": "tfcgan_tpu_torch/csrc/blurpool.cu",
        "replaces": "tfcgan_tpu/ops/pallas_kernels/blurpool.py:158",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
