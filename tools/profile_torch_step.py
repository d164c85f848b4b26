"""Profile the PyTorch port's train step on one CUDA card: device time by kind.

    python tools/profile_torch_step.py --experiment stn_newmodel3 --batch 32
    python tools/profile_torch_step.py --experiment nemar --batch 32
    python tools/profile_torch_step.py --experiment tfc_diff --batch 32

Runs ``--warmup`` steps, then ``--steps`` steps of the full-width bf16 recipe
at its config's image size (256², 128² for the tfc_diff family) under
``torch.profiler`` (CPU + CUDA activities), and prints the card's
``nvidia-smi`` name and power limit, the device kernel time a step, the share
of the profiled span in which a kernel ran, the time by kind of kernel
(classified by name) and the largest kernels. ``--plain`` profiles the path
with every hand-written kernel replaced by its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
from collections import defaultdict
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# first match wins
KINDS = (
    ("K1-fwd (blur-pool)", ("blurpool_fwd_kernel",)),
    ("K1-bwd (blur-pool)", ("blurpool_bwd_kernel",)),
    ("K2-fwd (resample)", ("resample_fwd_kernel",)),
    ("K2-adjoint (resample)", ("resample_adjoint_kernel", "resample_edge_kernel")),
    ("K2-gradpos (resample)", ("resample_gradpos_kernel",)),
    ("K3-fwd (grid_sample)", ("gridsample_fwd_kernel",)),
    ("K3-bwd (grid_sample)", ("gridsample_bwd_kernel",)),
    ("K4-fwd (flash attention)", ("flashattn_fwd_kernel",)),
    ("K4-bwd dq (flash attention)", ("flashattn_dq_kernel",)),
    ("K4-bwd dk/dv (flash attention)", ("flashattn_dkv_kernel",)),
    ("Adam (foreach)", ("multi_tensor", "adam")),
    ("convolutions (cuDNN)", ("cudnn", "conv", "fprop", "dgrad", "wgrad", "xmma", "implicit")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "nvjet", "cublas", "cutlass")),
    ("max pooling", ("max_pool", "maxpool")),
    ("FFT", ("fft", "regular_", "vector_fft")),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("softmax / layer norm", ("softmax", "layer_norm", "layernorm")),
    ("reductions", ("reduce",)),
    ("copies, cat, fills", ("copy", "cat", "fill", "memcpy", "memset")),
    ("elementwise passes", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, needles in KINDS:
        if any(n in low for n in needles):
            return kind
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--experiment", default="stn_newmodel3")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--plain", action="store_true")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA card")

    from tfcgan_tpu_torch.config import get_experiment
    from tfcgan_tpu_torch.data.synth import synthetic_batch
    from tfcgan_tpu_torch.models import diffusion as diffusion_models
    from tfcgan_tpu_torch.models import discriminator, layers
    from tfcgan_tpu_torch.models import stn as stn_models
    from tfcgan_tpu_torch.ops import flashattn, gridsample, resample
    from tfcgan_tpu_torch.ops.blurpool import blur_pool_padded
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = get_experiment(args.experiment)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    recipe = build_recipe(cfg, "cuda")
    trainer = Trainer(cfg, recipe)
    state = trainer.init_state(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in synthetic_batch(
        batch_size=args.batch, image_size=cfg.data.image_size, seed=40,
        with_labels=cfg.recipe == "diffusion").items()}

    with contextlib.ExitStack() as stack:
        if args.plain:
            for mod in (layers, discriminator):
                stack.enter_context(mock.patch.object(mod, "blur_pool", blur_pool_padded))
            stack.enter_context(mock.patch.object(resample, "resample_axis",
                                                  resample.resample_axis_plain))
            stack.enter_context(mock.patch.object(stn_models, "grid_sample_dense",
                                                  gridsample.grid_sample_dense_plain))
            stack.enter_context(mock.patch.object(diffusion_models, "flash_attention",
                                                  flashattn.flash_attention_plain))
        for _ in range(args.warmup):
            trainer.step(state, batch)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                trainer.step(state, batch)
            torch.cuda.synchronize()

    # device events only, without the optimizer's annotation spans (they cover
    # the Adam kernels a second time)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    if not kernels:
        sys.exit("profile_torch_step: the profiler recorded no device event")
    by_kind, by_name, calls = defaultdict(float), defaultdict(float), defaultdict(int)
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] += us
        by_name[e.name] += us
        calls[e.name] += 1
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0] if len(spans) > 1 else busy
    total = sum(by_kind.values())
    print(f"{card}; torch {torch.__version__}; {args.experiment} train step, bf16, "
          f"B={args.batch}, {cfg.data.image_size}², {'plain' if args.plain else 'kernel'} path, "
          f"{args.steps} steps after {args.warmup} warm-up")
    print(f"device kernel time {total / args.steps / 1e3:.3f} ms a step; device busy "
          f"{100 * busy / span:.1f} % of the profiled span ({span / args.steps / 1e3:.3f} ms a "
          f"step under the profiler)")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * us / total:5.1f} %  {us / args.steps / 1e3:9.3f} ms  {kind}")
    print(f"largest {args.top} kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {us / args.steps / 1e3:9.3f} ms  {calls[name] / args.steps:6.1f} calls  "
              f"[{kind_of(name)}] {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
