"""Time this tree's blur-pool, resampling and grid_sample kernels against another
tree's, in turns on one CUDA card, and the train steps that run them.

    python tools/kernel_turns.py --other DIR [--steps | --k2-only]

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive``, or a copy with a variant of a kernel). Its
``tfcgan_tpu_torch/csrc/blurpool.cu``, ``csrc/resample.cu`` and
``csrc/gridsample.cu`` are built with this tree's nvcc flags and swapped in
for this tree's libraries through the wrappers' ``_fn``; every other line of
code is this tree's. An other tree whose adjoint still takes the edge pre-pass's
scratch (before the pre-pass was folded into the adjoint's launch) gets it
allocated on every call, as its wrapper did. Each measurement runs in the
order other, this, this, other, and prints every reading:

- K1-bwd and K1-fwd: the 11 bfloat16 calls of one batch-8 G pass
  (``chip_smoke.STRIDE2_SHAPES`` and ``STRIDE1_SHAPES``), eager and replayed
  from CUDA graphs (``chip_smoke.graph_ms``: the device alone), and the calls
  of one fft_glo step at batch 128 (``chip_smoke.fft_glo_step_calls``), with
  their byte bounds;
- K2: each kernel over its passes of one cubic warp at (32, 256, 256, 3)
  (near-identity thetas; the forward and the position gradient both passes,
  with a float32 and a bfloat16 image; the adjoint the y-pass, as the stn step
  runs them), eager and replayed from CUDA graphs, with its byte bound, and
  each pass of the two-pass kernels alone on the device;
- K3-fwd in float32 and bfloat16 and K3-bwd in float32 at (32, 256, 256, 6),
  offsets of 0.3 pixel;
- with ``--k2-only`` only the K2 times (to compare variants of resample.cu);
- with ``--steps``: the bf16 stn_newmodel3 serve forward (``Inferencer``) at
  batch 8 and 32, and the bf16 train step of fft_glo at batch 128,
  stn_newmodel3 and nemar at 32 (256²) and tfc_diff at 32 (128²), through
  ``chip_smoke.phase_train_rate``.

Before the times it prints the largest difference between the two trees'
results on the same inputs, float32 and bfloat16: both blur-pool kernels (the
path's 11 shapes and ``chip_smoke.EXTRA_SHAPES``, each at both strides), all
three resampling kernels (the path's passes, ``chip_smoke``'s hard lines and
its edge lines, every mode; the adjoint's elements 0 and l_in - 1 apart from
the rest where the border is clamped, since they take the edge masses) and
the grid_sample forward, and the position gradient's largest error against
the plain version in both trees, x max(1, max|plain|). The last line is one
JSON object with every reading.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tfcgan_tpu_torch.ops.kernels import _build  # noqa: E402
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel  # noqa: E402
from tfcgan_tpu_torch.ops.kernels import gridsample as gkernel  # noqa: E402
from tfcgan_tpu_torch.ops import resample  # noqa: E402
from tfcgan_tpu_torch.ops.kernels import resample as rkernel  # noqa: E402

LIBRARIES = {"blurpool": kernel, "resample": rkernel, "gridsample": gkernel}
ORDER = ("other", "this", "this again", "other again")
TRAIN = (("fft_glo", 128, chip_smoke.SIZE), ("stn_newmodel3", 32, chip_smoke.SIZE),
         ("nemar", 32, chip_smoke.SIZE), ("tfc_diff", 32, chip_smoke.DIFF_SIZE))


def build_other(root: Path) -> dict[str, ctypes.CDLL]:
    """Build the other tree's sources as ``_build`` builds this tree's (one
    nvcc each, started together), into a build directory of their own."""
    with mock.patch.object(_build, "CSRC_DIR", root / "tfcgan_tpu_torch" / "csrc"), \
            mock.patch.object(_build, "BUILD_DIR", _build.BUILD_DIR / "other"):
        _build.build_libraries(list(LIBRARIES))
        return {name: ctypes.CDLL(str(_build.library_path(name))) for name in LIBRARIES}


def adjoint_takes_scratch(root: Path) -> bool:
    """Whether the other tree's ``tfcgan_resample_adjoint`` takes the edge
    pre-pass's scratch before dx."""
    src = (root / "tfcgan_tpu_torch" / "csrc" / "resample.cu").read_text()
    entry = re.search(r'extern "C" int tfcgan_resample_adjoint\(([^)]*)\)', src)
    return entry is not None and "edge" in entry.group(1)


def with_edge_scratch(fn):
    """The C adjoint of such a tree behind this tree's arguments: an (outer, 2,
    inner) float32 scratch (one float without border clamping) allocated on
    the current device and stream for every call."""
    def call(g, p, q, dx, outer, l_in, l_out, inner, channels, cubic, border, stream):
        edge = torch.empty((outer, 2, inner) if border else (1,), dtype=torch.float32,
                           device="cuda")
        return fn(g, p, q, edge.data_ptr(), dx, outer, l_in, l_out, inner, channels, cubic,
                  border, stream)
    return call


def swapper(libs: dict[str, ctypes.CDLL], scratch_adjoint: bool = False):
    """A context manager factory: inside, the wrappers launch the other tree's
    kernels (same C entry points and arguments, but for the adjoint's scratch
    where ``scratch_adjoint``)."""
    def fn_of(name: str, module):
        ours_fn = module._fn  # before any patch: this tree's loader

        def fn(symbol: str):
            ours = ours_fn(symbol)
            theirs = getattr(libs[name], symbol)
            if symbol == "tfcgan_resample_adjoint" and scratch_adjoint:
                theirs.argtypes = [ctypes.c_void_p] + ours.argtypes  # one pointer more
                theirs.restype = ours.restype
                return with_edge_scratch(theirs)
            theirs.argtypes, theirs.restype = ours.argtypes, ours.restype
            return theirs
        return fn

    fns = {name: fn_of(name, module) for name, module in LIBRARIES.items()}

    @contextlib.contextmanager
    def other():
        with contextlib.ExitStack() as stack:
            for name, module in LIBRARIES.items():
                stack.enter_context(mock.patch.object(module, "_fn", fns[name]))
            yield
    return other


def in_turns(other, fn) -> list[float]:
    """fn() -> ms under other, this, this, other."""
    out = []
    for label in ORDER:
        with other() if label.startswith("other") else contextlib.nullcontext():
            out.append(fn())
    return out


def blur_pass(device, gen, dtype=torch.bfloat16) -> list:
    """(shape, stride, x, dy) of the 11 blur calls of one batch-8 G pass."""
    cases = []
    for shapes, stride in ((chip_smoke.STRIDE2_SHAPES, 2), (chip_smoke.STRIDE1_SHAPES, 1)):
        for shape in shapes:
            n, h, w, c = shape
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            dy = torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                             device=device, generator=gen).to(dtype)
            cases.append((shape, stride, x, dy))
    return cases


def largest_difference(other, device, gen) -> dict[str, float]:
    """max |this - other| of each kernel's results on the same inputs."""
    diff = {}

    def pair(fn):
        with other():
            theirs = fn()
        ours = fn()
        torch.cuda.synchronize()
        return ours, theirs

    def both(fn):
        ours, theirs = pair(fn)
        if isinstance(ours, tuple):
            return max(float((a - b).abs().max()) for a, b in zip(ours, theirs))
        return float((ours.float() - theirs.float()).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        # the path's 11 shapes and chip_smoke's odd ones, each at both strides
        shapes = (chip_smoke.STRIDE2_SHAPES + chip_smoke.STRIDE1_SHAPES
                  + chip_smoke.EXTRA_SHAPES + [(2, 33, 31, 12)])
        for name in ("blurpool_fwd", "blurpool_bwd"):
            diff[f"{name} {tag}"] = 0.0
        for s in shapes:
            x = torch.randn(s, device=device, generator=gen).to(dtype)
            for st in (1, 2):
                dy = torch.randn((s[0], kernel.out_len(s[1], st), kernel.out_len(s[2], st), s[3]),
                                 device=device, generator=gen).to(dtype)
                diff[f"blurpool_fwd {tag}"] = max(diff[f"blurpool_fwd {tag}"],
                                                  both(lambda: kernel.blur_pool_fwd(x, st)))
                diff[f"blurpool_bwd {tag}"] = max(
                    diff[f"blurpool_bwd {tag}"],
                    both(lambda: kernel.blur_pool_bwd(dy, s[1], s[2], st)))
        inp, grid, g = k3_inputs(device, gen, dtype)
        diff[f"gridsample_fwd {tag}"] = max(both(lambda: gkernel.gridsample_fwd(inp, grid, p))
                                            for p in gkernel.PADDING_MODES)
        k2 = dict.fromkeys(("resample_fwd", "resample_adjoint interior", "resample_adjoint edge",
                            "resample_gradpos", "resample_gradpos vs plain",
                            "other resample_gradpos vs plain"), 0.0)
        for x, p, q, l_out, mode, border, channels in k2_cases(device, gen, dtype):
            args = (mode, border, channels)
            l_in = x.shape[1]
            g = torch.randn((x.shape[0], l_out, x.shape[2]), device=device, generator=gen)
            k2["resample_fwd"] = max(k2["resample_fwd"], both(
                lambda: rkernel.resample_fwd(x, p, q, l_out, *args)))
            ours, theirs = pair(lambda: rkernel.resample_adjoint(g, p, q, l_in, *args))
            edge = torch.zeros(l_in, dtype=torch.bool, device=device)
            if border:  # the elements that take the edge masses
                edge[0] = edge[-1] = True
            d = (ours - theirs).abs()
            for key, part in (("interior", d[:, ~edge]), ("edge", d[:, edge])):
                if part.numel():
                    key = f"resample_adjoint {key}"
                    k2[key] = max(k2[key], float(part.max()))
            ours, theirs = pair(lambda: rkernel.resample_gradpos(x, g, p, q, *args))
            k2["resample_gradpos"] = max(k2["resample_gradpos"], *(
                float((a - b).abs().max()) for a, b in zip(ours, theirs)))
            xp = x.float().requires_grad_()
            pp, qp = p.clone().requires_grad_(), q.clone().requires_grad_()
            want = resample.resample_axis_plain(xp, pp, qp, l_out, *args)
            wants = torch.autograd.grad(want, (pp, qp), g)
            for key, got in (("resample_gradpos vs plain", ours),
                             ("other resample_gradpos vs plain", theirs)):
                k2[key] = max(k2[key], *(float((a - w).abs().max())
                                         / max(1.0, float(w.abs().max()))
                                         for a, w in zip(got, wants)))
        diff.update({f"{k} {tag}": v for k, v in k2.items()})
    return diff


def k2_cases(device, gen, dtype) -> list:
    """(x, p, q, l_out, mode, border, channels) of the resampling kernels: the
    two passes of a bicubic warp at (32, 256, 256, 3) with near-identity
    thetas, then ``chip_smoke``'s hard lines on small views and its edge lines
    (``_edge_lines``, ``EDGE_LENGTHS``, ``EDGE_CHANNELS``) in every mode."""
    src = torch.rand((32, chip_smoke.SIZE, chip_smoke.SIZE, 3), device=device, generator=gen)
    cases = chip_smoke.record_passes((src * 2 - 1).to(dtype),
                                     chip_smoke._near_identity_theta(32, gen))
    for shape, l_out, channels in (((64, 100, 1), 100, 1), ((16, 40, 6), 57, 3),
                                   ((7, 33, 10), 20, 5), ((2, 31, 93), 40, 3)):
        for mode in rkernel.MODES:
            for border in (True, False):
                x = torch.randn(shape, device=device, generator=gen).to(dtype)
                p, q = chip_smoke._hard_lines(shape[0], shape[2] // channels, shape[1], gen)
                cases.append((x, p, q, l_out, mode, border, channels))
    for channels in chip_smoke.EDGE_CHANNELS:
        for l_in, l_out in chip_smoke.EDGE_LENGTHS:
            for mode in rkernel.MODES:
                for border in (True, False):
                    x = torch.randn((8, l_in, 2 * channels), device=device,
                                    generator=gen).to(dtype)
                    p, q = chip_smoke._edge_lines(8, 2, l_in, l_out, gen)
                    cases.append((x, p, q, l_out, mode, border, channels))
    return cases


def k3_inputs(device, gen, dtype=torch.float32):
    size = chip_smoke.SIZE
    grid = (chip_smoke._identity_grid(32, size, size, device)
            + (torch.rand((32, size, size, 2), device=device, generator=gen) * 2 - 1)
            * (0.6 / size)).contiguous()
    inp = torch.randn((32, size, size, 6), device=device, generator=gen).to(dtype)
    g = torch.randn((32, size, size, 6), device=device, generator=gen).to(dtype)
    return inp, grid, g


def k2_turns(device, gen, other, result: dict, card: str) -> None:
    """Each resampling kernel over its passes of one cubic warp at (32, 256,
    256, 3), float32 and bfloat16 image (the adjoint reads none: float32
    only), eager and on the device alone, in turns; readings into ``result``."""
    src = torch.rand((32, chip_smoke.SIZE, chip_smoke.SIZE, 3), device=device, generator=gen)
    theta = chip_smoke._near_identity_theta(32, gen)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        passes = chip_smoke.record_passes((src * 2 - 1).to(dtype), theta)
        grads = [torch.randn((x.shape[0], l_out, x.shape[2]), device=device, generator=gen)
                 for x, _, _, l_out, *_ in passes]
        for name, used in chip_smoke.WARP_PASSES.items():
            if dtype == torch.bfloat16 and name == "resample_adjoint":
                continue
            n_bytes = n_ops = 0
            for i in used:
                x, p, _, _, mode, *_ = passes[i]
                b, o = chip_smoke._pass_bounds(x, p, grads[i], mode)[name]
                n_bytes, n_ops = n_bytes + b, n_ops + o

            def warp():
                for i in used:
                    x, p, q, *rest = passes[i]
                    chip_smoke._warp_call(name, x, p, q, grads[i], *rest)
            ms = in_turns(other, lambda: chip_smoke.cuda_ms(warp))
            dev = in_turns(other, lambda: chip_smoke.graph_ms(warp))
            bound, by = chip_smoke.bound_ms(n_bytes, n_ops)
            what = "- and ".join("xy"[i] for i in used) + "-pass"
            result[f"{name} {tag} warp (32,256,256,3)"] = {"ms": ms, "graph_ms": dev,
                                                          "bound_ms": bound, "passes": what}
            print(f"{name}: one cubic warp ({what}) at (32, 256, 256, 3), {tag} image, "
                  f"{' / '.join(ORDER)}: " + ", ".join(f"{t:.4f}" for t in ms)
                  + " ms; device alone (CUDA graphs) " + ", ".join(f"{t:.4f}" for t in dev)
                  + f" ms; bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB) [{card}]")
            if len(used) > 1:
                for i in used:  # each pass alone, on the device alone
                    x, p, q, *rest = passes[i]
                    dev = in_turns(other, lambda: chip_smoke.graph_ms(
                        lambda: chip_smoke._warp_call(name, x, p, q, grads[i], *rest)))
                    result[f"{name} {tag} {'xy'[i]}-pass"] = {"graph_ms": dev}
                    print(f"{name}: its {'xy'[i]}-pass {tuple(x.shape)} alone, device alone, "
                          f"{' / '.join(ORDER)}: " + ", ".join(f"{t:.4f}" for t in dev) + " ms")
    torch.cuda.empty_cache()


def stn_serve_turns(device, args, other, bsz: int) -> list[float]:
    """ms of one bf16 stn_newmodel3 serve forward at batch ``bsz``, in turns."""
    cfg = chip_smoke._cfg("stn_newmodel3", "bfloat16")
    nets = chip_smoke.build_generators(cfg, device,
                                       torch.Generator().manual_seed(args.init_seed))
    chip_smoke._random_dtheta_head(nets["STN"], args.init_seed)
    inf = chip_smoke.Inferencer(cfg, nets)
    gen = torch.Generator(device=device).manual_seed(3)
    batch = {k: torch.rand((bsz, chip_smoke.SIZE, chip_smoke.SIZE, 3), device=device,
                           generator=gen) * 2 - 1 for k in ("A", "B")}
    with torch.inference_mode():
        ms = in_turns(other, lambda: chip_smoke.cuda_ms(lambda: inf(batch), 10))
    del nets, inf, batch
    torch.cuda.empty_cache()
    return ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    p.add_argument("--steps", action="store_true", help="also time the train steps")
    p.add_argument("--k2-only", action="store_true",
                   help="time only the resampling kernels (differences are printed for all)")
    p.add_argument("--init-seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_turns: needs a CUDA card")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build_libraries(list(LIBRARIES))
    root = args.other.resolve()
    other = swapper(build_other(root), adjoint_takes_scratch(root))
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"card": card, "order": ORDER}

    result["max_abs_diff"] = largest_difference(other, device, gen)
    for k, v in result["max_abs_diff"].items():
        print(f"this tree vs {args.other}: {k} max abs diff {v:.3g}")

    if not args.k2_only:
        cases = blur_pass(device, gen)
        bytes_ops = [chip_smoke.blur_work(s, st, 2) for s, st, _, _ in cases]
        bound, by = chip_smoke.bound_ms(sum(b for b, _ in bytes_ops),
                                        sum(o for _, o in bytes_ops))
        for name, call in (("blurpool_bwd", lambda s, st, x, dy: kernel.blur_pool_bwd(
                dy, s[1], s[2], st)), ("blurpool_fwd", lambda s, st, x, dy: kernel.blur_pool_fwd(
                    x, st))):
            ms = in_turns(other, lambda: sum(chip_smoke.cuda_ms(lambda: call(*c)) for c in cases))
            dev = in_turns(other,
                           lambda: sum(chip_smoke.graph_ms(lambda: call(*c)) for c in cases))
            result[f"{name} B=8 pass"] = {"ms": ms, "graph_ms": dev, "bound_ms": bound}
            print(f"{name}: the 11 bf16 calls of a B=8 G pass, {' / '.join(ORDER)}: "
                  + ", ".join(f"{t:.4f}" for t in ms) + " ms; device alone (CUDA graphs) "
                  + ", ".join(f"{t:.4f}" for t in dev) + f" ms; bound {bound:.4f} ms ({by}) "
                  f"[{card}]")
        del cases
        torch.cuda.empty_cache()
        readings = in_turns(other, lambda: chip_smoke.time_step_calls(
            device, chip_smoke.STEP_BATCH, gen))
        for name in ("blurpool_bwd", "blurpool_fwd"):
            ms = [r[name]["ms"] for r in readings]
            r = readings[0][name]
            result[f"{name} fft_glo step"] = {"ms": ms, "bound_ms": r["bound_ms"],
                                              "calls": r["calls"], "bytes": r["bytes"]}
            print(f"{name}: the {r['calls']} bf16 calls of an fft_glo step at B="
                  f"{chip_smoke.STEP_BATCH}, {' / '.join(ORDER)}: "
                  + ", ".join(f"{t:.4f}" for t in ms) + f" ms; bound {r['bound_ms']:.4f} ms "
                  f"({r['bytes'] / 1e9:.3f} GB) [{card}]")

        inp, grid, g = k3_inputs(device, gen)
        inp16 = inp.to(torch.bfloat16)
        for name, fn in (("gridsample_fwd fp32", lambda: gkernel.gridsample_fwd(inp, grid)),
                         ("gridsample_fwd bf16", lambda: gkernel.gridsample_fwd(inp16, grid)),
                         ("gridsample_bwd fp32", lambda: gkernel.gridsample_bwd(g, inp, grid))):
            ms = in_turns(other, lambda: chip_smoke.cuda_ms(fn))
            result[f"{name} (32,256,256,6)"] = {"ms": ms}
            print(f"{name} at (32, 256, 256, 6), offsets 0.3 px, {' / '.join(ORDER)}: "
                  + ", ".join(f"{t:.4f}" for t in ms) + f" ms [{card}]")
        del inp, inp16, grid, g
        torch.cuda.empty_cache()

    k2_turns(device, gen, other, result, card)

    if args.steps and not args.k2_only:
        for bsz in (8, 32):
            ms = stn_serve_turns(device, args, other, bsz)
            result[f"stn_newmodel3 serve B={bsz}"] = {"ms": ms}
            print(f"stn_newmodel3 serve forward bf16 B={bsz} (Inferencer: 3 G forwards, ViT-Base, "
                  f"warp), {' / '.join(ORDER)}: " + ", ".join(f"{t:.3f}" for t in ms)
                  + f" ms [{card}]")
        paths = {label: other if label.startswith("other") else contextlib.nullcontext
                 for label in ORDER}
        for name, bsz, size in TRAIN:
            got = chip_smoke.phase_train_rate(device, args, card, name, (bsz,), paths, size)
            result[f"{name} step B={bsz} {size}²"] = {"ms": [got[bsz, k] for k in ORDER]}
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
