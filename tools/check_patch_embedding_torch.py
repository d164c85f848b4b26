"""The ViT patch embedding in bfloat16, forward and backward, in two forms: a
conv on the channels-last view of the NHWC pair, and the product of the
flattened patches with the flattened kernel, the form
``tfcgan_tpu_torch.models.vit`` uses. Each against float64
on the same bfloat16 inputs, weights and output gradient: the relative L2
error of the tokens and of the input, weight and bias gradients; on the card
with cuDNN's heuristic choice and its benchmarked one.

    python tools/check_patch_embedding_torch.py [--device cuda|cpu] [--batch 32]
        [--size 256] [--patch 64] [--dim 768]
"""

import argparse
import sys

import torch
import torch.nn.functional as F


def conv_form(x, w, b):
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=w.shape[-1]).permute(0, 2, 3, 1)


def product_form(x, w, b):
    n, h, wd, c = x.shape
    p = w.shape[-1]
    patches = (x.reshape(n, h // p, p, wd // p, p, c).permute(0, 1, 3, 5, 2, 4)
               .reshape(n, h // p, wd // p, c * p * p))
    return F.linear(patches, w.reshape(w.shape[0], -1), b)


def errors(form, x, w, b, g, want) -> list[float]:
    args = [t.bfloat16().requires_grad_() for t in (x, w, b)]
    y = form(*args)
    y.backward(g.bfloat16())
    return [float((a.detach().double() - r).norm() / r.norm())
            for a, r in zip((y, *(t.grad for t in args)), want)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--dim", type=int, default=768)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("check_patch_embedding_torch: no CUDA card")
    gen = torch.Generator(dev).manual_seed(0)
    n, s, p, c, dim = args.batch, args.size, args.patch, 6, args.dim

    def draw(*shape, scale=1.0):  # bfloat16 values, held in float64
        return (torch.randn(shape, device=dev, generator=gen, dtype=torch.float64) * scale
                ).bfloat16().double()

    x = torch.tanh(draw(n, s, s, c)).bfloat16().double()
    w, b = draw(dim, c, p, p, scale=(c * p * p) ** -0.5), draw(dim, scale=0.02)
    g = draw(n, s // p, s // p, dim)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    product_form(*ref).backward(g)
    want = (product_form(x, w, b), *(t.grad for t in ref))
    out = {}
    for bench in ((False, True) if dev.type == "cuda" else (False,)):
        torch.backends.cudnn.benchmark = bench
        for name, form in (("conv", conv_form), ("product", product_form)):
            errs = errors(form, x, w, b, g, want)
            out[f"{name}{'_benchmark' if bench else ''}"] = errs
            print(f"{dev.type} bf16 patch embedding, {name} form"
                  f"{', cuDNN benchmarked' if bench else ''}: B={n} {s}² patch {p} dim {dim}: "
                  f"relative error tokens {errs[0]:.3e}, d input {errs[1]:.3e}, d weight "
                  f"{errs[2]:.3e}, d bias {errs[3]:.3e}")
    return out


if __name__ == "__main__":
    main()
