"""Batch augmentations on NHWC tensors, port of ``tfcgan_tpu.data.augment``.

The reference's robustness probes flip test pairs at random and erase a
random rectangle (torchvision's RandomErasing). Every random draw is an
argument, as elsewhere in the port: per-sample flip masks, and for the
erasing five uniform [0, 1) vectors, (apply, area, log-ratio, top, left),
which the JAX function draws from its five keys. The ``draw_*`` helpers make
them from a ``torch.Generator``; tests pass in the JAX draws. The functions
run on the tensors' device.

The rectangle's size is computed in float32 in the JAX order: area = (lo +
u (hi - lo)) h w, aspect = exp(log r0 + u (log r1 - log r0)), eh =
round_half_even(sqrt(area aspect)) clipped to [1, h - 1], and likewise ew
with area / aspect; top = trunc(u (h - eh)). float32 ``exp`` may differ by one
ulp between libraries, which moves eh or ew only where sqrt lands within a
few 1e-8 of a half.
"""

from __future__ import annotations

import torch

ERASE_DRAWS = 5  # uniform vectors of one random_erasing call


def draw_flip(gen: torch.Generator, n: int, p: float = 0.5, device=None) -> torch.Tensor:
    """(n,) bool: which samples flip, each with probability ``p``."""
    return (torch.rand(n, generator=gen) < p).to(device)


def draw_erasing(gen: torch.Generator, n: int, device=None) -> torch.Tensor:
    """(5, n) uniform [0, 1) float32: the draws of one ``random_erasing``."""
    return torch.rand((ERASE_DRAWS, n), generator=gen).to(device)


def random_hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the samples where ``flip`` (N,) is true along W. x: (N, H, W, C)."""
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def random_vflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the samples where ``flip`` (N,) is true along H. x: (N, H, W, C)."""
    return torch.where(flip[:, None, None, None], x.flip(1), x)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its unit draw u, in float32."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def random_erasing(x: torch.Tensor, draws: torch.Tensor, p: float = 0.5,
                   scale: tuple[float, float] = (0.02, 0.33),
                   ratio: tuple[float, float] = (0.3, 3.3), value: float = 0.0) -> torch.Tensor:
    """torchvision-style RandomErasing: each sample, with probability ``p``,
    gets one rectangle of area in ``scale`` x H x W and aspect in ``ratio``
    (log-uniform) set to ``value``. ``draws``: (5, N) uniform [0, 1)."""
    n, h, w, _ = x.shape
    u = draws.to(device=x.device, dtype=torch.float32)
    apply = u[0] < p
    area = _uniform(u[1], *scale) * (h * w)
    # the JAX bounds are float32 logs of the float32 ratios
    log_lo, log_hi = (float(torch.log(torch.tensor(r, dtype=torch.float32))) for r in ratio)
    aspect = torch.exp(_uniform(u[2], log_lo, log_hi))
    eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, h - 1).to(torch.int32)
    ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, w - 1).to(torch.int32)
    top = (u[3] * (h - eh).float()).to(torch.int32)
    left = (u[4] * (w - ew).float()).to(torch.int32)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    in_rect = ((rows >= top[:, None, None]) & (rows < (top + eh)[:, None, None])
               & (cols >= left[:, None, None]) & (cols < (left + ew)[:, None, None]))
    mask = in_rect & apply[:, None, None]
    return torch.where(mask[..., None], torch.tensor(value, dtype=x.dtype, device=x.device), x)


def draw_test_time_augment(gen: torch.Generator, n: int, device=None) -> dict:
    """The draws of one ``test_time_augment``: {"hflip", "vflip": (n,) bool,
    "erase": (5, n) float32}."""
    return {"hflip": draw_flip(gen, n, device=device), "vflip": draw_flip(gen, n, device=device),
            "erase": draw_erasing(gen, n, device=device)}


def test_time_augment(batch: dict, draws: dict, erase: bool = False) -> dict:
    """The reference's flip (+ erase) test-time augmentation, applied alike to
    A and B (the same flips and rectangles on both sides)."""
    out = dict(batch)
    for name in ("A", "B"):
        x = torch.as_tensor(out[name])
        x = random_vflip(random_hflip(x, draws["hflip"]), draws["vflip"])
        if erase:
            x = random_erasing(x, draws["erase"])
        out[name] = x
    return out
