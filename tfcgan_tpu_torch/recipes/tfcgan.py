"""The TFC-GAN recipe, port of ``tfcgan_tpu.recipes.tfcgan`` for the
non-conditional, no-mask, no-region experiments (fft_glo and its siblings).

G loss = adv_w * relativistic BCE + triplet_w * patch triplet (random
whole-patch negatives) + temp_w * temperature triplet (ColorJitter
negatives, x lambda_t) + lpips_w * perceptual (LPIPS, or the msrecon
pyramid for ``perceptual="msrecon"`` and for "auto" without LPIPS weights) +
fft_w * FFT amp/phase L1; D loss = the relativistic pair. D forward order as
the reference: D(fake), D(real) in the G phase; D(real), D(fake.detach()) in the D phase. Spectral norm
advances once per step in the trainer, or, with
``extra["spectral_cadence"] = "per_forward"``, before each D forward in the
"uv" order of torch's parametrization.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Sequence

import torch

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.discriminator import PatchDiscriminator
from tfcgan_tpu_torch.models.layers import init_normal_, spectral_power_iteration
from tfcgan_tpu_torch.models.lpips import LPIPS, resolve_lpips_weights, resolve_perceptual
from tfcgan_tpu_torch.models.unet import GeneratorUNet
from tfcgan_tpu_torch.ops.color import JITTER_RANGES, color_jitter
from tfcgan_tpu_torch.ops.fftloss import fft_l1_loss
from tfcgan_tpu_torch.ops.gan_losses import relativistic_d_loss, relativistic_g_loss
from tfcgan_tpu_torch.ops.patches import patchify
from tfcgan_tpu_torch.ops.perceptual import multiscale_recon
from tfcgan_tpu_torch.ops.temperature import temperature_lut
from tfcgan_tpu_torch.ops.triplet import triplet_margin_loss


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def build_generator(cfg: ExperimentConfig, device, generator: torch.Generator | None = None
                    ) -> GeneratorUNet:
    """The experiment's G on ``device`` in eval mode, weights normal(0, 0.02)
    drawn from ``generator`` (load a state dict over them for trained weights)."""
    if cfg.recipe != "tfcgan":
        raise NotImplementedError(f"recipe {cfg.recipe!r} is not ported yet")
    if cfg.loss.conditional or cfg.loss.use_mask:
        raise NotImplementedError(
            "the conditional (debiased) and saliency-mask generators are not ported yet")
    g = GeneratorUNet(in_channels=cfg.data.channels, out_channels=cfg.data.channels,
                      dtype=_dtype(cfg), device=device, generator=generator)
    return g.eval()


@dataclasses.dataclass
class StepDraws:
    """Every random draw of one fft_glo train step."""

    patch_neg: torch.Tensor  # (grid²,) int64: the real patch each patch term uses as negative
    jitter_factors: torch.Tensor  # (4,) float32: brightness, contrast, saturation, hue
    jitter_order: Sequence[int]  # a permutation of range(4): the order of the jitter ops
    dropout_masks: dict[str, torch.Tensor] | None  # G's keep-masks; None when deterministic_g


def patch_triplet_loss(fake: torch.Tensor, real: torch.Tensor, neg_idx: torch.Tensor,
                       grid: int) -> torch.Tensor:
    """Mean over the grid² patches of triplet(fake patch, real patch, real
    patch ``neg_idx[p]``) with the norm along W. All patches have one size, so
    one triplet over the stacked patches is that mean."""
    fp, rp = patchify(fake, grid), patchify(real, grid)  # (P, N, h, w, C)
    return triplet_margin_loss(fp, rp, rp[neg_idx], axis=3)


def temperature_triplet_loss(fake: torch.Tensor, real: torch.Tensor, t_real: torch.Tensor,
                             factors: torch.Tensor, order: Sequence[int], lam: float,
                             mode: str) -> torch.Tensor:
    """lam * triplet(T(fake), T_B, T(jitter(real))), norm along W."""
    t_fake = temperature_lut(fake, mode=mode)
    t_neg = temperature_lut(color_jitter(real, factors, order), mode=mode)
    return triplet_margin_loss(t_fake, t_real, t_neg, axis=-1) * lam


def fft_loss(fake: torch.Tensor, real: torch.Tensor, lc) -> torch.Tensor:
    """Global (fft_grid 1) or per-patch FFT amp + phase L1, the patches folded
    into the batch (equal sizes: the mean over P*N is the mean of the
    per-patch means)."""
    if lc.fft_grid > 1:
        fake = patchify(fake, lc.fft_grid).flatten(0, 1)
        real = patchify(real, lc.fft_grid).flatten(0, 1)
    return fft_l1_loss(fake, real, mode=lc.fft_quantize)[0]


class TFCGANRecipe:
    name = "tfcgan"
    supports_per_forward_spectral = True

    def __init__(self, cfg: ExperimentConfig, device, generator: torch.Generator | None = None):
        lc = cfg.loss
        step4 = "is not ported yet (ROADMAP Queue 1, FFT-family breadth)"
        if lc.conditional:
            raise NotImplementedError(f"the conditional (debiased) recipe {step4}")
        if lc.use_mask:
            raise NotImplementedError(f"the saliency-mask recipe {step4}")
        if lc.region_fft != "off":
            raise NotImplementedError(f"the regional FFT loss {step4}")
        if lc.use_temp and lc.temp_mode != "triplet":
            raise NotImplementedError(f"temp_mode {lc.temp_mode!r} {step4}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.per_forward_spectral = cfg.extra.get("spectral_cadence", "per_step") == "per_forward"
        self.deterministic_g = bool(cfg.extra.get("deterministic_g", False))
        dtype = _dtype(cfg)
        channels = cfg.data.channels
        self.G = GeneratorUNet(channels, channels, dtype=dtype, device=device, generator=generator)
        self.G.train(not self.deterministic_g)
        self.D = PatchDiscriminator(2 * channels, dtype=dtype, device=device, generator=generator)
        # the perceptual term: LPIPS, or the fixed msrecon pyramid (no module)
        self.perceptual = resolve_perceptual(lc) if lc.use_lpips else "off"
        if self.perceptual not in ("lpips", "msrecon", "off"):
            raise ValueError(f"unknown perceptual mode {self.perceptual!r}")
        self.lpips = None
        if self.perceptual == "lpips":
            if resolve_lpips_weights(lc):
                raise NotImplementedError(
                    f"converted LPIPS weights were found ({resolve_lpips_weights(lc)}); "
                    "loading them waits for a later PR, and the port does not train on "
                    "random LPIPS weights where the JAX package would load pretrained ones")
            self.lpips = LPIPS(dtype=dtype, device=device, generator=generator)

    def init(self, generator: torch.Generator) -> None:
        """Draw G, D (with spectral u/v) and LPIPS weights from ``generator``."""
        init_normal_(self.G, generator)
        self.D.reset_parameters(generator)
        if self.lpips is not None:
            self.lpips.reset_parameters(generator)

    def draw(self, generator: torch.Generator, batch: dict) -> StepDraws:
        """One step's draws on ``generator``'s device, with the JAX ranges."""
        dev = generator.device
        p = self.cfg.loss.patch_grid ** 2
        neg = torch.randint(0, max(p, 1), (p,), generator=generator, device=dev)
        lo, hi = (torch.tensor(r, device=dev) for r in zip(*JITTER_RANGES))
        factors = lo + torch.rand(4, generator=generator, device=dev) * (hi - lo)
        order = torch.randperm(4, generator=generator, device=dev).tolist()
        masks = None
        if not self.deterministic_g:
            n, h, w = batch["A"].shape[:3]
            masks = self.G.draw_dropout_masks(n, h, w, generator)
        return StepDraws(neg, factors, order, masks)

    # -------------------------------------------------------------- helpers
    def _single_pass_d(self) -> bool:
        """``TFCGAN_SINGLE_PASS_D=1``: D(fake) and D(real) of a phase as one
        forward on the concatenated batch (D couples no samples, so the values
        are the same). Never with the per-forward cadence, where u/v advance
        between the two forwards."""
        if self.per_forward_spectral:
            return False
        return os.environ.get("TFCGAN_SINGLE_PASS_D", "0") not in ("0", "false")

    def _disc_pair(self, first: torch.Tensor, second: torch.Tensor, cond: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        if self._single_pass_d():
            both = self.D(torch.cat([first, second.to(first.dtype)]), torch.cat([cond, cond]))
            return both[:first.shape[0]], both[first.shape[0]:]
        return self._disc(first, cond), self._disc(second, cond)

    def _disc(self, img: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        if self.per_forward_spectral:
            spectral_power_iteration(self.D, order="uv")
        return self.D(img, cond)

    # --------------------------------------------------------------- losses
    def g_loss(self, batch: dict, draws: StepDraws) -> tuple[torch.Tensor, dict, dict]:
        lc = self.cfg.loss
        a, b = batch["A"], batch["B"]
        fake = self.G(a, draws.dropout_masks)
        pred_fake, pred_real = self._disc_pair(fake, b, a)
        adv = relativistic_g_loss(pred_fake, pred_real, lc.label_smooth)
        metrics = {"g_adv": adv}
        total = lc.adv_weight * adv
        if lc.patch_grid > 0:
            metrics["g_triplet"] = patch_triplet_loss(fake, b, draws.patch_neg, lc.patch_grid)
            total = total + lc.triplet_weight * metrics["g_triplet"]
        if lc.use_temp:
            metrics["g_temp"] = temperature_triplet_loss(
                fake, b, batch["T_B"], draws.jitter_factors, draws.jitter_order,
                lc.temp_lambda, lc.temp_quantize)
            total = total + lc.temp_weight * metrics["g_temp"]
        if self.lpips is not None:
            metrics["g_lpips"] = self.lpips(fake, b).mean()
            total = total + lc.lpips_weight * metrics["g_lpips"]
        elif self.perceptual == "msrecon":
            metrics["g_lpips"] = multiscale_recon(fake, b)
            total = total + lc.lpips_weight * metrics["g_lpips"]
        if lc.fft_mode != "off":
            metrics["g_fft"] = fft_loss(fake, b, lc)
            total = total + lc.fft_weight * metrics["g_fft"]
        metrics["loss_G"] = total
        return total, {"fake_b": fake.detach()}, metrics

    def d_loss(self, batch: dict, aux: dict) -> tuple[torch.Tensor, dict]:
        lc = self.cfg.loss
        a, b = batch["A"], batch["B"]
        pred_real, pred_fake = self._disc_pair(b, aux["fake_b"], a)
        loss = relativistic_d_loss(pred_real, pred_fake, lc.label_smooth, lc.d_loss_weight)
        return loss, {"loss_D": loss}
