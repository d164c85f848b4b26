"""The VTF-STN recipe family (joint translation and registration), port of
``tfcgan_tpu.recipes.stn``:

    fake_B   = G1(A)
    fake_A1  = G2(B)
    warped_B = warp(B, STN(A, fake_A1))       ViT localizer, patch 64
    fake_A2  = G2(warped_B)                   not detached: gradients reach the
                                              STN through G2 and the warp
    loss_G = GAN1 + GAN2 + 0.01 * L1(fake_A2, A)
             + perceptual(fake_A2, A) + perceptual(fake_B, B)
             + morph_triplet(warped_B; A, B)
    loss_D = 0.5 * (D1 relativistic(fake_B) + D2 relativistic(fake_A2)),
             each head weighted 0.25

Variants (``extra["variant"]``): "dark_visible" has a single G2 pass
(fake_A = G2(warp(B, STN(A, fake_B)))), a patch-16 ViT, an unweighted
L1(warped_B, fake_B), a global FFT(fake_A, A) term, no morph term and D heads
weighted 1.0; "b2a" is newmodel3 with the morph term replaced by
FFT(fake_A1, A) (the pair direction is swapped at load,
``data.direction="BtoA"``).

G1, G2 and the STN share one Adam and D1, D2 the other: the recipe exposes
them as the containers ``G`` and ``D``. The perceptual term is the fixed
msrecon anchor unless converted LPIPS weights exist (``perceptual="auto"``).

On a spatial mesh (``parallel.spatial``; the step's image rows in
``active_rows()``) all three variants run on row shards: G1, G2, D1, D2 and
LPIPS on this rank's rows, their keep-masks cut to the blocks' rows
(``PER_ROW``); the localizer on the (A, condition) pair gathered once
(``AffineSTN.theta(rows=)``), so theta is the same on every rank; the warp
reads the whole source and writes this rank's rows (``warp_src(rows=)``).
The adversarial, L1 and LPIPS terms are this rank's shares of their whole
means; the terms that read whole images (the morph triplet, the msrecon
pyramid, the FFT terms) take the images gathered once, are computed whole on
every rank and counted once (each rank's share 1 / S, ``replicated_share``),
and so is ``theta_t``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import ClassVar

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.discriminator import PatchDiscriminator
from tfcgan_tpu_torch.models.layers import init_normal_
from tfcgan_tpu_torch.models.lpips import LPIPS, load_lpips_weights, resolve_perceptual
from tfcgan_tpu_torch.models.stn import AffineSTN, warp_src
from tfcgan_tpu_torch.models.unet import GeneratorUNet
from tfcgan_tpu_torch.ops.fftloss import fft_l1_loss
from tfcgan_tpu_torch.ops.gan_losses import relativistic_d_loss, relativistic_g_loss
from tfcgan_tpu_torch.ops.morphology import morphological_gradient
from tfcgan_tpu_torch.ops.perceptual import multiscale_recon
from tfcgan_tpu_torch.ops.triplet import triplet_margin_loss
from tfcgan_tpu_torch.parallel.spatial import (active_rows, gather_spatial, replicated_share,
                                               share_mean)

VARIANTS = ("newmodel3", "dark_visible", "b2a")


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def _variant(cfg: ExperimentConfig) -> str:
    variant = cfg.extra.get("variant", "newmodel3")
    if variant not in VARIANTS:
        raise ValueError(f"unknown STN variant {variant!r}; known: {VARIANTS}")
    return variant


class _STNNet(AffineSTN):
    """``AffineSTN`` with the config's ViT: patch 64 (flagship) or 16
    (dark_visible), and ``extra["vit_depth"|"vit_dim"|"vit_heads"|"vit_mlp"]``
    (default ViT-Base; the CPU tests shrink them)."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 generator: torch.Generator | None = None):
        e = cfg.extra
        super().__init__(
            cfg.data.image_size, dtype=_dtype(cfg),
            fast_warp=bool(e.get("fast_warp", True)),
            identity_init=bool(e.get("stn_identity_init", True)),
            vit=dict(patch_size=16 if _variant(cfg) == "dark_visible" else 64,
                     depth=int(e.get("vit_depth", 12)), dim=int(e.get("vit_dim", 768)),
                     heads=int(e.get("vit_heads", 12)), mlp_dim=int(e.get("vit_mlp", 3072))),
            device=device, generator=generator)


def build_generators(cfg: ExperimentConfig, device,
                     generator: torch.Generator | None = None) -> nn.ModuleDict:
    """The serve path's modules {"G1", "G2", "STN"} on ``device`` in eval mode,
    weights drawn from ``generator`` (load state dicts over them for trained
    weights)."""
    if cfg.recipe != "stn":
        raise ValueError(f"{cfg.name!r} is not an stn experiment")
    ch = cfg.data.channels
    kw = dict(dtype=_dtype(cfg), device=device, generator=generator)
    return nn.ModuleDict({"G1": GeneratorUNet(ch, ch, **kw), "G2": GeneratorUNet(ch, ch, **kw),
                          "STN": _STNNet(cfg, device, generator)}).eval()


def stn_condition(cfg: ExperimentConfig) -> str:
    """What the localizer sees beside A: "fake_B" (dark_visible) or "fake_A1"."""
    return "fake_B" if _variant(cfg) == "dark_visible" else "fake_A1"


def stn_serve(nets: nn.ModuleDict, condition: str, a: torch.Tensor, b: torch.Tensor
              ) -> dict[str, torch.Tensor]:
    """The eval-mode forward of the family: the four generated images."""
    fake_b = nets["G1"](a)
    fake_a1 = nets["G2"](b)
    warped_b = nets["STN"](a, fake_b if condition == "fake_B" else fake_a1, b)
    return {"fake_B": fake_b, "fake_A1": fake_a1, "warped_B": warped_b,
            "fake_A2": nets["G2"](warped_b)}


def morph_triplet(real_a: torch.Tensor, real_b: torch.Tensor, warped_b: torch.Tensor
                  ) -> torch.Tensor:
    """m(x) = 1 - morphological_gradient(x) with the 3x3 cross;
    triplet(anchor m(warped), positive m(A), negative m(B)), the norm along W."""
    m_a = 1.0 - morphological_gradient(real_a)
    m_b = 1.0 - morphological_gradient(real_b)
    m_w = 1.0 - morphological_gradient(warped_b)
    return triplet_margin_loss(m_w, m_a, m_b, axis=2)


@dataclasses.dataclass
class STNStepDraws:
    """Every random draw of one STN train step: the dropout keep-masks of the
    three generator passes, each None when ``deterministic_g`` (and ``g2_b``
    also for dark_visible, which has no G2(B) pass)."""

    PER_SAMPLE: ClassVar[tuple[str, ...]] = ('g1_a', 'g2_b', 'g2_warped')
    PER_ROW: ClassVar[tuple[str, ...]] = ('g1_a', 'g2_b', 'g2_warped')  # cut to rows too

    g1_a: dict[str, torch.Tensor] | None
    g2_b: dict[str, torch.Tensor] | None
    g2_warped: dict[str, torch.Tensor] | None


class STNRecipe:
    name = "stn"

    def __init__(self, cfg: ExperimentConfig, device, generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.variant = _variant(cfg)
        dv = self.variant == "dark_visible"
        # only the flagship carries the morph triplet; dark_visible's loss_G is
        # adv + recon + perceptual + FFT and b2a swaps morph for an FFT term
        self.use_morph = cfg.extra.get("use_morph", self.variant == "newmodel3")
        self.use_fft = cfg.extra.get("use_fft", self.variant != "newmodel3")
        # dark_visible: the recon term enters unweighted and each D head is
        # (real + fake) with no 0.25
        self.recon_weight = 1.0 if dv else 0.01
        self.d_head_weight = 1.0 if dv else 0.25
        self.stn_condition = stn_condition(cfg)
        self.deterministic_g = bool(cfg.extra.get("deterministic_g", False))
        kw = dict(dtype=_dtype(cfg), device=device, generator=generator)
        self.G = build_generators(cfg, device, generator)
        self.G.train(not self.deterministic_g)
        ch = cfg.data.channels
        self.D = nn.ModuleDict({"D1": PatchDiscriminator(2 * ch, **kw),
                                "D2": PatchDiscriminator(2 * ch, **kw)})
        self.perceptual = resolve_perceptual(cfg.loss)
        if self.perceptual not in ("lpips", "msrecon"):
            raise ValueError(f"unknown perceptual mode {self.perceptual!r}")
        self.lpips = None
        if self.perceptual == "lpips":
            self.lpips = LPIPS(**kw)

    G1 = property(lambda self: self.G["G1"])
    G2 = property(lambda self: self.G["G2"])
    STN = property(lambda self: self.G["STN"])

    def init(self, generator: torch.Generator) -> None:
        """Draw every module's weights (and the spectral u/v) from ``generator``."""
        init_normal_(self.G1, generator)
        init_normal_(self.G2, generator)
        for d in self.D.values():
            d.reset_parameters(generator)
        self.STN.reset_parameters(generator)
        if self.lpips is not None:
            load_lpips_weights(self.lpips, self.cfg.loss, generator)

    def draw(self, generator: torch.Generator, batch: dict) -> STNStepDraws:
        """One step's keep-masks on ``generator``'s device, in the order of the
        forward: G1(A), G2(B), G2(warped_B)."""
        if self.deterministic_g:
            return STNStepDraws(None, None, None)
        n, h, w = batch["A"].shape[:3]
        g1_a = self.G1.draw_dropout_masks(n, h, w, generator)
        g2_b = None
        if self.variant != "dark_visible":
            g2_b = self.G2.draw_dropout_masks(n, h, w, generator)
        return STNStepDraws(g1_a, g2_b, self.G2.draw_dropout_masks(n, h, w, generator))

    # -------------------------------------------------------------- helpers
    @staticmethod
    def _single_pass_d() -> bool:
        """``TFCGAN_SINGLE_PASS_D=1``: a head's two forwards of a phase as one
        on the concatenated batch (D couples no samples, so the values are the
        same). Spectral u/v advance once a step in this family, so the
        cadence never stands in its way."""
        return os.environ.get("TFCGAN_SINGLE_PASS_D", "0") not in ("0", "false")

    def _d_pair(self, name: str, first: torch.Tensor, second: torch.Tensor, cond: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(D(first | cond), D(second | cond)) for head ``name`` (this rank's
        rows of the logits on a spatial mesh)."""
        d, rows = self.D[name], active_rows()
        if self._single_pass_d():
            both = d(torch.cat([first, second.to(first.dtype)]), torch.cat([cond, cond]), rows)
            return both[:first.shape[0]], both[first.shape[0]:]
        return d(first, cond, rows), d(second, cond, rows)

    def _logit_rows(self):
        """The record of D1's and D2's row-sharded logits (None off a spatial
        mesh): the two heads share one geometry."""
        return self.D["D1"].out_rows(active_rows())

    def _forward(self, batch: dict, draws: STNStepDraws):
        a, b = batch["A"], batch["B"]
        rows = active_rows()
        fake_b = self.G1(a, draws.g1_a, rows)
        if self.variant == "dark_visible":
            # a single G2 pass: there is no fake_A1 = G2(B) leg
            fake_a1, cond = None, fake_b
        else:
            fake_a1 = cond = self.G2(b, draws.g2_b, rows)
        # theta stays visible for the step's metrics: a warp pushed out of
        # frame does not show in the loss curves
        stn = self.STN
        theta = stn.theta(a, cond, rows)
        warped_b = warp_src(b, theta, mode=stn.mode, padding_mode=stn.padding_mode,
                            fast=stn.fast_warp, rows=rows)
        fake_a2 = self.G2(warped_b, draws.g2_warped, rows)
        return fake_b, fake_a1, warped_b, fake_a2, theta

    def _perceptual(self, x: torch.Tensor, y: torch.Tensor, whole) -> torch.Tensor:
        """LPIPS on this rank's rows (its share), or msrecon on the whole
        images ``whole(x)``, ``whole(y)`` (counted once over the group)."""
        rows = active_rows()
        if self.lpips is not None:
            return self.lpips(x, y, rows).mean()
        return replicated_share(multiscale_recon(whole(x), whole(y)), rows)

    # --------------------------------------------------------------- losses
    def g_loss(self, batch: dict, draws: STNStepDraws) -> tuple[torch.Tensor, dict, dict]:
        lc = self.cfg.loss
        a, b = batch["A"], batch["B"]
        fake_b, fake_a1, warped_b, fake_a2, theta = self._forward(batch, draws)
        rows, logit_rows = active_rows(), self._logit_rows()
        gathered = {}

        def whole(x: torch.Tensor) -> torch.Tensor:
            # the whole images, each gathered once over the spatial group
            if id(x) not in gathered:
                gathered[id(x)] = gather_spatial(x, rows)
            return gathered[id(x)]

        p1f, p1r = self._d_pair("D1", fake_b, b, a)
        p2f, p2r = self._d_pair("D2", fake_a2, a, b)
        adv = (relativistic_g_loss(p1f, p1r, lc.label_smooth, logit_rows)
               + relativistic_g_loss(p2f, p2r, lc.label_smooth, logit_rows))
        if self.variant == "dark_visible":
            # the recon term anchors the warp to G1's output, not fake_A to A
            recon = share_mean((warped_b.float() - fake_b.float()).abs(), rows)
        else:
            recon = share_mean((fake_a2.float() - a).abs(), rows)
        perc = self._perceptual(fake_a2, a, whole) + self._perceptual(fake_b, b, whole)
        total = adv + self.recon_weight * recon + perc
        metrics = {"g_adv": adv, "g_recon": recon, "g_lpips": perc}
        if self.use_morph:
            metrics["g_morph"] = replicated_share(
                morph_triplet(whole(a), whole(b), whole(warped_b)), rows)
            total = total + metrics["g_morph"]
        if self.use_fft:
            # dark_visible: FFT(fake_A, A); b2a: FFT(fake_A1, A). Both add the
            # unhalved amp + phase sum: fft_weight 2.0 on fft_l1_loss's
            # 0.5 * (amp + phase), set in the stn_* configs
            src = fake_a2 if self.variant == "dark_visible" else fake_a1
            metrics["g_fft"] = replicated_share(
                fft_l1_loss(whole(src), whole(a), mode=lc.fft_quantize)[0], rows)
            total = total + lc.fft_weight * metrics["g_fft"]
        metrics["loss_G"] = total
        # warp health: mean |translation| in [-1, 1] grid units (> 1: content
        # pushed out of frame, and under border padding no gradient comes back)
        metrics["theta_t"] = replicated_share(theta.detach()[:, :, 2].abs().mean(), rows)
        aux = {"fake_b": fake_b.detach(), "fake_a2": fake_a2.detach(),
               "warped_b": warped_b.detach()}
        return total, aux, metrics

    def d_loss(self, batch: dict, aux: dict) -> tuple[torch.Tensor, dict]:
        lc = self.cfg.loss
        a, b = batch["A"], batch["B"]
        logit_rows = self._logit_rows()
        p1r, p1f = self._d_pair("D1", b, aux["fake_b"], a)
        d1 = relativistic_d_loss(p1r, p1f, lc.label_smooth, self.d_head_weight, logit_rows)
        p2r, p2f = self._d_pair("D2", a, aux["fake_a2"], b)
        d2 = relativistic_d_loss(p2r, p2f, lc.label_smooth, self.d_head_weight, logit_rows)
        loss = 0.5 * (d1 + d2)
        return loss, {"loss_D": loss, "d1": d1, "d2": d2}
