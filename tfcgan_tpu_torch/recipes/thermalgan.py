"""The ThermalGAN two-stage recipe, port of ``tfcgan_tpu.recipes.thermalgan``.

Stage 1 (a cVAE-GAN): fake_S = G1(A, T), with T the temperature map
L2-normalised along H (raw in the batch-norm variant), and

    loss_GE = vae_gan + lambda_kl * KL(mu, logvar) + lambda_pix * L1(fake_S, S)
              + L1(T, T(fake_S))

where (mu, logvar) = E(B), S = ``thermal_mask(B)`` the segmentation
surrogate, KL the closed form in float32 and T(fake_S) the temperature map
of fake_S (``temperature_lut`` in ``cfg.loss.temp_quantize`` mode).
Stage 2 (pix2pix): fake_B = G2(fake_S.detach()); loss_G2 = MSE GAN of
D_pix(fake_B, A) + lambda_pix_pix * L1(fake_B, B); loss_G = loss_GE + loss_G2.
D_pix is trained with 0.5 * (real + fake) MSE.

``extra["d_vae_mode"]`` picks the stage-1 adversary:

- ``"detached"`` (the default of ``thermalgan``): the three-scale
  ``MultiDiscriminator`` scores fake_S with the in-forward L1, but the
  reference severs the graph, so the value adds to loss_GE with no gradient
  and D_vae never trains. Here D_vae lies in ``recipe.frozen`` (in neither
  Adam nor ``recipe.D``, carried by the checkpoint and the bridge) and its
  score is taken under ``torch.no_grad()`` on ``fake_S.detach()``.
- ``"single_mse"`` (the default of ``thermalgan_bn``, whose G1 has the
  eps-0.8 batch norms): ``VAEDiscriminator2`` with MSE, live;
- ``"multi_l1"``: the three-scale D with its gradients.

In the last two D_vae is ``D["D_vae"]`` and ``d_vae = real + fake`` (no 0.5)
joins D's loss. ``G`` holds G1, E and G2, stepped by one Adam: loss_GE
reaches only G1 and E, loss_G2 only G2, so one Adam over the three is the
reference's separate updates. G2's dropout keep-masks are the step's draws
(``ThermalDraws``); ``extra["deterministic_g"]`` runs G2 in eval mode.

On a spatial mesh (``parallel.spatial``; the step's image rows in
``active_rows()``) both entries run on row shards in every ``d_vae_mode``:
G1, E, G2 and the discriminators on this rank's
rows (the temperature plane comes cut with the images, G2's keep-masks cut
to its blocks' rows, ``PER_ROW``), the batch norms' moments over the data
and spatial groups. The L1, latent and GAN terms are this rank's shares of
their means; the KL term, from the Encoder's (mu, logvar), which every rank
computes whole, is counted once over the group (``replicated_share``).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.discriminator import MultiDiscriminator, multiscale_loss
from tfcgan_tpu_torch.models.layers import without_draws
from tfcgan_tpu_torch.models.thermalgan import (DiscriminatorPix, Encoder, GeneratorG1,
                                                GeneratorG2, VAEDiscriminator2,
                                                normalized_temps, thermal_mask)
from tfcgan_tpu_torch.ops.gan_losses import lsgan_loss
from tfcgan_tpu_torch.ops.temperature import temperature_lut
from tfcgan_tpu_torch.parallel.spatial import active_rows, replicated_share, share_mean

D_VAE_MODES = ("detached", "single_mse", "multi_l1")


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def build_generators(cfg: ExperimentConfig, device,
                     generator: torch.Generator | None = None) -> nn.ModuleDict:
    """{"G1", "E", "G2"} on ``device`` in eval mode, weights drawn from
    ``generator`` as the JAX init draws them (load a state dict over them for
    trained weights); the layout of ``recipe.G``."""
    if cfg.recipe != "thermalgan":
        raise ValueError(f"{cfg.name!r} is not a thermalgan experiment")
    ch, dt = cfg.data.channels, _dtype(cfg)
    kw = dict(dtype=dt, device=device, generator=generator)
    norm = "batch" if cfg.extra.get("g1_norm", "instance") == "batch" else "instance"
    return nn.ModuleDict({
        "G1": GeneratorG1(ch, ch, norm=norm, **kw),
        "E": Encoder(ch, cfg.data.image_size, cfg.extra.get("latent_dim", 8), **kw),
        "G2": GeneratorG2(ch, ch, **kw)}).eval()


def thermalgan_serve(nets: nn.ModuleDict, a: torch.Tensor, t_b: torch.Tensor) -> torch.Tensor:
    """fake_B = G2(G1(A, normalized_temps(T_B))), G2 in eval mode. As the JAX
    ``Inferencer``, the temperatures are normalised for the batch-norm
    variant too, which trained on raw ones."""
    return nets["G2"](nets["G1"](a, normalized_temps(t_b)))


@dataclasses.dataclass
class ThermalDraws:

    PER_SAMPLE: ClassVar[tuple[str, ...]] = ('dropout_masks',)
    PER_ROW: ClassVar[tuple[str, ...]] = ('dropout_masks',)  # cut to rows too
    dropout_masks: dict[str, torch.Tensor] | None  # G2's keep-masks; None when deterministic_g


class ThermalGANRecipe:
    name = "thermalgan"

    def __init__(self, cfg: ExperimentConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        e, ch, dt = cfg.extra, cfg.data.channels, _dtype(cfg)
        self.bn_variant = e.get("g1_norm", "instance") == "batch"
        self.d_vae_mode = e.get("d_vae_mode", "single_mse" if self.bn_variant else "detached")
        if self.d_vae_mode not in D_VAE_MODES:
            raise ValueError(f"unknown d_vae_mode {self.d_vae_mode!r}; known: {D_VAE_MODES}")
        self.deterministic_g = bool(e.get("deterministic_g", False))
        kw = dict(dtype=dt, device=device)
        with without_draws():  # init, a checkpoint or the bridge fills them
            self.G = build_generators(cfg, device).train()
            d_vae = (VAEDiscriminator2(ch, **kw) if self.d_vae_mode == "single_mse"
                     else MultiDiscriminator(ch, **kw))
            self.D = nn.ModuleDict({"D_pix": DiscriminatorPix(2 * ch, **kw)})
        self.G["G2"].train(not self.deterministic_g)
        self.frozen = None
        if self.d_vae_mode == "detached":
            self.frozen = nn.ModuleDict({"D_vae": d_vae}).requires_grad_(False)
        else:
            self.D["D_vae"] = d_vae
        self.lpips = None
        self.lambda_kl = e.get("lambda_kl", 0.01)
        self.lambda_pixel_bic = e.get("lambda_pixel", 10.0)
        self.lambda_pixel_pix = e.get("lambda_pixel_pix", 100.0)

    @property
    def D_vae(self) -> nn.Module:
        return self.frozen["D_vae"] if self.frozen is not None else self.D["D_vae"]

    def init(self, generator: torch.Generator) -> None:
        """Draw every module's weights from ``generator``."""
        for net in (*self.G.values(), self.D["D_pix"], self.D_vae):
            net.reset_parameters(generator)

    def draw(self, generator: torch.Generator, batch: dict) -> ThermalDraws:
        """G2's keep-masks (none when ``deterministic_g``)."""
        if self.deterministic_g:
            return ThermalDraws(None)
        n, h, w = batch["A"].shape[:3]
        return ThermalDraws(self.G["G2"].draw_dropout_masks(n, h, w, generator))

    def _temps(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.bn_variant else normalized_temps(t, active_rows())

    def _vae_score(self, img: torch.Tensor, target: float) -> torch.Tensor:
        rows = active_rows()
        out = self.D_vae(img, rows)
        if self.d_vae_mode == "single_mse":
            return lsgan_loss(out, target, self.D_vae.out_rows(rows))
        return multiscale_loss(out, target, loss="l1", rows=self.D_vae.out_rows(rows))

    def g_loss(self, batch: dict, draws: ThermalDraws) -> tuple[torch.Tensor, dict, dict]:
        a, b = batch["A"], batch["B"]
        rows = active_rows()
        tbn = self._temps(batch["T_B"])
        mu, logvar = self.G["E"](b, rows)
        fake_s = self.G["G1"](a, tbn, rows)
        real_s = thermal_mask(b, rows)
        loss_pixel_bic = share_mean((fake_s.float() - real_s).abs(), rows)
        mu32, lv32 = mu.float(), logvar.float()
        loss_kl = replicated_share(
            0.5 * (lv32.exp() + mu32 * mu32 - 1.0 - lv32).sum(dim=-1).mean(), rows)
        if self.d_vae_mode == "detached":
            with torch.no_grad():
                loss_vae_gan = self._vae_score(fake_s.detach(), 1.0)
        else:
            loss_vae_gan = self._vae_score(fake_s, 1.0)
        t_fake = self._temps(temperature_lut(fake_s, mode=self.cfg.loss.temp_quantize))
        loss_latent = share_mean((tbn - t_fake).abs(), rows)
        loss_ge = (loss_vae_gan + self.lambda_kl * loss_kl
                   + self.lambda_pixel_bic * loss_pixel_bic + loss_latent)

        # stage 2: G2 over the detached fake_S
        fake_b = self.G["G2"](fake_s.detach(), draws.dropout_masks, rows)
        d_pix = self.D["D_pix"]
        loss_gan_pix = lsgan_loss(d_pix(fake_b, a, rows), 1.0, d_pix.out_rows(rows))
        loss_pixel_pix = share_mean((fake_b.float() - b).abs(), rows)
        loss_g2 = loss_gan_pix + self.lambda_pixel_pix * loss_pixel_pix

        total = loss_ge + loss_g2
        aux = {"fake_s": fake_s.detach(), "fake_b": fake_b.detach()}
        metrics = {"loss_G": total, "g_ge": loss_ge, "g_kl": loss_kl,
                   "g_vae_gan": loss_vae_gan, "g_pixel_bic": loss_pixel_bic,
                   "g_latent": loss_latent, "g_gan_pix": loss_gan_pix,
                   "g_pixel_pix": loss_pixel_pix}
        return total, aux, metrics

    def d_loss(self, batch: dict, aux: dict) -> tuple[torch.Tensor, dict]:
        a, b = batch["A"], batch["B"]
        rows, d_pix = active_rows(), self.D["D_pix"]
        pred_real = d_pix(b, a, rows)
        pred_fake = d_pix(aux["fake_b"], a, rows)
        lr = d_pix.out_rows(rows)
        loss = 0.5 * (lsgan_loss(pred_real, 1.0, lr) + lsgan_loss(pred_fake, 0.0, lr))
        metrics = {"d_pix": loss}
        if self.d_vae_mode != "detached":
            # real + fake, no 0.5: the reference's own Adam on D_VAE is the
            # D Adam here, over a disjoint set of parameters
            metrics["d_vae"] = (self._vae_score(thermal_mask(b, rows), 1.0)
                                + self._vae_score(aux["fake_s"], 0.0))
            loss = loss + metrics["d_vae"]
        metrics["loss_D"] = loss
        return loss, metrics
