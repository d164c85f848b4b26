"""The TFC-Diff recipes, port of ``tfcgan_tpu.recipes.diffusion``.

Variants (config ``extra["variant"]``):

- ``condA`` (default): grayscale conditional DDPM: x_t = add_noise(gray(B),
  eps, t), eps_hat = UNet(x_t, t, gray(A)), MSE(eps_hat, eps). T = 500.
- ``label``: RGB DDPM conditioned on a learned class embedding broadcast to
  image planes (in = 3 + emb channels), T = 1000.
- ``hybrid``: the TFC-GAN U-Net generator and the denoiser train jointly:
  fake_B = G(A); LPIPS(fake_B, B) + the noise loss on add_noise(fake_B), which
  is **not** detached, so the noise loss reaches G too. LPIPS runs on random
  VGG16 weights, as in the JAX package.

There is no discriminator: ``D`` is a module without parameters, ``d_loss`` a
constant zero, and the trainer skips the D phase. Everything the one Adam steps
sits in ``G`` (``DiffusionGenerators``: the U-Net, and where the variant has
them the class embedding and the generator). A step's draws (the noise, the
timesteps in [0, T - 2], and for ``hybrid`` G's dropout keep-masks) come in as
one ``DiffusionStepDraws``. ``sample`` runs the whole ancestral chain on the
device (``models.diffusion.sample``).

On a spatial mesh (``parallel.spatial``; the step's image rows in
``active_rows()``) all three variants run on row shards: the noise draw is
cut to this rank's rows with the images (``PER_ROW``), the U-Net runs on
them (``CondUNet(rows=)``), the condition planes (gray(A), or the class
embedding broadcast over A's pixels) are this rank's rows by construction,
and the noise MSE is this rank's share of the whole mean (``share_mean``).
The hybrid's G and LPIPS run on rows as in the ``tfcgan`` recipes, its
keep-masks cut to the blocks' rows; a layer whose maps have fewer rows than
the group can serve from adjacent shards (G's 1-row maps at 64²) runs on the
whole map (``parallel.spatial.REPLICATED_LAYERS``).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.diffusion import CondUNet, DDPMSchedule, sample
from tfcgan_tpu_torch.models.layers import init_normal_
from tfcgan_tpu_torch.models.lpips import LPIPS
from tfcgan_tpu_torch.models.unet import GeneratorUNet
from tfcgan_tpu_torch.parallel.spatial import active_rows, share_mean
from tfcgan_tpu_torch.parallel.tensor import full_param

VARIANTS = ("condA", "label", "hybrid")
_GRAY = (0.2989, 0.587, 0.114)


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def _variant(cfg: ExperimentConfig) -> str:
    if cfg.recipe != "diffusion":
        raise ValueError(f"{cfg.name!r} is not a diffusion experiment")
    variant = cfg.extra.get("variant", "condA")
    if variant not in VARIANTS:
        raise ValueError(f"unknown diffusion variant {variant!r}; known: {VARIANTS}")
    return variant


def to_gray(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N, H, W, 1) luma."""
    return (x * torch.tensor(_GRAY, dtype=x.dtype, device=x.device)).sum(dim=-1, keepdim=True)


def schedule_of(cfg: ExperimentConfig) -> DDPMSchedule:
    default_t = 500 if _variant(cfg) == "condA" else 1000
    return DDPMSchedule(num_timesteps=cfg.extra.get("timesteps", default_t))


class DiffusionGenerators(nn.Module):
    """What the family trains and serves: ``unet``; for ``label`` and
    ``hybrid`` also ``class_emb`` (num_classes, emb); for ``hybrid`` also
    ``G``."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.variant = _variant(cfg)
        self.tensor_dims = {"class_emb": 1}  # gathered before the lookup on a tensor mesh
        e, dtype = cfg.extra, _dtype(cfg)
        channels = 1 if self.variant == "condA" else cfg.data.channels
        cond_channels = 1
        if self.variant != "condA":
            cond_channels = e.get("class_emb_size", 4)
            self.class_emb = nn.Parameter(torch.empty(e.get("num_classes", 4), cond_channels,
                                                      device=device))
        self.unet = CondUNet(channels + cond_channels, channels, dtype=dtype, device=device,
                             generator=generator)
        if self.variant == "hybrid":
            self.G = GeneratorUNet(cfg.data.channels, cfg.data.channels, dtype=dtype,
                                   device=device, generator=generator)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX init's distributions, drawn on the CPU from ``generator``:
        flax defaults for the U-Net, normal(0, 0.02) for the class embedding
        and for G's kernels."""
        self.unet.reset_parameters(generator)
        if self.variant != "condA":
            self.class_emb.copy_(torch.randn(self.class_emb.shape, generator=generator) * 0.02)
        if self.variant == "hybrid":
            init_normal_(self.G, generator)

    def cond(self, batch: dict) -> torch.Tensor:
        """The U-Net's condition planes: gray(A), or the class embedding of
        ``batch["LAB"]`` broadcast over A's pixels."""
        a = batch["A"]
        if self.variant == "condA":
            return to_gray(a)
        emb = full_param(self, "class_emb")[batch["LAB"].long()]
        return emb[:, None, None, :].expand(*a.shape[:3], emb.shape[-1])


def build_generators(cfg: ExperimentConfig, device,
                     generator: torch.Generator | None = None) -> DiffusionGenerators:
    """The family's networks on ``device`` in eval mode, weights drawn from
    ``generator`` (load a state dict over them for trained weights)."""
    return DiffusionGenerators(cfg, device, generator).eval()


def diffusion_sample(nets: DiffusionGenerators, schedule: DDPMSchedule, batch: dict,
                     generator: torch.Generator | None = None,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
    """x_0 sampled for ``batch`` ({"A"[, "LAB"]}, on the networks' device):
    (N, H, W, 1) for ``condA``, (N, H, W, 3) otherwise, float32."""
    with torch.no_grad():
        cond = nets.cond(batch)
    return sample(nets.unet, schedule, cond, generator, noise)


@dataclasses.dataclass
class DiffusionStepDraws:
    """Every random draw of one TFC-Diff train step."""

    PER_SAMPLE: ClassVar[tuple[str, ...]] = ('noise', 't', 'dropout_masks')
    PER_ROW: ClassVar[tuple[str, ...]] = ('noise', 'dropout_masks')  # cut to rows too

    noise: torch.Tensor  # the target image's shape, float32 standard normal
    t: torch.Tensor  # (N,) int64 timesteps in [0, T - 2]
    dropout_masks: dict[str, torch.Tensor] | None  # hybrid: G's keep-masks


class DiffusionRecipe:
    name = "diffusion"

    def __init__(self, cfg: ExperimentConfig, device, generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.variant = _variant(cfg)
        self.schedule = schedule_of(cfg)
        self.G = DiffusionGenerators(cfg, device, generator).train()
        self.D = nn.Module()  # no discriminator: nothing for a second Adam
        self.lpips = None
        if self.variant == "hybrid":
            self.lpips = LPIPS(dtype=_dtype(cfg), device=device, generator=generator)

    unet = property(lambda self: self.G.unet)

    def init(self, generator: torch.Generator) -> None:
        """Draw every module's weights from ``generator``."""
        self.G.reset_parameters(generator)
        if self.lpips is not None:
            self.lpips.reset_parameters(generator)

    def _target_shape(self, batch: dict) -> tuple[int, ...]:
        n, h, w, c = batch["A"].shape
        return (n, h, w, 1 if self.variant == "condA" else c)

    def draw(self, generator: torch.Generator, batch: dict) -> DiffusionStepDraws:
        """One step's draws on ``generator``'s device. The timesteps are
        uniform on [0, T - 2]: the JAX step's ``randint(0, T - 1)`` has an
        exclusive upper end."""
        dev = generator.device
        shape = self._target_shape(batch)
        noise = torch.randn(shape, generator=generator, device=dev)
        t = torch.randint(0, self.schedule.num_timesteps - 1, (shape[0],), generator=generator,
                          device=dev)
        masks = None
        if self.variant == "hybrid":
            masks = self.G.G.draw_dropout_masks(*shape[:3], generator)
        return DiffusionStepDraws(noise, t, masks)

    # ---------------------------------------------------------------- losses
    def g_loss(self, batch: dict, draws: DiffusionStepDraws) -> tuple[torch.Tensor, dict, dict]:
        metrics = {}
        rows = active_rows()  # on a spatial mesh the images are this rank's rows
        if self.variant == "condA":
            target = to_gray(batch["B"])
        elif self.variant == "label":
            target = batch["B"]
        else:
            target = self.G.G(batch["A"], draws.dropout_masks, rows)  # not detached
            metrics["g_recon"] = self.lpips(target, batch["B"], rows).mean()
        noise = draws.noise.float()
        x_t = self.schedule.add_noise(target.float(), noise, draws.t)
        eps = self.unet(x_t, draws.t, self.G.cond(batch), rows)
        loss = share_mean((eps.float() - noise).square(), rows)
        metrics["g_noise_mse"] = loss
        if self.variant == "hybrid":
            loss = loss + metrics["g_recon"]
        metrics["loss_G"] = loss
        return loss, {}, metrics

    def d_loss(self, batch: dict, aux: dict) -> tuple[torch.Tensor, dict]:
        zero = torch.zeros((), device=self.device)
        return zero, {"loss_D": zero}

    def sample(self, batch: dict, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """The ancestral chain for ``batch`` with the current weights."""
        return diffusion_sample(self.G, self.schedule, batch, generator, noise)
