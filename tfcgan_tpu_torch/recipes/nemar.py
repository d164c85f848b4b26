"""The NeMAR recipe (joint translation and registration), port of
``tfcgan_tpu.recipes.nemar``:

    fake_B = T(A);  [reg_A, fake_RT_B] = R(A, B, apply_on=[A, fake_B])
    fake_TR_B = T(reg_A)
    loss_TR = l_recon * L1(fake_TR_B, B) + l_GAN * GAN(D(A, fake_TR_B), 1)
    loss_RT = l_recon * L1(fake_RT_B, B) + l_GAN * GAN(D(A, fake_RT_B), 1)
    loss_G  = loss_TR + loss_RT + l_smooth * reg
    loss_D  = 0.5 * l_GAN * (GAN(D(A, B), 1) + GAN(D(A, fake_TR_B), 0)
                             + GAN(D(A, fake_RT_B), 0))

T is the ResNet translator, R the deformable STN (``extra["stn_type"] =
"affine"``: the conv-affine one), D the 70x70 PatchGAN on the channel concat,
GAN the least-squares loss. Defaults l_GAN = 1, l_recon = 100, l_smooth = 0.
``extra["multi_resolution"] = k`` adds k - 1 discriminators on inputs
downscaled by 2, 4, ...; every GAN term is then the sum over all of them.

D is updated **before** T and R in each step, and the T/R loss then runs
through the updated D: ``update_order = "d_first"``. The trainer runs
``forward`` once, gives its detached outputs (``d_aux``) to ``d_loss``, and
after D's Adam step hands the same forward to ``g_loss``. T and R share one
Adam (the container ``G``), the discriminators the other (``D``). The step
has no random draw.

On a spatial mesh (``parallel.spatial``; the step's image rows in
``active_rows()``) both ``stn_type``s run on row shards: T, R and the
discriminators on this rank's rows; R samples the targets gathered once at
its rows of the grid (K3 on a card). The L1 and GAN terms are this rank's
shares of their means, ``reg`` is the smoothness term's share or the
conv-affine STN's mean |dtheta| counted once over the group
(``replicated_share``). The multi-resolution discriminators' inputs are
downscaled from the images gathered once and cut back to the rank's rows
(``split_rows``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.discriminator import NLayerDiscriminator
from tfcgan_tpu_torch.models.layers import init_normal_
from tfcgan_tpu_torch.models.resnet_gen import ResNetGenerator
from tfcgan_tpu_torch.models.stn import CNNAffineSTN, DeformableSTN
from tfcgan_tpu_torch.ops.gan_losses import lsgan_loss
from tfcgan_tpu_torch.parallel.spatial import (Rows, active_rows, gather_spatial, share_mean,
                                               split_rows)

STN_TYPES = ("deformable", "affine")


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def build_generators(cfg: ExperimentConfig, device,
                     generator: torch.Generator | None = None) -> nn.ModuleDict:
    """The generator side {"T", "R"} on ``device`` in eval mode, weights drawn
    from ``generator`` (load state dicts over them for trained weights)."""
    if cfg.recipe != "nemar":
        raise ValueError(f"{cfg.name!r} is not a nemar experiment")
    e, ch = cfg.extra, cfg.data.channels
    stn_type = e.get("stn_type", "deformable")
    if stn_type not in STN_TYPES:
        raise ValueError(f"unknown stn_type {stn_type!r}; known: {STN_TYPES}")
    kw = dict(dtype=_dtype(cfg), device=device, generator=generator)
    fast = bool(e.get("fast_warp", True))
    if stn_type == "affine":
        r = CNNAffineSTN(cfg.data.image_size, 2 * ch, fast_warp=fast, **kw)
    else:
        r = DeformableSTN(2 * ch, alpha=e.get("stn_alpha", 0.0), fast_warp=fast, **kw)
    t = ResNetGenerator(ch, ch, num_blocks=int(e.get("resnet_blocks", 9)), **kw)
    return nn.ModuleDict({"T": t, "R": r}).eval()


def nemar_forward(nets: nn.ModuleDict, a: torch.Tensor, b: torch.Tensor,
                  rows: Rows | None = None) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The forward of the family: the four generated images and R's
    regulariser (with ``rows``: this rank's rows of each, and its share)."""
    fake_b = nets["T"](a, rows)
    (reg_a, fake_rt_b), reg = nets["R"](a, b, apply_on=[a, fake_b], rows=rows)
    return {"registered_A": reg_a, "fake_B": fake_b, "fake_TR_B": nets["T"](reg_a, rows),
            "fake_RT_B": fake_rt_b}, reg


def _downscale(x: torch.Tensor, side: int) -> torch.Tensor:
    """Antialiased bilinear resize of NHWC ``x`` to ``side`` x ``side``: the
    triangle filter widened by the scale, as ``jax.image.resize`` does when it
    shrinks an image."""
    return F.interpolate(x.permute(0, 3, 1, 2).float(), size=(side, side), mode="bilinear",
                         antialias=True, align_corners=False).permute(0, 2, 3, 1)


class NeMARRecipe:
    name = "nemar"
    update_order = "d_first"

    def __init__(self, cfg: ExperimentConfig, device, generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        e = cfg.extra
        self.G = build_generators(cfg, device, generator).train()
        self.multi_resolution = int(e.get("multi_resolution", 1))
        kw = dict(dtype=_dtype(cfg), device=device, generator=generator)
        heads = {"D": NLayerDiscriminator(2 * cfg.data.channels, **kw)}
        for i in range(self.multi_resolution - 1):
            heads[f"D_mr{i}"] = NLayerDiscriminator(2 * cfg.data.channels, **kw)
        self.D = nn.ModuleDict(heads)
        self.lpips = None
        self.lambda_gan = e.get("lambda_GAN", 1.0)
        self.lambda_recon = e.get("lambda_recon", 100.0)
        self.lambda_smooth = e.get("lambda_smooth", 0.0)

    T = property(lambda self: self.G["T"])
    R = property(lambda self: self.G["R"])

    def init(self, generator: torch.Generator) -> None:
        """Draw every module's weights from ``generator``."""
        init_normal_(self.T, generator)
        self.R.reset_parameters(generator)
        for d in self.D.values():
            d.reset_parameters(generator)

    def draw(self, generator: torch.Generator, batch: dict) -> None:
        """The step has no random draw."""
        return None

    # --------------------------------------------------------------- forward
    def forward(self, batch: dict, draws=None) -> dict:
        """T and R once, with their graph: ``nemar_forward``'s images and
        ``reg``."""
        images, reg = nemar_forward(self.G, batch["A"], batch["B"], active_rows())
        return {**images, "reg": reg}

    @staticmethod
    def d_aux(forward: dict) -> dict:
        return {k: forward[k].detach() for k in ("fake_TR_B", "fake_RT_B", "registered_A")}

    def _gan_all_scales(self, a: torch.Tensor, img: torch.Tensor, target: float
                        ) -> torch.Tensor:
        """The GAN loss of (A, img) summed over the main D and the
        multi-resolution ones on their downscaled inputs (on row shards this
        rank's share; the downscales read the images gathered once)."""
        rows = active_rows()
        d = self.D["D"]
        total = lsgan_loss(d(torch.cat([a, img.to(a.dtype)], dim=-1), rows), target,
                           d.out_rows(rows))
        if self.multi_resolution > 1:
            whole_a, whole_img = gather_spatial(a, rows), gather_spatial(img.to(a.dtype), rows)
        for i in range(self.multi_resolution - 1):
            side = whole_a.shape[1] // 2 ** (i + 1)
            small = rows and rows.of(side)
            d = self.D[f"D_mr{i}"]
            pair = torch.cat([_downscale(whole_a, side), _downscale(whole_img, side)], dim=-1)
            total = total + lsgan_loss(d(split_rows(pair, small), small), target,
                                       d.out_rows(small))
        return total

    # ---------------------------------------------------------------- losses
    def g_loss(self, batch: dict, draws=None, forward: dict | None = None
               ) -> tuple[torch.Tensor, dict, dict]:
        a, b = batch["A"], batch["B"]
        fwd = self.forward(batch, draws) if forward is None else forward
        fake_tr_b, fake_rt_b = fwd["fake_TR_B"], fwd["fake_RT_B"]
        rows = active_rows()
        l1_tr = self.lambda_recon * share_mean((fake_tr_b.float() - b).abs(), rows)
        l1_rt = self.lambda_recon * share_mean((fake_rt_b.float() - b).abs(), rows)
        gan_tr = self.lambda_gan * self._gan_all_scales(a, fake_tr_b, 1.0)
        gan_rt = self.lambda_gan * self._gan_all_scales(a, fake_rt_b, 1.0)
        smooth = self.lambda_smooth * fwd["reg"]
        total = l1_tr + l1_rt + gan_tr + gan_rt + smooth
        metrics = {"loss_G": total, "g_l1_tr": l1_tr, "g_l1_rt": l1_rt, "g_gan_tr": gan_tr,
                   "g_gan_rt": gan_rt, "g_smooth": smooth}
        return total, self.d_aux(fwd), metrics

    def d_loss(self, batch: dict, aux: dict) -> tuple[torch.Tensor, dict]:
        a, b = batch["A"], batch["B"]
        loss = 0.5 * self.lambda_gan * (self._gan_all_scales(a, b, 1.0)
                                        + self._gan_all_scales(a, aux["fake_TR_B"], 0.0)
                                        + self._gan_all_scales(a, aux["fake_RT_B"], 0.0))
        return loss, {"loss_D": loss}
