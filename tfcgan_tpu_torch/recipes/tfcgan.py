"""The TFC-GAN recipe matrix, port of ``tfcgan_tpu.recipes.tfcgan``: every
``tfcgan`` entry of the registry.

G loss = adv_w * relativistic BCE + triplet_w * patch triplet (random
whole-patch negatives) + temp_w * temperature term (the ColorJitter triplet
x lambda_t, or favtgan's L1 or temperature-map forms) + lpips_w * perceptual
(LPIPS, or the msrecon pyramid for ``perceptual="msrecon"`` and for "auto"
without LPIPS weights) + fft_w * FFT amp/phase L1 (or, V4/V5, the FFT
triplet) + region_w * the regional (hair/eyes band) FFT loss + mask_w * the
saliency-mask L1 + ce_w * the label cross-entropy of the debiased family;
D loss = the relativistic pair (+ its label cross-entropy). D forward order as
the reference: D(fake), D(real) in the G phase; D(real), D(fake.detach()) in
the D phase. Spectral norm advances once per step in the trainer, or, with
``extra["spectral_cadence"] = "per_forward"``, before each D forward in the
"uv" order of torch's parametrization.

The saliency-mask entry (``use_mask``) feeds G the image and its saliency
mask as a 4th channel. The debiased entries (``conditional``, V1-V7, see
``debias_axes``) condition G on the (gender, ethnicity, age) labels
(``batch["LAB3"]``), use the ``AuxClassifierDiscriminator`` and, from V4 on,
two regional ResNet-18s (``cnns``) on the fake's hair and eye bands: frozen
backbones, with the classifier heads trained by G's Adam in V4-V6 and frozen
in V7. Every random draw of a step is a field of ``StepDraws``.

On a spatial mesh (``parallel.spatial``; the step's image rows in
``active_rows()``) all 26 entries run on row shards: the 18 that build
``GeneratorUNet`` + ``PatchDiscriminator`` (fft_glo, fft_glo_16p,
fft_patch_4, fft_patch_16, fft_patch_region, fft_patch_region_kl,
original_16p, triptemp_base, triptemp_16p, favtgan_l1, favtgan_tempmap,
triptemp_ed, triptemp_ea, triptemp_ed_16p, triptemp_ea_16p,
ablation_nopatch, ablation_noperc and ablation_notemp), the saliency-mask
entry fft_patch_mask, and the seven debiased ones (fft_patch_debiased_v1,
fft_patch_debiased_v2, fft_patch_debiased_v3, fft_patch_debiased_v4,
fft_patch_debiased_v5, fft_patch_debiased_v6 and fft_patch_debiased, V7). G,
D and LPIPS run on this rank's rows, and the adversarial and LPIPS terms are
this rank's shares; the 3-channel fake and real images (and T_B) are
gathered over the spatial group once, and the terms that read whole images
(the patch triplet, whose negatives are other patches' rows; the temperature
terms, whose ColorJitter contrast uses each image's mean; the FFT, the V4/V5
FFT triplet, region and msrecon terms; the saliency-mask L1) are computed
whole on every rank and counted once (each rank's share 1 / S: the axis's
gradient rule). The saliency mask is normalised by extremes over whole
images: G's mask channel is the mask of A gathered once, cut to this rank's
rows (``g_input``). The conditional G computes its label plane whole and
keeps its rows; the aux classifier's heads are row-sharded products summed
over the group, so every rank holds the same probabilities, and the label
cross-entropies that read them, and the regional ResNet-18s' on the bands of
the gathered fake, are counted once too.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Sequence
from typing import ClassVar

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.discriminator import AuxClassifierDiscriminator, PatchDiscriminator
from tfcgan_tpu_torch.models.layers import (init_normal_, spectral_power_iteration,
                                             without_draws)
from tfcgan_tpu_torch.models.lpips import LPIPS, load_lpips_weights, resolve_perceptual
from tfcgan_tpu_torch.models.resnet import (ResNet18, load_resnet18_backbone,
                                            resolve_resnet_weights)
from tfcgan_tpu_torch.models.unet import ConditionalGeneratorUNet, GeneratorUNet
from tfcgan_tpu_torch.ops.color import JITTER_RANGES, color_jitter
from tfcgan_tpu_torch.ops.exact import bmm_fp32
from tfcgan_tpu_torch.ops.fftloss import fft_amp_phase, fft_l1_loss
from tfcgan_tpu_torch.ops.gan_losses import relativistic_d_loss, relativistic_g_loss
from tfcgan_tpu_torch.ops.patches import patchify
from tfcgan_tpu_torch.ops.perceptual import multiscale_recon
from tfcgan_tpu_torch.ops.saliency import saliency_mask
from tfcgan_tpu_torch.ops.temperature import temperature_lut
from tfcgan_tpu_torch.ops.triplet import triplet_margin_loss
from tfcgan_tpu_torch.parallel.mesh import active_mesh, all_gather_batch
from tfcgan_tpu_torch.parallel.spatial import (Rows, active_rows, gather_spatial,
                                               replicated_share, split_rows)


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def build_generator(cfg: ExperimentConfig, device, generator: torch.Generator | None = None
                    ) -> nn.Module:
    """The experiment's G on ``device`` in eval mode, weights drawn as the
    JAX init draws them from ``generator`` (load a state dict over them for
    trained weights): the ``ConditionalGeneratorUNet`` of a debiased entry,
    a ``GeneratorUNet`` with the mask channel for ``use_mask``, else the
    plain ``GeneratorUNet``."""
    if cfg.recipe != "tfcgan":
        raise NotImplementedError(f"recipe {cfg.recipe!r} is not ported yet")
    lc, c = cfg.loss, cfg.data.channels
    if lc.conditional and lc.use_mask:
        # no reference trainer combines them (the JAX recipe refuses too)
        raise ValueError("conditional and use_mask are mutually exclusive")
    if lc.conditional:
        g = ConditionalGeneratorUNet(c, c, cfg.data.image_size, dtype=_dtype(cfg),
                                     device=device, generator=generator)
    else:
        g = GeneratorUNet(c + int(lc.use_mask), c, dtype=_dtype(cfg), device=device,
                          generator=generator)
    return g.eval()


def g_input(cfg: ExperimentConfig, a: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """G's image input: A, with its saliency mask as a 4th channel under
    ``use_mask``. With ``rows`` A is this rank's rows: the mask of the whole
    images (gathered once), cut to them."""
    if cfg.loss.use_mask:
        mask = split_rows(saliency_mask(gather_spatial(a, rows)), rows)
        return torch.cat([a, mask.to(a.dtype)], dim=-1)
    return a


@dataclasses.dataclass
class StepDraws:
    """Every random draw of one train step."""

    PER_SAMPLE: ClassVar[tuple[str, ...]] = ('dropout_masks', 'g_labels', 'd_fake_labels')
    PER_ROW: ClassVar[tuple[str, ...]] = ('dropout_masks',)  # cut to the blocks' rows too

    patch_neg: torch.Tensor  # (grid²,) int64: the real patch each patch term uses as negative
    jitter_factors: torch.Tensor  # (4,) float32: brightness, contrast, saturation, hue
    jitter_order: Sequence[int]  # a permutation of range(4): the order of the jitter ops
    dropout_masks: dict[str, torch.Tensor] | None  # G's keep-masks; None when deterministic_g
    # the debiased family, (N, 3) int64 (gender, ethnicity, age) columns:
    g_labels: torch.Tensor | None = None  # V1: the labels G is conditioned on
    d_fake_labels: torch.Tensor | None = None  # V2-V7: the D phase's fake-label targets
    fft_neg: torch.Tensor | None = None  # V4/V5: (fft_grid²,) the FFT triplet's negatives


def debias_axes(lc) -> dict:
    """The debiased chain's variant semantics from ``debias_version`` (the
    JAX function's table):

    =====  ========  =========  ======  ========  ========  =========
    ver    heads     G labels   ethn x  regional  CNN opt   FFT form
    =====  ========  =========  ======  ========  ========  =========
    1      g/e/a     random     1       no        no        patch L1
    2      g/e/a     real       1       no        no        patch L1
    3      g/e/a     real       10      no        no        patch L1
    4      g/e/a     real       no      yes       G (fc)    triplet
    5      g/e/a     real       no      yes       G (fc)    triplet
    6      ethn      real       no      yes       G (fc)    patch L1
    7      ethn      real       no      yes       frozen    patch L1
    =====  ========  =========  ======  ========  ========  =========

    V1 scores D's fake-label CE against the labels G was conditioned on; V2+
    draw fresh ones for the D phase. V1 sums the three D label CEs, V2+ take a
    third of the sum."""
    v = lc.debias_version
    if not 1 <= v <= 7:
        raise ValueError(f"debias_version must be 1..7, got {v}")
    return {
        "multi_head": v <= 5,
        "g_labels_random": v == 1,
        "ethn_scale": 10.0 if v == 3 else 1.0,
        "regional": v >= 4,
        "cnn_train_g": 4 <= v <= 6,
        "fft_triplet": v in (4, 5),
        "d_label_avg": 1.0 if v == 1 else 1.0 / 3.0,
    }


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


def temperature_l1_loss(fake: torch.Tensor, t_real: torch.Tensor, lam: float, mode: str
                        ) -> torch.Tensor:
    """favtgan's _L1 form: lam * L1(T(fake), T_B)."""
    return (temperature_lut(fake, mode=mode) - t_real).abs().mean() * lam


def temperature_map_loss(fake: torch.Tensor, real: torch.Tensor, t_real: torch.Tensor,
                         mode: str) -> torch.Tensor:
    """favtgan's _TempMap form: L1 between the per-sample products red
    channel @ temperature map of the real and the fake image, / 1000; float32
    products without TF32 (the JAX function's Precision.HIGHEST)."""
    t_fake = temperature_lut(fake, mode=mode)
    map_r = bmm_fp32(real[..., 0], t_real)
    map_f = bmm_fp32(fake[..., 0], t_fake)
    return (map_r - map_f).abs().mean() / 1000.0


def fft_loss(fake: torch.Tensor, real: torch.Tensor, lc) -> torch.Tensor:
    """Global (fft_grid 1) or per-patch FFT amp + phase L1, the patches folded
    into the batch (equal sizes: the mean over P*N is the mean of the
    per-patch means)."""
    if lc.fft_grid > 1:
        fake = patchify(fake, lc.fft_grid).flatten(0, 1)
        real = patchify(real, lc.fft_grid).flatten(0, 1)
    return fft_l1_loss(fake, real, mode=lc.fft_quantize)[0]


def region_bands(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The hair rows [0, r1) and the eye rows [r1, 2 r1), full width, with
    r1 = round(100 H / 256): [0, 100) and [100, 200) at 256²."""
    r1 = round(100 * x.shape[1] / 256)
    return x[:, :r1], x[:, r1:2 * r1]


def regional_fft_loss(fake: torch.Tensor, real: torch.Tensor, lc) -> torch.Tensor:
    """The FFT amp and phase of the hair and eye bands: ``region_fft="l1"``
    sums the bands' L1 terms; ``"kl"`` sums torch's KLDivLoss(log_target=True)
    between log-softmaxes over the BATCH axis, as the reference does (in a
    data-parallel step, the global batch, all gathered). Returns 0.5 (amp +
    phase)."""
    comps = [fft_amp_phase(x, mode=lc.fft_quantize) for x in (*region_bands(fake),
                                                               *region_bands(real))]
    (ah_f, ph_f), (ae_f, pe_f), (ah_r, ph_r), (ae_r, pe_r) = comps
    if lc.region_fft == "l1":
        def term(f, r):
            return (f - r).abs().mean()
    elif lc.region_fft == "kl":
        mesh = active_mesh()  # a data-parallel step: the softmax over the global batch

        def term(f, r):
            f, r = all_gather_batch(f, mesh), all_gather_batch(r, mesh)
            li, lt = torch.log_softmax(f, dim=0), torch.log_softmax(r, dim=0)
            return (torch.exp(lt) * (lt - li)).mean()
    else:
        raise ValueError(f"unknown region_fft {lc.region_fft!r}")
    amp = term(ah_f, ah_r) + term(ae_f, ae_r)
    pha = term(ph_f, ph_r) + term(pe_f, pe_r)
    return 0.5 * (amp + pha)


def fft_triplet_loss(fake: torch.Tensor, real: torch.Tensor, neg_idx: torch.Tensor, lc
                     ) -> torch.Tensor:
    """The V4/V5 FFT form: per-patch amplitude and phase triplets, real patch
    ``neg_idx[p]`` the negative of patch p's two terms; 0.5 (amp + phase)."""
    g = lc.fft_grid
    fp, rp = patchify(fake, g), patchify(real, g)
    comps = [fft_amp_phase(x.flatten(0, 1), mode=lc.fft_quantize)
             for x in (fp, rp, rp[neg_idx])]
    (af, pf), (ar, pr), (an, pn) = comps
    amp = triplet_margin_loss(af, ar, an, axis=-1)
    pha = triplet_margin_loss(pf, pr, pn, axis=-1)
    return 0.5 * (amp + pha)


def cross_entropy(x: torch.Tensor, labels: torch.Tensor, from_probs: bool) -> torch.Tensor:
    """torch's CrossEntropyLoss with integer labels, in float32. The aux
    heads give softmax probabilities, which the reference feeds to
    CrossEntropyLoss all the same (a double softmax): ``from_probs=True``
    takes log(softmax(probs)) as the JAX function does."""
    x = x.float()
    logp = torch.log(torch.softmax(x, dim=-1)) if from_probs else torch.log_softmax(x, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def draw_labels(lc, n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, 3) int64 uniform (gender, ethnicity, age) labels on ``generator``'s device."""
    dev = generator.device
    return torch.stack([torch.randint(0, k, (n,), generator=generator, device=dev)
                        for k in (lc.num_gender, lc.num_classes, lc.num_age)], dim=1)


class TFCGANRecipe:
    """The modules are built without their weights (``layers.without_draws``):
    ``init`` draws them (``Trainer.init_state``), or a checkpoint or the
    bridge fills them."""

    name = "tfcgan"
    supports_per_forward_spectral = True

    def __init__(self, cfg: ExperimentConfig, device):
        with without_draws():
            self._build(cfg, device)

    def _build(self, cfg: ExperimentConfig, device) -> None:
        lc = cfg.loss
        self.cfg = cfg
        self.device = torch.device(device)
        self.per_forward_spectral = cfg.extra.get("spectral_cadence", "per_step") == "per_forward"
        self.deterministic_g = bool(cfg.extra.get("deterministic_g", False))
        dtype = _dtype(cfg)
        c, size = cfg.data.channels, cfg.data.image_size
        self.G = build_generator(cfg, device)
        self.G.train(not self.deterministic_g)
        self.axes = debias_axes(lc) if lc.conditional else None
        self.cnns, self.resnet_weights = None, ""
        if lc.conditional:
            mh = self.axes["multi_head"]
            self.D = AuxClassifierDiscriminator(
                2 * c, size, lc.num_classes, lc.num_gender if mh else 0,
                lc.num_age if mh else 0, dtype=dtype, device=device)
            if self.axes["regional"]:
                # converted torchvision weights run in the BN-folded form
                self.resnet_weights = resolve_resnet_weights(lc)
                norm = "folded" if self.resnet_weights else "gn"
                self.cnns = nn.ModuleDict({
                    k: ResNet18(lc.num_classes, c, norm=norm, dtype=dtype, device=device).eval()
                    for k in ("cnn_hair", "cnn_eyes")})
                # frozen backbones; the heads train with G in V4-V6, frozen in V7
                self.cnns.requires_grad_(False)
                for cnn in self.cnns.values():
                    cnn.fc.requires_grad_(self.axes["cnn_train_g"])
        else:
            self.D = PatchDiscriminator(2 * c, dtype=dtype, device=device)
        # the perceptual term: LPIPS, or the fixed msrecon pyramid (no module)
        self.perceptual = resolve_perceptual(lc) if lc.use_lpips else "off"
        if self.perceptual not in ("lpips", "msrecon", "off"):
            raise ValueError(f"unknown perceptual mode {self.perceptual!r}")
        self.lpips = None
        if self.perceptual == "lpips":
            self.lpips = LPIPS(dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        """Draw G, D (with spectral u/v), LPIPS and the regional CNNs from
        ``generator``; where converted weights resolve, LPIPS and the CNNs'
        backbones are loaded from them instead, as the JAX init does, and the
        classifier heads stay drawn."""
        if self.cfg.loss.conditional:
            self.G.reset_parameters(generator)
        else:
            init_normal_(self.G, generator)
        self.D.reset_parameters(generator)
        if self.lpips is not None:
            load_lpips_weights(self.lpips, self.cfg.loss, generator)
        backbone = (load_resnet18_backbone(self.resnet_weights)
                    if self.cnns is not None and self.resnet_weights else None)
        for cnn in (self.cnns or {}).values():
            cnn.reset_parameters(generator)
            if backbone is not None:
                missing, _ = cnn.load_state_dict(backbone, strict=False)
                assert all(k.startswith("fc.") for k in missing), missing

    def draw(self, generator: torch.Generator, batch: dict) -> StepDraws:
        """One step's draws on ``generator``'s device, with the JAX ranges."""
        lc = self.cfg.loss
        dev = generator.device
        p = lc.patch_grid ** 2
        neg = torch.randint(0, max(p, 1), (p,), generator=generator, device=dev)
        lo, hi = (torch.tensor(r, device=dev) for r in zip(*JITTER_RANGES))
        factors = lo + torch.rand(4, generator=generator, device=dev) * (hi - lo)
        order = torch.randperm(4, generator=generator, device=dev).tolist()
        n, h, w = batch["A"].shape[:3]
        masks = None if self.deterministic_g else self.G.draw_dropout_masks(n, h, w, generator)
        draws = StepDraws(neg, factors, order, masks)
        if lc.conditional:
            if self.axes["g_labels_random"]:
                draws.g_labels = draw_labels(lc, n, generator)
            else:
                draws.d_fake_labels = draw_labels(lc, n, generator)
            if self.axes["fft_triplet"]:
                q = lc.fft_grid ** 2
                draws.fft_neg = torch.randint(0, q, (q,), generator=generator, device=dev)
        return draws

    # -------------------------------------------------------------- helpers
    def _single_pass_d(self) -> bool:
        """``TFCGAN_SINGLE_PASS_D=1``: D(fake) and D(real) of a phase as one
        forward on the concatenated batch (D couples no samples, so the values
        are the same). Never with the per-forward cadence, where u/v advance
        between the two forwards, nor for the conditional D (the JAX recipe
        runs its forwards one by one)."""
        if self.per_forward_spectral or self.cfg.loss.conditional:
            return False
        return os.environ.get("TFCGAN_SINGLE_PASS_D", "0") not in ("0", "false")

    def _disc_pair(self, first: torch.Tensor, second: torch.Tensor, cond: torch.Tensor):
        if self._single_pass_d():
            both = self._d(torch.cat([first, second.to(first.dtype)]), torch.cat([cond, cond]))
            return both[:first.shape[0]], both[first.shape[0]:]
        return self._disc(first, cond), self._disc(second, cond)

    def _d(self, img: torch.Tensor, cond: torch.Tensor):
        rows = active_rows()
        return self.D(img, cond) if rows is None else self.D(img, cond, rows)

    def _disc(self, img: torch.Tensor, cond: torch.Tensor):
        if self.per_forward_spectral:
            spectral_power_iteration(self.D, order="uv")
        return self._d(img, cond)

    def _logit_rows(self):
        """The record of D's row-sharded logits (None off a spatial mesh)."""
        rows = active_rows()
        return None if rows is None else self.D.out_rows(rows)

    def generate(self, batch: dict, draws: StepDraws, labels: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """G's output on the batch (``labels``: the conditional G's (N, 3)
        labels); on a spatial mesh, this rank's rows of it."""
        rows = active_rows()
        if self.cfg.loss.conditional:
            if rows is None:
                return self.G(batch["A"], labels.float(), draws.dropout_masks)
            return self.G(batch["A"], labels.float(), draws.dropout_masks, rows)
        if rows is None:
            return self.G(g_input(self.cfg, batch["A"]), draws.dropout_masks)
        return self.G(g_input(self.cfg, batch["A"], rows), draws.dropout_masks, rows)

    def _label_ce(self, probs_f, g3: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
        """G's label loss against the labels G was conditioned on; ``fake``
        whole images (on a spatial mesh, gathered)."""
        ax = self.axes
        gender, ethn, age = g3[:, 0], g3[:, 1], g3[:, 2]
        pg_f, pe_f, pa_f = probs_f if ax["multi_head"] else (None, probs_f, None)
        if ax["regional"]:
            hair, eyes = region_bands(fake)
            reg = (cross_entropy(self.cnns["cnn_hair"](hair), ethn, False)
                   + cross_entropy(self.cnns["cnn_eyes"](eyes), ethn, False))
            ce = 0.5 * (reg + cross_entropy(pe_f, ethn, True))
            if ax["multi_head"]:  # V4/V5
                ce = ce + cross_entropy(pg_f, gender, True) + cross_entropy(pa_f, age, True)
            return ce
        return (cross_entropy(pg_f, gender, True) + ax["ethn_scale"] * cross_entropy(
            pe_f, ethn, True) + cross_entropy(pa_f, age, True))

    # --------------------------------------------------------------- losses
    def g_loss(self, batch: dict, draws: StepDraws) -> tuple[torch.Tensor, dict, dict]:
        lc = self.cfg.loss
        a, b = batch["A"], batch["B"]
        aux = {}
        if lc.conditional:
            lab3 = batch["LAB3"].long()
            g3 = draws.g_labels if self.axes["g_labels_random"] else lab3
            aux["d_fake_labels"] = g3 if self.axes["g_labels_random"] else draws.d_fake_labels
            fake = self.generate(batch, draws, g3)
            pred_fake, probs_f = self._disc(fake, a)
            pred_real, _ = self._disc(b, a)
        else:
            fake = self.generate(batch, draws)
            pred_fake, pred_real = self._disc_pair(fake, b, a)
        rows = active_rows()
        adv = relativistic_g_loss(pred_fake, pred_real, lc.label_smooth, self._logit_rows())
        metrics = {"g_adv": adv}
        total = lc.adv_weight * adv
        # the terms that read whole images: on a spatial mesh the images
        # gathered once, each term counted once over the group (1 / S a rank)
        whole_fake, whole_b = gather_spatial(fake, rows), gather_spatial(b, rows)
        t_b = gather_spatial(batch["T_B"], rows) if lc.use_temp else None

        def whole(term):
            return replicated_share(term, rows)

        if lc.patch_grid > 0:
            metrics["g_triplet"] = whole(patch_triplet_loss(whole_fake, whole_b, draws.patch_neg,
                                                            lc.patch_grid))
            total = total + lc.triplet_weight * metrics["g_triplet"]
        if lc.use_temp:
            if lc.temp_mode == "l1":
                temp = temperature_l1_loss(whole_fake, t_b, lc.temp_lambda, lc.temp_quantize)
            elif lc.temp_mode == "tempmap":
                temp = temperature_map_loss(whole_fake, whole_b, t_b, lc.temp_quantize)
            else:
                temp = temperature_triplet_loss(whole_fake, whole_b, t_b,
                                                draws.jitter_factors, draws.jitter_order,
                                                lc.temp_lambda, lc.temp_quantize)
            metrics["g_temp"] = whole(temp)
            total = total + lc.temp_weight * metrics["g_temp"]
        if self.lpips is not None:
            lp = self.lpips(fake, b) if rows is None else self.lpips(fake, b, rows)
            metrics["g_lpips"] = lp.mean()
            total = total + lc.lpips_weight * metrics["g_lpips"]
        elif self.perceptual == "msrecon":
            metrics["g_lpips"] = whole(multiscale_recon(whole_fake, whole_b))
            total = total + lc.lpips_weight * metrics["g_lpips"]
        if lc.fft_mode != "off":
            if lc.conditional and self.axes["fft_triplet"]:
                metrics["g_fft"] = whole(fft_triplet_loss(whole_fake, whole_b, draws.fft_neg, lc))
            else:
                metrics["g_fft"] = whole(fft_loss(whole_fake, whole_b, lc))
            total = total + lc.fft_weight * metrics["g_fft"]
        if lc.region_fft != "off":
            metrics["g_region_fft"] = whole(regional_fft_loss(whole_fake, whole_b, lc))
            total = total + lc.region_fft_weight * metrics["g_region_fft"]
        if lc.use_mask:
            metrics["g_mask"] = whole((saliency_mask(whole_fake)
                                       - saliency_mask(whole_b)).abs().mean())
            total = total + lc.mask_weight * metrics["g_mask"]
        if lc.conditional:
            metrics["g_ce"] = whole(self._label_ce(probs_f, g3, whole_fake))
            total = total + lc.ce_weight * metrics["g_ce"]
        metrics["loss_G"] = total
        aux["fake_b"] = fake.detach()
        return total, aux, metrics

    def d_loss(self, batch: dict, aux: dict) -> tuple[torch.Tensor, dict]:
        lc = self.cfg.loss
        a, b = batch["A"], batch["B"]
        if not lc.conditional:
            pred_real, pred_fake = self._disc_pair(b, aux["fake_b"], a)
            loss = relativistic_d_loss(pred_real, pred_fake, lc.label_smooth, lc.d_loss_weight,
                                       self._logit_rows())
            return loss, {"loss_D": loss}
        pred_real, probs_r = self._disc(b, a)
        pred_fake, probs_f = self._disc(aux["fake_b"], a)
        loss = relativistic_d_loss(pred_real, pred_fake, lc.label_smooth, lc.d_loss_weight,
                                   self._logit_rows())
        ax = self.axes

        def label_ce(probs, t3):
            if ax["multi_head"]:
                return ax["d_label_avg"] * sum(cross_entropy(p, t3[:, i], True)
                                               for i, p in enumerate(probs))
            return cross_entropy(probs, t3[:, 1], True)

        # real targets the annotations, fake targets the step's draws (V1:
        # the labels G was conditioned on); every spatial rank holds the
        # same probabilities, so the term is counted once over the group
        ce = replicated_share(0.5 * (label_ce(probs_r, batch["LAB3"].long())
                                     + label_ce(probs_f, aux["d_fake_labels"])), active_rows())
        loss = loss + ce
        return loss, {"loss_D": loss, "d_ce": ce}
