"""Typed configuration tree of the port: the dataclasses and the experiment
registry of ``tfcgan_tpu.config``, kept here as the port's own copy so that the
port loads nothing of the JAX package (``tests/test_torch_config.py`` holds
the two registries equal entry by entry).

Defaults mirror the canonical training configs
(``bash/1103_DEVCOMAO5_TFCGANFFT16P.sh``: 256², batch 32, Adam 2e-4
β=(0.5, 0.999), label smoothing 0.9). Comments that name a file cite the
reference training scripts each entry was taken from.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    # "constant" | "linear_decay" (CycleGAN/NeMAR LambdaLR)
    schedule: str = "constant"
    decay_start_epoch: int = 100


@dataclass(frozen=True)
class DataConfig:
    root: str = ""
    dataset_name: str = "synthetic"
    batch_size: int = 32
    image_size: int = 256
    channels: int = 3
    # extra dataset roots for balanced multi-dataset training (ED/EA recipes)
    extra_roots: tuple[str, ...] = ()
    direction: str = "AtoB"  # or "BtoA"
    num_workers: int = 8
    # input staging of the JAX package ("pool": the decoded dataset staged in
    # device memory as uint8, "stream": uint8 batches through a prefetcher,
    # "auto": pool when the staged set is under ~2 GB); the port reads the
    # field and has no staged pool yet
    staging: str = "auto"


@dataclass(frozen=True)
class LossConfig:
    """Loss-recipe switches covering the reference script matrix (SURVEY §2.1)."""

    adv_weight: float = 0.5
    label_smooth: float = 0.9
    # perceptual: "lpips" uses the VGG16 LPIPS module (pretrained weights
    # loaded from ``lpips_weights`` when set — tools/convert_lpips.py emits
    # them; random-init otherwise), "msrecon" uses the fixed multi-scale
    # L1+NCC pyramid (ops/perceptual.py), "auto" picks lpips when weights
    # are available and msrecon when not (the STN family default: a
    # random-weight LPIPS is measured to collapse registration).
    use_lpips: bool = True
    perceptual: str = "lpips"
    lpips_weights: str = ""
    lpips_weight: float = 0.5
    # patch triplet
    patch_grid: int = 2  # 2 -> 4 patches, 4 -> 16 patches, 0 -> off
    triplet_weight: float = 1.0
    # temperature loss: "triplet" (jittered negatives), "l1"
    # (favtgan _L1: L1(T(fake), T_B)·λ_t), or "tempmap" (favtgan _TempMap:
    # L1 between red-channel × temp-map matmuls / 1000)
    use_temp: bool = True
    temp_mode: str = "triplet"
    temp_weight: float = 0.5
    temp_lambda: float = 10.0
    # Fourier losses: "global" | "patch" | "off"
    fft_mode: str = "global"
    fft_grid: int = 1  # 1 = whole image; 2 = 4 patches; 4 = 16 patches
    fft_weight: float = 0.01
    # "exact" = reference parity (uint8 quantize, zero grad);
    # "smooth" = differentiable (the default)
    fft_quantize: str = "smooth"
    temp_quantize: str = "smooth"
    # regional FFT loss (withregion variants): "off" | "l1" | "kl"
    region_fft: str = "off"
    region_fft_weight: float = 1e-4
    # Gaussian saliency-mask experiment (patchFFT_experiment.py): extra mask
    # input channel to G + L1 mask-consistency loss
    use_mask: bool = False
    mask_weight: float = 0.5
    # debiased family (TFCGAN_multigpu_patchFFT_debiased[_V2.._V7].py).
    # ``debias_version`` selects the variant-chain semantics bundle — heads,
    # label sources, regional CNNs, FFT-loss form; see
    # ``recipes/tfcgan.debias_axes`` for the derivation table.
    conditional: bool = False
    debias_version: int = 7
    num_classes: int = 4  # ethnicity classes (White/Asian/B/NW, V7:253)
    num_gender: int = 2
    num_age: int = 3
    ce_weight: float = 1.0
    d_loss_weight: float = 0.5
    # converted torchvision resnet18 weights for the frozen regional CNNs
    # (tools/convert_resnet.py); random-init backbone when empty
    resnet_weights: str = ""


@dataclass(frozen=True)
class TrainConfig:
    n_epochs: int = 201
    steps_per_epoch: int | None = None  # derived from dataset if None
    seed: int = 42
    sample_interval: int = 200
    checkpoint_interval: int = 100
    log_interval: int = 10
    compute_dtype: str = "bfloat16"  # replaces AMP fp16 + GradScaler
    checkpoint_dir: str = "checkpoints"
    sample_dir: str = "samples"
    log_dir: str = "logs"


@dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    # device count is discovered at runtime; set to pin a sub-mesh
    num_devices: int | None = None
    # devices on the spatial (image-H) axis; 1 = pure data parallel.
    # With spatial > 1 the mesh is 2-D (data, spatial) and image tensors are
    # sharded over H with GSPMD conv halo exchange.
    spatial: int = 1
    # devices on the tensor (model) axis; >1 shards conv out-channels /
    # dense out-features over it (parallel.mesh.param_sharding) — weight and
    # optimizer memory shrink ~1/tensor, GSPMD inserts the collectives.
    tensor: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "fft_glo"
    recipe: str = "tfcgan"  # tfcgan | stn | cyclegan | thermalgan | nemar | diffusion
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    extra: dict[str, Any] = field(default_factory=dict)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _loss(**kw) -> LossConfig:
    return LossConfig(**kw)


# ----------------------------------------------------------------- registry
# One entry per reference trainer script (SURVEY.md §2.1/§2.2) — the 30-script
# duplication becomes a dict of loss configs.
EXPERIMENTS: dict[str, ExperimentConfig] = {}


def register(cfg: ExperimentConfig) -> ExperimentConfig:
    EXPERIMENTS[cfg.name] = cfg
    return cfg


# TFC-GAN FFT family (TFC-GAN-FFT/)
register(ExperimentConfig(name="fft_glo", loss=_loss(fft_mode="global", patch_grid=2)))
register(ExperimentConfig(name="fft_glo_16p", loss=_loss(fft_mode="global", patch_grid=4)))
register(ExperimentConfig(name="fft_patch_4", loss=_loss(fft_mode="patch", fft_grid=2, patch_grid=2)))
register(ExperimentConfig(name="fft_patch_16", loss=_loss(fft_mode="patch", fft_grid=4, patch_grid=4)))
# original_16P / the whole favtgan lineage weight every G term 1.0
# (``TFCGAN_original_16P.py:461``: G = adv + pix + triplet + temp)
_FAV = dict(fft_mode="off", adv_weight=1.0, lpips_weight=1.0, temp_weight=1.0)
register(ExperimentConfig(name="original_16p", loss=_loss(patch_grid=4, **_FAV)))
# withregion_FFT (``:603-620``): G = ½(adv + 1e-4·FFTsum + 1e-4·REG + patch¼
# + temp + pix). fft_loss SUMS the 4 per-patch L1s -> ½·1e-4·4 = 2e-4 on our
# merged-mean form; the regional term's form matches ours exactly -> ½·1e-4.
register(ExperimentConfig(name="fft_patch_region", loss=_loss(
    fft_mode="patch", fft_grid=2, fft_weight=2e-4, patch_grid=2,
    triplet_weight=0.5, region_fft="l1", region_fft_weight=5e-5)))
# withregion_FFT_KL (``:620-636``): G = ½(adv + 1e-4·[1e-2·REG_kl] + patch¼
# + temp + pix) -> region weight ½·1e-6; the plain patch FFT is computed but
# NEVER added to loss_G (dead code) -> fft_mode off here.
register(ExperimentConfig(name="fft_patch_region_kl", loss=_loss(
    fft_mode="off", patch_grid=2, triplet_weight=0.5,
    region_fft="kl", region_fft_weight=5e-7)))
# Debiased family V1–V7. Weight bundles follow each script's loss_G line:
# V1 ``debiased.py:572``  G = adv + lpips + patch_trip + label + 0.10·temp + 0.001·FFT
# V2 ``_V2.py:582``       G = adv + label + lpips + 0.10·temp + 0.001·FFT
# V3 ``_V3.py:583``       = V2 with 10× ethnicity CE inside the label loss
# V4 ``_V4.py:691``       = V2 + regional CNNs (tot_ethn) + triplet-FFT form
# V5 ``_V5.py:670``       = V4 + pixel patch triplet
# V6 ``_V6.py:671``       G = ½·(adv + tot_ethn + 0.001·FFT + patch + temp + lpips)
# V7 ``_V7.py:672``       = V6 with the CNN heads chained to D's optimizer —
#                          which (zero grads at D-step) leaves them frozen.
_DB = dict(fft_mode="patch", fft_grid=2, conditional=True,
           adv_weight=1.0, lpips_weight=1.0, ce_weight=1.0,
           temp_weight=0.10, fft_weight=0.001)
register(ExperimentConfig(name="fft_patch_debiased_v1",
    loss=_loss(patch_grid=2, triplet_weight=1.0, debias_version=1, **_DB)))
register(ExperimentConfig(name="fft_patch_debiased_v2",
    loss=_loss(patch_grid=0, debias_version=2, **_DB)))
register(ExperimentConfig(name="fft_patch_debiased_v3",
    loss=_loss(patch_grid=0, debias_version=3, **_DB)))
register(ExperimentConfig(name="fft_patch_debiased_v4",
    loss=_loss(patch_grid=0, debias_version=4, **_DB)))
register(ExperimentConfig(name="fft_patch_debiased_v5",
    loss=_loss(patch_grid=2, triplet_weight=1.0, debias_version=5, **_DB)))
_DB_HALF = dict(fft_mode="patch", fft_grid=2, conditional=True,
                adv_weight=0.5, lpips_weight=0.5, ce_weight=0.5,
                temp_weight=0.5, fft_weight=0.002,
                # V6/V7's fft_loss SUMS the 4 per-patch L1s (``_V7.py:411-413``
                # — V1–V3 ¼-average them) and loss_G halves it with 0.001
                # inside: on our merged-mean form that is 0.5·0.001·4 = 0.002
                patch_grid=2, triplet_weight=0.5)
register(ExperimentConfig(name="fft_patch_debiased_v6",
    loss=_loss(debias_version=6, **_DB_HALF)))
register(ExperimentConfig(name="fft_patch_debiased",
    loss=_loss(debias_version=7, **_DB_HALF)))
# Gaussian-mask experiment (TFCGAN_multigpu_patchFFT_experiment.py): saliency
# mask as a 4th G input channel + L1 mask loss; G loss = 0.5·adv + 0.5·lpips
# + 0.5·triplet + 0.5·temp + 0.001·FFT + 0.5·mask (``:587``)
register(ExperimentConfig(
    name="fft_patch_mask",
    loss=_loss(fft_mode="patch", fft_grid=2, patch_grid=2,
               # experiment.py's fft_loss also SUMS the 4 per-patch L1s
               # (``:335-337``) -> 0.001·4 on our merged-mean form
               triplet_weight=0.5, fft_weight=0.004, use_mask=True),
))
# favtgan lineage (TFC-GAN-FFT/src/) — pre-FFT base models and ablations
register(ExperimentConfig(name="triptemp_base", loss=_loss(patch_grid=2, **_FAV)))
register(ExperimentConfig(name="triptemp_16p", loss=_loss(patch_grid=4, **_FAV)))
register(ExperimentConfig(
    name="favtgan_l1",
    loss=_loss(fft_mode="off", patch_grid=2, temp_mode="l1",
               adv_weight=1.0, lpips_weight=1.0, temp_weight=1.0),
))
register(ExperimentConfig(
    name="favtgan_tempmap",
    loss=_loss(fft_mode="off", patch_grid=2, temp_mode="tempmap",
               adv_weight=1.0, lpips_weight=1.0, temp_weight=1.0),
))
# balanced dual-dataset training (ED = Eurecom+Devcom, EA = Eurecom+ADAS):
# same recipe; the data pipeline builds a BalancedMixture from the second
# root, which the user must supply at launch (`cli train --extra-root`) —
# the reference hard-codes both roots per script
# (favtgan_..._TripTemp_ED.py:349-374).
_BALANCED = {"needs_extra_root": True}
register(ExperimentConfig(
    name="triptemp_ed",
    loss=_loss(fft_mode="off", patch_grid=2, adv_weight=1.0, lpips_weight=1.0,
               temp_weight=1.0),
    extra=_BALANCED,
))
register(ExperimentConfig(
    name="triptemp_ea",
    loss=_loss(fft_mode="off", patch_grid=2, adv_weight=1.0, lpips_weight=1.0,
               temp_weight=1.0),
    extra=_BALANCED,
))
# 16-patch balanced variants (favtgan_..._TripTemp_ED_16Patch.py / _EA_16Patch.py)
register(ExperimentConfig(
    name="triptemp_ed_16p",
    loss=_loss(fft_mode="off", patch_grid=4, adv_weight=1.0, lpips_weight=1.0,
               temp_weight=1.0),
    extra=_BALANCED,
))
register(ExperimentConfig(
    name="triptemp_ea_16p",
    loss=_loss(fft_mode="off", patch_grid=4, adv_weight=1.0, lpips_weight=1.0,
               temp_weight=1.0),
    extra=_BALANCED,
))
register(ExperimentConfig(name="ablation_nopatch", loss=_loss(patch_grid=0, **_FAV)))
register(ExperimentConfig(name="ablation_noperc", loss=_loss(patch_grid=4, use_lpips=False, **_FAV)))
register(ExperimentConfig(name="ablation_notemp", loss=_loss(patch_grid=4, use_temp=False, **_FAV)))
# STN family (TFC-STN/). perceptual="auto": LPIPS when converted weights are
# supplied, the fixed msrecon anchor otherwise (random-weight LPIPS is noise
# that collapses registration — BASELINE.md round-1 measurement).
register(ExperimentConfig(
    name="stn_newmodel3", recipe="stn",
    optim=OptimConfig(lr=1e-4),
    loss=_loss(perceptual="auto"),
    train=TrainConfig(n_epochs=100, sample_interval=50, checkpoint_interval=50),
))
register(ExperimentConfig(
    name="stn_dark_visible", recipe="stn", optim=OptimConfig(lr=1e-4),
    # fft_weight 2.0: the variant adds the UNhalved amp+pha FFT sum
    # (``Eur_DarkVisible.py:700-715``) and fft_l1_loss returns ½(amp+pha)
    loss=_loss(perceptual="auto", fft_weight=2.0),
    extra={"variant": "dark_visible"},
))
register(ExperimentConfig(
    name="stn_b2a", recipe="stn", optim=OptimConfig(lr=1e-4),
    loss=_loss(perceptual="auto", fft_weight=2.0),
    # B2A trains thermal->visible: the loop swaps the loaded pair
    # (``NewModel3_B2A.py:644-645``)
    data=DataConfig(direction="BtoA"),
    extra={"variant": "b2a"},
))
# Baselines
register(ExperimentConfig(
    name="cyclegan", recipe="cyclegan",
    optim=OptimConfig(schedule="linear_decay", decay_start_epoch=100),
    train=TrainConfig(n_epochs=200),
))
# lr 2e-5 "from ThermalGAN paper" (``ThermalGAN_noAMP.py:29``, all variants)
register(ExperimentConfig(name="thermalgan", recipe="thermalgan",
                          optim=OptimConfig(lr=2e-5),
                          train=TrainConfig(n_epochs=200)))
# ThermalGAN2.py: G1 with train-mode BatchNorm (the positional eps=0.8 quirk)
register(ExperimentConfig(name="thermalgan_bn", recipe="thermalgan",
                          optim=OptimConfig(lr=2e-5),
                          train=TrainConfig(n_epochs=200),
                          extra={"g1_norm": "batch"}))
# NeMAR default lr_policy='linear': constant for niter=100 epochs, then
# decay to zero over niter_decay=100 (``train_options.py:39-48``)
register(ExperimentConfig(
    name="nemar", recipe="nemar",
    optim=OptimConfig(schedule="linear_decay", decay_start_epoch=100),
    train=TrainConfig(n_epochs=200),
))
register(ExperimentConfig(
    name="tfc_diff", recipe="diffusion",
    optim=OptimConfig(lr=1e-3, b1=0.9, b2=0.999),
    data=DataConfig(image_size=128),
))
register(ExperimentConfig(
    name="tfc_diff_label", recipe="diffusion",
    optim=OptimConfig(lr=1e-3, b1=0.9, b2=0.999),
    data=DataConfig(image_size=128),
    extra={"variant": "label"},
))
register(ExperimentConfig(
    name="tfc_diff_hybrid", recipe="diffusion",
    optim=OptimConfig(lr=1e-3, b1=0.9, b2=0.999),
    data=DataConfig(image_size=128),
    extra={"variant": "hybrid"},
))


def get_experiment(name: str) -> ExperimentConfig:
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; known: {sorted(EXPERIMENTS)}")
    return EXPERIMENTS[name]
