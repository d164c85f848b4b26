"""The training state of the port, after ``tfcgan_tpu.train.state``.

A plain dataclass: the step count, the ``torch.Generator`` the step's draws
come from, the recipe's modules (their float32 parameters and the spectral
u/v buffers; the frozen LPIPS and, for the debiased V4-V7, the regional
CNNs, ``cnns``; ``frozen``, any other frozen module of the recipe, as
ThermalGAN's detached stage-1 discriminator), ``extra``, the recipe-owned
state on the device (CycleGAN's replay buffers and their counts, the JAX
state's ``extra``: ``recipe.initial_extra()``), and the two Adams (``opt_d``
is None for a recipe without a discriminator: ``D`` has no parameters, as in
the TFC-Diff family). G's Adam
steps G and whatever loss-network parameters train with it (the V4-V6
regional classifier heads: ``g_parameters``).
``torch.optim.Adam(lr, betas=(b1, b2), eps=1e-8)`` computes optax's ``adam``
update: lr * m_hat / (sqrt(v_hat) + eps), eps outside the root.

``learning_rate(cfg, step)`` is the closed-form schedule of the update that
follows ``step`` completed ones (the first update is ``step`` 0), on the
fractional epoch ``step / steps_per_epoch`` as optax evaluates it: per update,
not once an epoch. The trainer writes it into both Adams before each step,
except under ``plateau``: there the lr lives in the Adams' ``param_groups``
(as it lives in the JAX opt state's ``hyperparams``), and
``ReduceLROnPlateau`` sets it between epochs through ``set_learning_rate``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig


@dataclasses.dataclass
class TrainState:
    step: int
    generator: torch.Generator
    G: nn.Module
    D: nn.Module
    lpips: nn.Module | None
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam | None
    cnns: nn.Module | None = None
    frozen: nn.Module | None = None
    extra: dict | None = None


SCHEDULES = ("constant", "linear_decay", "step", "cosine", "plateau")


def learning_rate(cfg: ExperimentConfig, step: int) -> float:
    """The lr of the update after ``step`` completed ones.

    ``linear_decay`` (CycleGAN's LambdaLR): lr * (1 - max(0, epoch - decay) /
    (n_epochs - decay)), floored at 0; ``step``: lr * 0.1 ** floor(epoch /
    decay_start_epoch); ``cosine``: lr * 0.5 * (1 + cos(pi * epoch /
    n_epochs)); ``plateau``: lr, the value the Adams start from (the
    controller rewrites it between epochs)."""
    o = cfg.optim
    if o.schedule in ("constant", "plateau"):
        return o.lr
    epoch = step / (cfg.train.steps_per_epoch or 1)
    n, dec = cfg.train.n_epochs, o.decay_start_epoch
    if o.schedule == "linear_decay":
        return o.lr * max(0.0, 1.0 - max(0.0, epoch - dec) / max(n - dec, 1))
    if o.schedule == "step":
        return o.lr * 0.1 ** math.floor(epoch / max(dec, 1))
    if o.schedule == "cosine":
        return o.lr * 0.5 * (1.0 + math.cos(math.pi * epoch / n))
    raise ValueError(f"unknown lr schedule {o.schedule!r}; known: {SCHEDULES}")


class ReduceLROnPlateau:
    """NeMAR's 'plateau' mode, port of ``tfcgan_tpu.train.state.ReduceLROnPlateau``:
    torch ``ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
    patience=5)`` on the host. ``step(metric)`` is called once an epoch and
    returns the lr to install with ``set_learning_rate``. An epoch improves
    when ``metric < best * (1 - threshold)``; after more than ``patience``
    epochs without improvement lr <- max(lr * factor, min_lr), and ``best``
    is kept."""

    def __init__(self, lr: float, factor: float = 0.2, patience: int = 5,
                 threshold: float = 0.01, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr


def set_learning_rate(state: "TrainState", lr: float) -> None:
    """Write ``lr`` into both Adams (the one there is, without a D)."""
    for opt in (state.opt_g, state.opt_d):
        for group in opt.param_groups if opt is not None else ():
            group["lr"] = lr


def g_parameters(recipe) -> dict[str, nn.Parameter]:
    """What G's Adam steps, by name: ``G.<name>`` for G's parameters and
    ``cnns.<name>`` for the trainable ones of ``recipe.cnns`` (the debiased
    V4-V6 regional heads; their backbones, and all of V7's, are frozen)."""
    named = {f"G.{k}": p for k, p in recipe.G.named_parameters()}
    cnns = getattr(recipe, "cnns", None)
    if cnns is not None:
        named.update({f"cnns.{k}": p for k, p in cnns.named_parameters() if p.requires_grad})
    return named


def make_optimizers(cfg: ExperimentConfig, recipe, step: int = 0
                    ) -> tuple[torch.optim.Adam, torch.optim.Adam | None]:
    """Adam on ``g_parameters`` and on D's parameters, at the schedule's lr
    for ``step``; None for a D without parameters (torch's Adam refuses an
    empty list)."""
    o = cfg.optim
    lr = learning_rate(cfg, step)
    return tuple(torch.optim.Adam(params, lr=lr, betas=(o.b1, o.b2), eps=1e-8)
                 if params else None
                 for params in (list(g_parameters(recipe).values()),
                                list(recipe.D.parameters())))


def create_state(cfg: ExperimentConfig, recipe, seed: int, draw: bool = True) -> TrainState:
    """Weights drawn on the CPU from ``seed`` (the same on every device), step
    draws from a generator on the recipe's device seeded with ``seed``, fresh
    Adams and the recipe's initial ``extra``. ``draw=False`` leaves the
    weights as they are, for a checkpoint about to overwrite them."""
    if draw:
        recipe.init(torch.Generator().manual_seed(seed))
    opt_g, opt_d = make_optimizers(cfg, recipe)
    return TrainState(step=0, generator=torch.Generator(recipe.device).manual_seed(seed),
                      G=recipe.G, D=recipe.D, lpips=recipe.lpips, opt_g=opt_g, opt_d=opt_d,
                      cnns=getattr(recipe, "cnns", None), frozen=getattr(recipe, "frozen", None),
                      extra=recipe.initial_extra() if hasattr(recipe, "initial_extra") else None)
