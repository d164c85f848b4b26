"""The alternating G/D train step and the loop that runs it, port of
``tfcgan_tpu.train.trainer`` (one device).

One step, in the order of the JAX step: the schedule's learning rate into both
Adams (not under ``plateau``, whose controller sets it between epochs); one
spectral power iteration over every discriminator head of ``recipe.D``
(per-step cadence); then, for a ``g_first`` recipe (the
default), the G phase (G forward, D(fake), D(real), G loss) with gradients to
G's parameters only (for the STN family: G1, G2 and the STN), D frozen for the
phase; the G Adam step; the D phase on the detached fake of the same G
forward, against the pre-update D; the D Adam step.

A recipe with ``update_order = "d_first"`` (NeMAR) gets the reference's other
interleaving: the generator side's forward once, with its graph; the D phase
on its detached outputs and the D Adam step; then the generator loss on the
same forward through the **updated** D, frozen, and the generator Adam step.
(The JAX step runs that forward twice with the same parameters; running it
once and keeping the graph across the D update gives the same numbers.)

A recipe whose ``D`` has no parameters (the TFC-Diff family) has no D phase:
its constant ``d_loss`` is only reported, as the JAX step reports ``loss_D = 0``
for its empty tree.

The step's random draws come from ``draw_fn(state, batch)``, by default the
recipe's draws on ``state.generator``.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections.abc import Callable, Iterable

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.data.prefetch import is_device_batch
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.train.state import (TrainState, create_state, learning_rate,
                                          set_learning_rate)


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No parameter gradient of ``module`` is computed inside the block."""
    module.requires_grad_(False)
    try:
        yield
    finally:
        module.requires_grad_(True)


def make_train_step(cfg: ExperimentConfig, recipe) -> Callable:
    """``train_step(state, batch, draws) -> metrics``; updates ``state`` in place."""
    order = getattr(recipe, "update_order", "g_first")
    if order not in ("g_first", "d_first"):
        raise ValueError(f"unknown update_order {order!r}")
    per_forward = cfg.extra.get("spectral_cadence", "per_step") == "per_forward"
    if per_forward and not getattr(recipe, "supports_per_forward_spectral", False):
        raise ValueError(f"recipe {getattr(recipe, 'name', recipe)!r} does not implement "
                         "spectral_cadence='per_forward'")
    if per_forward and order == "d_first":
        raise ValueError("spectral_cadence='per_forward' requires g_first order")
    scheduled = cfg.optim.schedule != "plateau"  # plateau: the lr is set between epochs

    def d_phase(state: TrainState, batch: dict, aux: dict) -> dict:
        loss_d, d_metrics = recipe.d_loss(batch, aux)
        if state.opt_d is None:  # no discriminator: nothing to differentiate or step
            return d_metrics
        state.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        state.opt_d.step()
        return d_metrics

    def g_phase(state: TrainState, batch: dict, draws, *forward) -> tuple[dict, dict]:
        with _frozen(recipe.D):
            loss_g, aux, g_metrics = recipe.g_loss(batch, draws, *forward)
            state.opt_g.zero_grad(set_to_none=True)
            loss_g.backward()
        state.opt_g.step()
        return aux, g_metrics

    def train_step(state: TrainState, batch: dict, draws) -> dict[str, torch.Tensor]:
        if scheduled:
            set_learning_rate(state, learning_rate(cfg, state.step))
        if not per_forward:
            spectral_power_iteration(recipe.D, order="vu")
        if order == "d_first":
            forward = recipe.forward(batch, draws)
            d_metrics = d_phase(state, batch, recipe.d_aux(forward))
            _, g_metrics = g_phase(state, batch, draws, forward)
        else:
            aux, g_metrics = g_phase(state, batch, draws)
            d_metrics = d_phase(state, batch, aux)
        state.step += 1
        return {k: v.detach() for k, v in {**g_metrics, **d_metrics}.items()}

    return train_step


def assert_finite(metrics: dict, step: int) -> None:
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not math.isfinite(v)]
    if bad:
        raise FloatingPointError(
            f"non-finite metrics at step {step}: {bad} = {[values[k] for k in bad]}")


class Trainer:
    """Runs the step on the recipe's device. ``draw_fn(state, batch)`` gives
    each step's draws (default: ``recipe.draw(state.generator, batch)``);
    ``logger`` is anything with ``write(dict)``."""

    def __init__(self, cfg: ExperimentConfig, recipe, draw_fn: Callable | None = None,
                 logger=None):
        self.cfg, self.recipe, self.logger = cfg, recipe, logger
        self.draw_fn = draw_fn or (lambda state, batch: recipe.draw(state.generator, batch))
        self._step_fn = make_train_step(cfg, recipe)
        self.last_metrics = None

    def init_state(self, seed: int) -> TrainState:
        return create_state(self.cfg, self.recipe, seed)

    def step(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        """One step on ``batch`` ({"A", "B", "T_B"[, "LAB"]}, numpy or
        tensors; the images as float32, the class labels as integers); returns
        the metrics as 0-dim tensors on the device. A batch already on the
        recipe's device (``data.prefetch.is_device_batch``) is used as it is."""
        dev = self.recipe.device
        if not is_device_batch(batch, dev):
            images = {k: torch.as_tensor(v).to(dev, torch.float32) for k, v in batch.items()
                      if k in ("A", "B", "T_B")}
            labels = {k: torch.as_tensor(v).to(dev, torch.int64) for k, v in batch.items()
                      if k == "LAB"}
            batch = {**images, **labels}
        metrics = self._step_fn(state, batch, self.draw_fn(state, batch))
        self.last_metrics = metrics  # on the device; a read syncs
        return metrics

    def fit(self, state: TrainState, batches: Iterable, num_steps: int | None = None,
            log_every: int | None = None, sample_hook: Callable | None = None,
            sample_every: int | None = None, check_finite: bool = False,
            pool=None) -> TrainState:
        """Steps over ``batches`` (at most ``num_steps``); ``check_finite``
        raises on a NaN/Inf metric; every ``log_every`` steps the metrics go to
        the logger; ``sample_hook(state, step)`` runs after every step whose
        count is a multiple of ``sample_every`` (default
        ``cfg.train.sample_interval``: the reference's ``sample_images``).
        With ``pool`` (a ``data.pool.DevicePool``) ``batches`` yields index
        arrays, which ``pool.batch`` assembles on the device."""
        log_every = log_every or self.cfg.train.log_interval
        sample_every = sample_every or self.cfg.train.sample_interval
        t0 = time.time()
        for i, batch in enumerate(batches):
            if num_steps is not None and i >= num_steps:
                break
            if pool is not None:
                batch = pool.batch(batch)
            metrics = self.step(state, batch)
            if check_finite:
                assert_finite(metrics, state.step)
            if self.logger is not None and i % log_every == 0:
                self.logger.write({**{k: float(v) for k, v in metrics.items()},
                                   "step": state.step, "wall_s": time.time() - t0})
            if sample_hook is not None and state.step % sample_every == 0:
                sample_hook(state, state.step)
        return state
