"""The alternating G/D train step and the loop that runs it, port of
``tfcgan_tpu.train.trainer`` (one device).

One step, in the order of the JAX step: the schedule's learning rate into both
Adams (not under ``plateau``, whose controller sets it between epochs); one
spectral power iteration over every discriminator head of ``recipe.D``
(per-step cadence); then, for a ``g_first`` recipe (the
default), the G phase (G forward, D(fake), D(real), G loss) with gradients to
G's parameters only (for the STN family: G1, G2 and the STN), D frozen for the
phase; the G Adam step; the D phase on the detached fake of the same G
forward, against the pre-update D; the D Adam step. A recipe with a
``pre_d(extra, aux, draws)`` hook (CycleGAN's replay buffers) gets it between
the two phases, where the JAX step calls it, in either order: it returns the
new recipe-owned state, kept in ``state.extra``, and the D phase's ``aux``.

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

With a data ``mesh`` (``parallel.make_mesh``: the ``torch.distributed``
world, one process a card) the step is data-parallel, as the JAX step is
over its mesh: each rank takes its equal share of the global batch
(``parallel.shard_batch``; a batch already on the device is taken as this
rank's share), the draws are made for the global batch on every rank from
generators kept equal and cut to the rank's samples
(``parallel.shard_draws``), each phase's gradients are averaged over the
ranks through one coalesced flat buffer after its ``backward`` and before its
Adam step (NCCL on the cards), and the metrics are averaged too, so that the
logged numbers are the global batch's. The step runs inside
``parallel.loss_mesh``: the ops that couple the samples of a batch read the
global batch there. D runs several times a phase and is frozen through the G
phase, so the gradients are reduced by hand and not by the DDP wrapper.

On a (data, tensor) mesh (``make_mesh(tensor=t)``, or ``cfg.mesh.tensor``)
the ranks of one data share hold slices of the sharded parameters and of
their Adam moments (``parallel.place_state``) and run the same samples and
draws: a sharded parameter's gradient is averaged over the data group (the
ranks that hold the same slice), a replicated one's over the whole world
(equal over a tensor group up to the order of float32 sums, so the mean
keeps the replicas bit for bit equal), the metrics over the data group.

On a mesh with a spatial axis (``make_mesh(spatial=s)``, or
``cfg.mesh.spatial``) each rank of a data share holds its rows of the
share's images (``shard_batch``, or a device batch cut so by the pool or
the prefetcher), the dropout keep-masks are cut to its rows, and the step
runs inside ``parallel.spatial.image_rows``, which tells the recipe the
images' global height (read from the host batch; a device batch holds
rows of ``cfg.data.image_size``-row images). Each rank's loss is its share
(the axis's rule, ``parallel.spatial``), so each gradient is summed over
the spatial group and averaged over the data group (``all_reduce_mean_``),
and so are the metrics. Every registry entry runs there. Without a ``mesh``
argument the trainer builds one from ``cfg.mesh`` when it asks for more than
one process (``num_devices`` > 1, ``tensor`` > 1 or ``spatial`` > 1), as
the JAX trainer does.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections.abc import Callable, Iterable

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.data.prefetch import is_device_batch, stage_batch
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.parallel.mesh import (SPATIAL_KEYS, Mesh, all_reduce_mean_, loss_mesh,
                                            make_mesh, place_state, shard_batch, shard_draws)
from tfcgan_tpu_torch.parallel.spatial import image_rows
from tfcgan_tpu_torch.parallel.tensor import full_tensors, tensor_dim
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


class CollectiveStats:
    """What the data axis moved: gradient all-reduces (one a phase) and the
    bytes of each phase's flat buffers."""

    def __init__(self):
        self.grad_allreduces = 0
        self.flat_bytes: dict[str, int] = {}


def make_train_step(cfg: ExperimentConfig, recipe, mesh: Mesh | None = None,
                    stats: CollectiveStats | None = None) -> Callable:
    """``train_step(state, batch, draws) -> metrics``; updates ``state`` in
    place. With ``mesh`` each phase's gradients are averaged over its ranks
    before the Adam step (counted in ``stats``)."""
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
    pre_d = getattr(recipe, "pre_d", None)

    def before_d(state: TrainState, aux: dict, draws) -> dict:
        if pre_d is None:
            return aux
        state.extra, aux = pre_d(state.extra, aux, draws)
        return aux

    def average_grads(opt: torch.optim.Adam, phase: str) -> None:
        if mesh is None:
            return
        params = [p for group in opt.param_groups for p in group["params"]
                  if p.grad is not None]
        nbytes = all_reduce_mean_([p.grad for p in params if tensor_dim(p) is not None], mesh)
        nbytes += all_reduce_mean_([p.grad for p in params if tensor_dim(p) is None], mesh,
                                   over="world")
        if stats is not None and nbytes:
            stats.grad_allreduces += 1
            stats.flat_bytes[phase] = nbytes

    def d_phase(state: TrainState, batch: dict, aux: dict) -> dict:
        loss_d, d_metrics = recipe.d_loss(batch, aux)
        if state.opt_d is None:  # no discriminator: nothing to differentiate or step
            return d_metrics
        state.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        average_grads(state.opt_d, "D")
        state.opt_d.step()
        return d_metrics

    def g_phase(state: TrainState, batch: dict, draws, *forward) -> tuple[dict, dict]:
        with _frozen(recipe.D):
            loss_g, aux, g_metrics = recipe.g_loss(batch, draws, *forward)
            state.opt_g.zero_grad(set_to_none=True)
            loss_g.backward()
        average_grads(state.opt_g, "G")
        state.opt_g.step()
        return aux, g_metrics

    def train_step(state: TrainState, batch: dict, draws) -> dict[str, torch.Tensor]:
        if scheduled:
            set_learning_rate(state, learning_rate(cfg, state.step))
        if not per_forward:
            spectral_power_iteration(recipe.D, order="vu")
        if order == "d_first":
            forward = recipe.forward(batch, draws)
            d_metrics = d_phase(state, batch, before_d(state, recipe.d_aux(forward), draws))
            _, g_metrics = g_phase(state, batch, draws, forward)
        else:
            aux, g_metrics = g_phase(state, batch, draws)
            d_metrics = d_phase(state, batch, before_d(state, aux, draws))
        state.step += 1
        metrics = {k: v.detach() for k, v in {**g_metrics, **d_metrics}.items()}
        if mesh is not None and mesh.replica_group is not None:  # the global batch's means
            names = sorted(metrics)
            values = [metrics[k].float().reshape(1) for k in names]
            all_reduce_mean_(values, mesh)
            metrics = {k: v.reshape(()) for k, v in zip(names, values)}
        return metrics

    def step_on_mesh(state: TrainState, batch: dict, draws) -> dict[str, torch.Tensor]:
        with loss_mesh(mesh):
            return train_step(state, batch, draws)

    return train_step if mesh is None else step_on_mesh


def _log_histograms(hist_logger, state: TrainState) -> None:
    """G's and D's weights and gradients, sharded ones gathered (a collective
    over their tensor group); written by ``hist_logger``, when given."""
    from tfcgan_tpu_torch.train.histograms import tree_histograms

    modules = {"G": state.G, "D": state.D}
    weights = {m: full_tensors(mod, dict(mod.named_parameters())) for m, mod in modules.items()}
    grads = {m: full_tensors(mod, {k: torch.zeros_like(p) if p.grad is None else p.grad
                                   for k, p in mod.named_parameters()})
             for m, mod in modules.items()}
    if hist_logger is not None:
        hist_logger.write(state.step, "weights", tree_histograms(weights))
        hist_logger.write(state.step, "grads", tree_histograms(grads))


def assert_finite(metrics: dict, step: int) -> None:
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not math.isfinite(v)]
    if bad:
        raise FloatingPointError(
            f"non-finite metrics at step {step}: {bad} = {[values[k] for k in bad]}")


class Trainer:
    """Runs the step on the recipe's device. ``draw_fn(state, batch)`` gives
    each step's draws (default: ``recipe.draw(state.generator, batch)``);
    ``logger`` is anything with ``write(dict)``; ``mesh`` a data or (data[,
    spatial][, tensor]) mesh (``parallel.make_mesh``); None builds it from
    ``cfg.mesh`` where that asks for more than one process, else runs one
    process. Under a mesh, ``draw_fn`` sees the global batch's shapes (its
    tensors are on the meta device) and its draws are cut to this rank's
    samples (and rows)."""

    def __init__(self, cfg: ExperimentConfig, recipe, draw_fn: Callable | None = None,
                 logger=None, mesh: Mesh | None = None):
        m = cfg.mesh
        if mesh is None and ((m.num_devices or 1) > 1 or m.tensor > 1 or m.spatial > 1):
            mesh = make_mesh(m.num_devices, spatial=m.spatial, tensor=m.tensor,
                             device=recipe.device)
        self.cfg, self.recipe, self.logger, self.mesh = cfg, recipe, logger, mesh
        self.draw_fn = draw_fn or (lambda state, batch: recipe.draw(state.generator, batch))
        self.stats = CollectiveStats()
        self._step_fn = make_train_step(cfg, recipe, mesh, self.stats)
        self.last_metrics = None

    def init_state(self, seed: int, draw: bool = True) -> TrainState:
        """A fresh state; under a mesh its drawn weights and draw generator are
        broadcast from rank 0 and, on a tensor mesh, sharded
        (``parallel.place_state``). With ``draw=False`` the state is left
        unplaced: restore a checkpoint into it, then ``place_state``."""
        state = create_state(self.cfg, self.recipe, seed, draw)
        if draw and self.mesh is not None:
            place_state(state, self.mesh)
        return state

    def step(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        """One step on ``batch`` ({"A", "B", "T_B"[, "LAB"][, "LAB3"]}, numpy
        or tensors; the images as float32, the class labels as integers); returns
        the metrics as 0-dim tensors on the device. A batch already on the
        recipe's device (``data.prefetch.is_device_batch``) is used as it is;
        under a mesh such a batch is this rank's share, any other the global
        batch, which ``parallel.shard_batch`` cuts."""
        dev, mesh = self.recipe.device, self.mesh
        rows = None
        if not is_device_batch(batch, dev):
            if mesh is not None:
                if mesh.spatial is not None:
                    rows = mesh.image_rows(int(batch["A"].shape[1]))
                batch = shard_batch(batch, mesh)
            batch = stage_batch(batch, dev)
        elif mesh is not None and mesh.spatial is not None:
            # a device batch (the pool's, the prefetcher's) holds this rank's
            # rows of images of the run's size: no collective to learn it
            rows = mesh.image_rows(self.cfg.data.image_size)
            if batch["A"].shape[1] != rows.n:
                raise ValueError(
                    f"a device batch on a spatial mesh holds this rank's rows of "
                    f"{self.cfg.data.image_size}-row images ({rows.n} rows), got "
                    f"{batch['A'].shape[1]}; pass other sizes as a host batch")
        if mesh is None:
            draws = self.draw_fn(state, batch)
        else:
            shapes = {}
            for k, v in batch.items():
                shape = [v.shape[0] * mesh.data_size, *v.shape[1:]]
                if rows is not None and k in SPATIAL_KEYS:
                    shape[1] = rows.h
                shapes[k] = torch.empty(shape, dtype=v.dtype, device="meta")
            draws = shard_draws(self.draw_fn(state, shapes), mesh)
        with image_rows(rows):
            metrics = self._step_fn(state, batch, draws)
        self.last_metrics = metrics  # on the device; a read syncs
        return metrics

    def fit(self, state: TrainState, batches: Iterable, num_steps: int | None = None,
            log_every: int | None = None, sample_hook: Callable | None = None,
            sample_every: int | None = None, check_finite: bool = False,
            hist_logger=None, hist_every: int | None = None, pool=None) -> TrainState:
        """Steps over ``batches`` (at most ``num_steps``); ``check_finite``
        raises on a NaN/Inf metric; every ``log_every`` steps the metrics go to
        the logger; ``sample_hook(state, step)`` runs after every step whose
        count is a multiple of ``sample_every`` (default
        ``cfg.train.sample_interval``: the reference's ``sample_images``).
        ``hist_logger`` (a ``train.histograms.HistogramLogger``) records, after
        every loop step ``i`` with ``i % hist_every == 0``, the histograms of
        G's and D's weights after the update and of the step's gradients (G's
        from the G phase, D's from the D phase: still in ``.grad``, which the
        next step zeroes; a parameter without one counts as a zero gradient).
        With ``pool`` (a ``data.pool.DevicePool``) ``batches`` yields index
        arrays, which ``pool.batch`` assembles on the device. Under a mesh only
        rank 0 logs, samples and records histograms; on a tensor mesh the
        other ranks of its tensor group run the sample hook too (the hook
        gathers G's slices, and writes on rank 0 only) and join the
        histograms' gathers."""
        log_every = log_every or self.cfg.train.log_interval
        sample_every = sample_every or self.cfg.train.sample_interval
        mesh, logger = self.mesh, self.logger
        if mesh is not None and mesh.rank != 0:
            logger = hist_logger = None
            if mesh.tensor is None or not mesh.leads_tensor_group:
                sample_hook, hist_every = None, None
        elif hist_logger is None and (mesh is None or mesh.tensor is None):
            hist_every = None
        t0 = time.time()
        for i, batch in enumerate(batches):
            if num_steps is not None and i >= num_steps:
                break
            if pool is not None:
                batch = pool.batch(batch)
            metrics = self.step(state, batch)
            if hist_every and i % hist_every == 0:
                _log_histograms(hist_logger, state)
            if check_finite:
                assert_finite(metrics, state.step)
            if logger is not None and i % log_every == 0:
                logger.write({**{k: float(v) for k, v in metrics.items()},
                                   "step": state.step, "wall_s": time.time() - t0})
            if sample_hook is not None and state.step % sample_every == 0:
                sample_hook(state, state.step)
        return state
