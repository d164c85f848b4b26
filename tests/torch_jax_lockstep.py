"""The port's fft_glo Trainer in lockstep with the JAX ``Trainer``, float32
on the CPU: the shared helpers of ``test_torch_train.py``,
``test_torch_trajectory_drift.py`` and ``tools/measure_drift_torch.py``.

The JAX state is built from numpy draws (G and D kernels normal(0, 0.02),
spectral u/v after 5 power iterations, LPIPS lecun-scaled normal convs and
uniform(0, 0.1) lin weights) and carried into the port by
``bridge.train_state_from_flax``. The port's step draws are rebuilt from the
JAX key as the JAX step draws them: ``fold_in(rng, step)`` -> ``split`` ->
``split(g_rng, 5)`` -> ``randint`` (patch negatives) and the ColorJitter
draws of ``ops/color.py``. G dropout is off (``deterministic_g``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_losses import jax_jitter_draws
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.train.state import GANTrainState, make_optimizers as jax_make_optimizers
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.tfcgan import StepDraws
from tfcgan_tpu_torch.train.trainer import Trainer

TERMS = ("g_adv", "g_triplet", "g_temp", "g_lpips", "g_fft", "loss_G", "loss_D")
DRIFT_TERMS = ("loss_G", "loss_D")  # what run_lockstep records


def _cfg(size, batch, **extra):
    cfg = get_experiment("fft_glo")
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={"deterministic_g": True, **extra})


def drift_cfg(size, batch):
    """``tests/test_parity_trajectory.py::run_lockstep``'s configuration:
    float32, no patch triplet, no temperature, no LPIPS, the global FFT of
    the smooth luma, deterministic G (the loss config otherwise at its
    defaults, as there)."""
    cfg = _cfg(size, batch)
    return cfg.replace(loss=cfg.loss.__class__(patch_grid=0, use_temp=False, use_lpips=False,
                                               fft_mode="global", fft_quantize="smooth"))


def _jax_state(cfg, seed=0):
    """A JAX GANTrainState at step 0 from numpy draws (no flax init run)."""
    recipe = jax_build_recipe(cfg)
    key = jax.random.PRNGKey(seed)
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size)
    shapes = jax.eval_shape(recipe.init, key, batch)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "lin" in name:
            return rng.uniform(0, 0.1, s.shape).astype(np.float32)
        if "bias" in name:
            return np.zeros(s.shape, np.float32)
        if "lpips" in name:
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (rng.randn(*s.shape) * 0.02).astype(np.float32)

    def unit(s):
        v = rng.randn(*s.shape)
        return (v / np.linalg.norm(v)).astype(np.float32)

    pieces = {k: jax.tree_util.tree_map_with_path(draw, shapes[k])
              for k in ("g_params", "d_params", "frozen")}
    spectral = jax.tree.map(unit, shapes["spectral"])
    for _ in range(5):
        spectral = jax_power_iteration(pieces["d_params"], spectral)
    g_tx, d_tx = jax_make_optimizers(cfg)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.split(key)[1],
                          g_params=pieces["g_params"], d_params=pieces["d_params"],
                          spectral=jax.device_get(spectral), frozen=pieces["frozen"],
                          g_opt_state=g_tx.init(pieces["g_params"]),
                          d_opt_state=d_tx.init(pieces["d_params"]))
    return recipe, state


def jax_step_draws(rng, step: int, grid: int) -> StepDraws:
    """The patch negatives and ColorJitter draws of the JAX step ``step``."""
    g_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, k_patch, k_temp, _, _ = jax.random.split(g_rng, 5)
    neg = np.array(jax.random.randint(k_patch, (grid * grid,), 0, grid * grid))
    factors, order = jax_jitter_draws(k_temp)
    return StepDraws(torch.from_numpy(neg).long(), torch.from_numpy(factors), order, None)


def _batches(cfg, steps):
    return [synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=s)
            for s in range(steps)]


def jax_history(cfg, recipe, state, batches, terms, nudge: bool = False):
    """(state, history): the JAX Trainer's compiled step from ``state`` over
    ``batches``, each step's ``terms``; with ``nudge`` every batch's A moved
    one float32 step up (``np.nextafter``): what float32 rounding alone makes
    of the run. The compiled step donates ``state``."""
    trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    state = place_state(state, trainer.mesh)
    step_fn = trainer.compiled_step()
    hist = []
    for batch in batches:
        if nudge:
            batch = {**batch, "A": np.nextafter(batch["A"], np.float32(np.inf))}
        state, m = step_fn(state, shard_batch(batch, trainer.mesh))
        hist.append([float(m[k]) for k in terms])
    return state, np.asarray(hist)


def _lockstep(cfg, steps, terms=TERMS):
    """``steps`` steps of the JAX Trainer's compiled step and of the port's
    Trainer from one state, on the same batches and draws; each step's
    ``terms`` from both."""
    recipe, state = _jax_state(cfg)
    port_recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, port_recipe, torch.Generator())
    jax_rng = np.asarray(state.rng)  # a host copy: the compiled step donates the state
    trainer = Trainer(cfg, port_recipe, draw_fn=lambda s, b: jax_step_draws(
        jax_rng, s.step, cfg.loss.patch_grid))
    batches = _batches(cfg, steps)
    state, jax_hist = jax_history(cfg, recipe, state, batches, terms)
    port_hist = [[float(m[k]) for k in terms]
                 for m in (trainer.step(port_state, batch) for batch in batches)]
    return state, port_state, jax_hist, np.asarray(port_hist)


def jax_run(cfg, steps, terms=TERMS, nudge: bool = False):
    """``jax_history`` from ``_lockstep``'s state over its batches."""
    recipe, state = _jax_state(cfg)
    return jax_history(cfg, recipe, state, _batches(cfg, steps), terms, nudge)


def _norm(arrays) -> float:
    return float(np.sqrt(sum(float((np.asarray(a, np.float64) ** 2).sum()) for a in arrays)))


def jax_summary(jax_state) -> dict:
    """G's and D's global parameter norms and each D block's spectral sigma
    u . (W v) of a JAX state."""
    state = jax.device_get(jax_state)
    sigma = []
    for i in range(len(state.spectral["D"])):
        w = np.asarray(state.d_params["D"][f"block{i}_conv"]["kernel"], np.float64)
        s = state.spectral["D"][f"block{i}_conv"]
        w2d = w.reshape(-1, w.shape[-1]).T  # (out, kh*kw*in), flax's order
        sigma.append(float(np.asarray(s["u"], np.float64)
                           @ (w2d @ np.asarray(s["v"], np.float64))))
    return {"g_norm": _norm(jax.tree_util.tree_leaves(state.g_params["G"])),
            "d_norm": _norm(jax.tree_util.tree_leaves(state.d_params["D"])), "sigma": sigma}


def port_summary(port_state) -> dict:
    """``jax_summary`` of a port state, in the port's layout."""
    sigma = []
    for block in port_state.D.blocks():
        w = block.w_mat().detach().numpy().astype(np.float64)
        sigma.append(float(block.u.numpy().astype(np.float64)
                           @ (w @ block.v.numpy().astype(np.float64))))
    return {"g_norm": _norm(p.detach().numpy() for p in port_state.G.parameters()),
            "d_norm": _norm(p.detach().numpy() for p in port_state.D.parameters()),
            "sigma": sigma}


def drift_observables(a: dict, b: dict, a_hist, b_hist) -> dict:
    """``TestTrajectoryDrift``'s slow observables of two runs (``jax_summary``
    or ``port_summary`` of each, and histories of ``DRIFT_TERMS``): the
    relative differences of G's and D's global parameter norms, of each D
    block's spectral sigma, and of the last 30 steps' mean loss_G and loss_D
    (with the means); each as (a's, b's, |a / b - 1|)."""
    def rel(x, y):
        return (x, y, abs(x / y - 1))

    iG, iD = DRIFT_TERMS.index("loss_G"), DRIFT_TERMS.index("loss_D")
    tail = min(30, len(a_hist))
    ma, mb = a_hist[-tail:].mean(axis=0), b_hist[-tail:].mean(axis=0)
    return {"g_norm": rel(a["g_norm"], b["g_norm"]), "d_norm": rel(a["d_norm"], b["d_norm"]),
            "sigma": [rel(x, y) for x, y in zip(a["sigma"], b["sigma"])], "tail": tail,
            "tail_loss_G": rel(float(ma[iG]), float(mb[iG])),
            "tail_loss_D": rel(float(ma[iD]), float(mb[iD])),
            "step_rel_G": [abs(x - y) / max(1e-9, abs(y))
                           for x, y in zip(a_hist[:, iG], b_hist[:, iG])],
            "step_rel_D": [abs(x - y) / max(1e-9, abs(y))
                           for x, y in zip(a_hist[:, iD], b_hist[:, iD])]}
