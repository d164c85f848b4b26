"""The port's checkpoints, its plateau controller and its JSONL log, on the CPU.

(a) a resume held to the JAX trainer: one JAX-bridged port step, a save, a
load into a freshly built recipe and two more steps equal 3 JAX steps
(fft_glo at 64², batch 2, float32, deterministic G, the JAX step's draws),
to test_torch_train.py's tolerances over whole steps (loss terms rtol 3e-3 /
atol 1e-4): the third step's losses see the update that the restored Adam
moments and step count made; (b) 3 port steps equal 1 step, a save, a load and 2 steps bit for
bit (metrics, parameters, Adam moments, spectral u/v, the generator's state),
with G's dropout on; (c) save idempotence, atomicity and ``latest_checkpoint``;
(d) ``ReduceLROnPlateau`` against the JAX class on one metric series, every lr
equal, and the trainer leaving a plateau lr alone; (f) ``JsonlLogger`` records
against the JAX logger's; the profiling hooks on the CPU.

About 29 s on one worker with the imports (13 s of it (a), with the JAX
step's compile, and 7 s the six fft_glo steps of (b)).
"""

import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn as nn

from test_torch_train import TERMS, _batches, _cfg, _jax_state, jax_step_draws
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.train.log import JsonlLogger as JaxJsonlLogger
from tfcgan_tpu.train.state import ReduceLROnPlateau as JaxReduceLROnPlateau
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.train import checkpoint
from tfcgan_tpu_torch.train.checkpoint import (AsyncCheckpointManager, latest_checkpoint,
                                               restore_checkpoint, save_checkpoint)
from tfcgan_tpu_torch.train.log import JsonlLogger
from tfcgan_tpu_torch.train.profiling import (StepTimer, count_params, device_memory_summary,
                                              trace)
from tfcgan_tpu_torch.train.state import ReduceLROnPlateau, TrainState, set_learning_rate
from tfcgan_tpu_torch.train.trainer import Trainer


def test_resume_matches_two_jax_steps(tmp_path):
    cfg = _cfg(64, 2)
    recipe, jax_state = _jax_state(cfg)
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    jax_rng = np.asarray(jax_state.rng)  # a host copy: the compiled step donates the state

    def draws(state, batch):
        return jax_step_draws(jax_rng, state.step, cfg.loss.patch_grid)

    port_recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(jax_state, port_recipe, torch.Generator())
    batches = _batches(cfg, 3)
    jax_state = place_state(jax_state, jax_trainer.mesh)
    step_fn = jax_trainer.compiled_step()
    want = []
    for batch in batches:
        jax_state, m = step_fn(jax_state, shard_batch(batch, jax_trainer.mesh))
        want.append([float(m[k]) for k in TERMS])

    metrics = Trainer(cfg, port_recipe, draw_fn=draws).step(port_state, batches[0])
    got = [[float(metrics[k]) for k in TERMS]]
    path = save_checkpoint(str(tmp_path), port_state)
    assert os.path.basename(path) == "step_00000001"
    del port_recipe, port_state

    fresh = build_recipe(cfg, "cpu")
    trainer = Trainer(cfg, fresh, draw_fn=draws)
    resumed = restore_checkpoint(path, trainer.init_state(seed=7))
    assert resumed.step == 1 and resumed.G is fresh.G
    for batch in batches[1:]:
        metrics = trainer.step(resumed, batch)
        got.append([float(metrics[k]) for k in TERMS])
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=1e-4)


def _everything(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor a resume must restore, by name."""
    out = {f"G.{k}": v for k, v in state.G.state_dict().items()}
    out.update({f"D.{k}": v for k, v in state.D.state_dict().items()})  # with u/v
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state[p].items():
                out[f"{name}.{i}.{k}"] = v
    out["generator"] = state.generator.get_state()
    return out


def test_resume_in_the_port_is_bit_exact(tmp_path):
    cfg = _cfg(64, 2).replace(extra={})  # dropout on: G's keep-masks come from the generator
    batches = _batches(cfg, 3)

    trainer = Trainer(cfg, build_recipe(cfg, "cpu"))
    straight = trainer.init_state(seed=3)
    want = [trainer.step(straight, b) for b in batches]
    want_state = _everything(straight)
    del trainer

    trainer = Trainer(cfg, build_recipe(cfg, "cpu"))
    state = trainer.init_state(seed=3)
    got = [trainer.step(state, batches[0])]
    path = save_checkpoint(str(tmp_path), state)
    del trainer, state

    trainer = Trainer(cfg, build_recipe(cfg, "cpu"))
    state = restore_checkpoint(path, trainer.init_state(seed=11))
    got += [trainer.step(state, b) for b in batches[1:]]
    assert state.step == straight.step == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in w)
    got_state = _everything(state)
    assert got_state.keys() == want_state.keys()
    assert any(k.endswith(".u") for k in got_state) and any("exp_avg_sq" in k for k in got_state)
    unequal = [k for k in want_state if not torch.equal(got_state[k], want_state[k])]
    assert not unequal, unequal


def _tiny_state(step: int) -> TrainState:
    g, d = nn.Linear(3, 2), nn.Linear(2, 1)
    return TrainState(step=step, generator=torch.Generator().manual_seed(step), G=g, D=d,
                      lpips=None, opt_g=torch.optim.Adam(g.parameters()),
                      opt_d=torch.optim.Adam(d.parameters()))


def test_save_is_idempotent_and_atomic(tmp_path):
    path = save_checkpoint(str(tmp_path), _tiny_state(4))
    state_file = os.path.join(path, checkpoint.STATE_FILE)
    before = (os.stat(state_file).st_mtime_ns, open(state_file, "rb").read())
    other = _tiny_state(4)  # other weights at the same step: the save changes nothing
    assert save_checkpoint(str(tmp_path), other) == path
    assert (os.stat(state_file).st_mtime_ns, open(state_file, "rb").read()) == before
    restored = restore_checkpoint(path, _tiny_state(0))
    assert restored.step == 4 and not torch.equal(restored.G.weight, other.G.weight)

    with mock.patch.object(checkpoint.torch, "save", side_effect=OSError("disk full")):
        with pytest.raises(OSError, match="disk full"):
            save_checkpoint(str(tmp_path), _tiny_state(5))
        manager = AsyncCheckpointManager(str(tmp_path))
        manager.save(_tiny_state(6))
        with pytest.raises(OSError, match="disk full"):
            manager.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]  # no partial directory

    manager = AsyncCheckpointManager(str(tmp_path))
    assert manager.save(_tiny_state(12)) == os.path.join(tmp_path, "step_00000012")
    assert manager.save(_tiny_state(12)) == os.path.join(tmp_path, "step_00000012")
    manager.save(_tiny_state(9))
    manager.close()
    assert latest_checkpoint(str(tmp_path)) == os.path.join(tmp_path, "step_00000012")
    assert latest_checkpoint(str(tmp_path / "absent")) is None
    with pytest.raises(ValueError, match="another recipe"):
        restore_checkpoint(os.path.join(tmp_path, "step_00000009"),
                           dataclasses.replace(_tiny_state(0), opt_d=None))


# A metric series with improvements, plateaus longer than the patience and a
# change within the relative threshold
SERIES = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.8, 0.795, 0.799, 0.8, 0.81, 0.82,
          0.83, 0.79, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.5, 0.6]


def test_plateau_matches_the_jax_controller():
    ours, theirs = ReduceLROnPlateau(2e-4), JaxReduceLROnPlateau(2e-4)
    lrs = [(ours.step(m), theirs.step(m)) for m in SERIES]
    assert len(SERIES) == 30 and all(a == b for a, b in lrs)
    assert len({a for a, _ in lrs}) == 4  # three cuts on this series
    assert (ours.best, ours.num_bad_epochs) == (theirs.best, theirs.num_bad_epochs)


class _OneParameterRecipe:
    """The least a trainer steps: G one parameter, no discriminator."""

    name = "toy"

    def __init__(self):
        self.device = torch.device("cpu")
        self.G, self.D, self.lpips = nn.Linear(1, 1), nn.Module(), None

    def init(self, generator):
        pass

    def draw(self, generator, batch):
        return None

    def g_loss(self, batch, draws):
        loss = self.G(batch["A"]).square().mean()
        return loss, {}, {"loss_G": loss}

    def d_loss(self, batch, aux):
        return torch.zeros(()), {"loss_D": torch.zeros(())}


@pytest.mark.parametrize("schedule", ["plateau", "linear_decay"])
def test_trainer_leaves_a_plateau_lr_alone(schedule):
    cfg = get_experiment("nemar")
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, schedule=schedule,
                                                decay_start_epoch=0))
    trainer = Trainer(cfg, _OneParameterRecipe())
    state = trainer.init_state(seed=0)
    set_learning_rate(state, 1.5e-5)
    trainer.fit(state, [{"A": np.ones((2, 1), np.float32)}] * 2)
    lr = state.opt_g.param_groups[0]["lr"]
    # linear_decay: the step writes the schedule's lr (epoch 1 of 200, decaying)
    assert lr == (1.5e-5 if schedule == "plateau" else cfg.optim.lr * (1 - 1 / 200))


def test_jsonl_records_match_the_jax_logger(tmp_path, capsys):
    record = {"g_adv": 0.5, "loss_G": float(np.float32(1.25)), "step": 3, "wall_s": 0.125}
    lines = []
    for cls, name in ((JsonlLogger, "port"), (JaxJsonlLogger, "jax")):
        log = cls(str(tmp_path / name / "run.jsonl"))
        log.write(record)
        log.close()
        with open(tmp_path / name / "run.jsonl") as f:
            lines.append(json.loads(f.read()))
        lines[-1]["console"] = capsys.readouterr().out
    port, jax = lines
    assert list(port) == list(jax) == ["ts", *record, "console"]
    assert port.pop("ts") <= jax.pop("ts") and port == jax
    assert port["console"] == "\rg_adv: 0.5000 | loss_G: 1.2500 | step: 3 | wall_s: 0.1250"


def test_profiling_hooks_on_the_cpu(tmp_path):
    recipe = _OneParameterRecipe()
    assert count_params(recipe.G) == 2 and device_memory_summary("cpu") == {}
    timer = StepTimer(batch_size=4)
    assert timer.tick() is None
    with trace(str(tmp_path)):
        recipe.g_loss({"A": torch.ones(2, 1)}, None)
    assert timer.tick() > 0 and os.listdir(tmp_path)  # images/s, and the trace file
