"""The port's CycleGAN over whole steps, float32 on the CPU, at 64²,
``resnet_blocks`` 2, batch 2: a 3-step lockstep with the JAX trainer across
the replay buffers' fill (the buffers' coins and slots rebuilt from the JAX
step's keys, so that the trainer's ``pre_d`` hook pushes and samples as the
JAX one does), and a resume bit for bit with the buffers. Tolerances as in
``tests/test_torch_cyclegan.py``.
"""

import numpy as np
import pytest
import torch

import jax

from test_torch_cyclegan import BATCH, SIZE, TERMS, _batch, _cfg, _jax_state, jax_step_draws
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch import bridge
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.cyclegan import BUFFER_SIZE
from tfcgan_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from tfcgan_tpu_torch.train.trainer import Trainer


def test_three_step_lockstep_with_the_jax_trainer_across_the_fill():
    cfg = _cfg()
    recipe, state = _jax_state(cfg, count=BUFFER_SIZE - 3)  # fills in step 2, full in step 3
    jax_rng = np.asarray(state.rng)
    before = {k: np.asarray(v["data"]).copy() for k, v in state.extra.items()}
    port = build_recipe(cfg, "cpu")
    port_state = bridge.train_state_from_flax(state, port, torch.Generator())
    trainer = Trainer(cfg, port, draw_fn=lambda st, b: jax_step_draws(jax_rng, st.step, BATCH))
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    state = place_state(state, jax_trainer.mesh)
    step_fn = jax_trainer.compiled_step()
    jax_hist, port_hist = [], []
    for i in range(3):
        batch = _batch(30 + 2 * i)
        state, m = step_fn(state, shard_batch(batch, jax_trainer.mesh))
        jax_hist.append([float(m[k]) for k in TERMS])
        mp = trainer.step(port_state, batch)
        port_hist.append([float(mp[k]) for k in TERMS])
    np.testing.assert_allclose(port_hist, jax_hist, rtol=3e-3, atol=1e-4)
    for name in ("buf_A", "buf_B"):
        want = jax.device_get(state.extra[name])
        got = port_state.extra[name]["data"].numpy()
        assert int(port_state.extra[name]["count"]) == int(want["count"]) == BUFFER_SIZE
        np.testing.assert_array_equal((got != before[name]).any(axis=(1, 2, 3)),
                                      (want["data"] != before[name]).any(axis=(1, 2, 3)))
        np.testing.assert_allclose(got, want["data"], atol=5e-2)
    # the third step swapped fakes into the full buffers
    assert port_state.step == int(state.step) == 3


def _fresh(cfg, seed=4):
    port = build_recipe(cfg, "cpu")
    state = Trainer(cfg, port).init_state(seed)
    rng = np.random.RandomState(seed)
    for buf in state.extra.values():  # all but two slots full: the steps fill, then swap
        buf["data"][:BUFFER_SIZE - 2] = torch.from_numpy(
            rng.uniform(-1, 1, (BUFFER_SIZE - 2, SIZE, SIZE, 3)).astype(np.float32))
        buf["count"].fill_(BUFFER_SIZE - 2)
    return port, state


def test_resume_is_bit_for_bit_with_the_buffers(tmp_path):
    cfg = _cfg()
    batches = [_batch(40 + 2 * i) for i in range(3)]
    port, straight = _fresh(cfg)
    trainer = Trainer(cfg, port)
    want = [trainer.step(straight, b) for b in batches]
    port2, state = _fresh(cfg)
    trainer2 = Trainer(cfg, port2)
    got = [trainer2.step(state, batches[0])]
    path = save_checkpoint(str(tmp_path), state)
    port3 = build_recipe(cfg, "cpu")
    trainer3 = Trainer(cfg, port3)
    resumed = restore_checkpoint(path, trainer3.init_state(99, draw=False))
    assert int(resumed.extra["buf_A"]["count"]) == BUFFER_SIZE
    got += [trainer3.step(resumed, b) for b in batches[1:]]
    for g, w in zip(got, want):
        assert {k: float(v) for k, v in g.items()} == {k: float(v) for k, v in w.items()}
    for name in ("buf_A", "buf_B"):
        assert torch.equal(resumed.extra[name]["data"], straight.extra[name]["data"])
        assert int(resumed.extra[name]["count"]) == int(straight.extra[name]["count"])
    a, b = resumed.G.state_dict(), straight.G.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b)
    a, b = resumed.D.state_dict(), straight.D.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b)
    # a checkpoint of another recipe is refused
    other = build_recipe(get_experiment("nemar"), "cpu")
    with pytest.raises(ValueError, match="another recipe"):
        restore_checkpoint(path, Trainer(get_experiment("nemar"), other).init_state(0, draw=False))
