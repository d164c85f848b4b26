"""The port's CycleGAN (the discriminator, the replay buffer, the recipe's
losses, the CLI, the serve path and the unpaired loader) against the JAX
package's, float32 on the CPU, at 64², ``resnet_blocks`` 2, batch 2; whole
steps (the trainer's ``pre_d`` hook over 3 steps, resume) are in
``tests/test_torch_cyclegan_train.py``.

The buffers' draws (a coin and a slot an image) are rebuilt from the JAX
step's keys and handed to the port, so both packages push and sample alike.
Weights are numpy draws carried through the bridge as in
``tests/test_torch_thermalgan.py``. Tolerances: the discriminator's outputs
2e-4 x max|out| and its gradients ``TIGHT``; ``replay_push_sample`` equal
bit for bit (it only moves values); the recipe's loss terms rtol 1e-4 and
its G and D gradients within 1.5e-2 of their L2 norm and 0.1 x max|g|
(``CHAIN``: G_BA(G_AB(A)) and the discriminators stack ReLU kinks behind
instance norms; the port's float32 gradients are 4.4e-3 (L2) and 2.6e-2 x
max|g| from its own float64 ones, and about as far from the JAX package's);
over 3 whole steps the loss terms rtol 3e-3 / atol 1e-4, the buffers' counts
equal and the same slots written, their content within 5e-2 (Adam moves
every weight by about lr a step whatever its gradient's size, so the
weights, and the fakes of steps 2 and 3, move apart by that much where a
gradient is rounding noise); resume bit for bit.
"""

import dataclasses
import importlib.util
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_thermalgan import TIGHT, _assert_grads, _check_module, _images, _params_like
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.data.pairs import UnpairedImageDataset as JaxUnpairedImageDataset
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.recipes import cyclegan as jax_cg
from tfcgan_tpu.train.state import GANTrainState
from tfcgan_tpu.train.state import make_optimizers as jax_make_optimizers
from tfcgan_tpu_torch import bridge, cli
from tfcgan_tpu_torch.data.pairs import UnpairedImageDataset
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.cyclegan import (BUFFER_SIZE, CycleDiscriminator, CycleDraws,
                                               build_generators, replay_push_sample)
from tfcgan_tpu_torch.train.checkpoint import latest_checkpoint
from tfcgan_tpu_torch.train.trainer import _frozen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH = 64, 2
TERMS = ("loss_G", "g_adv", "g_cycle", "g_id", "loss_D", "d_A", "d_B")
CHAIN = (1.5e-2, 0.1)


def test_cycle_discriminator_matches_jax():
    net = CycleDiscriminator()
    assert net.final.bias is not None
    _check_module(jax_cg.CycleDiscriminator(), net, bridge.conv_net_from_flax,
                  [_images(2, SIZE, 1)], TIGHT)


# ---------------------------------------------------------- replay buffer
def _jax_draws(key, n):
    """The coin and slot draws ``replay_push_sample`` makes from ``key``."""
    k1, k2 = jax.random.split(key)
    swap = np.asarray(jax.random.uniform(k1, (n,)) < 0.5)
    slots = np.asarray(jax.random.randint(k2, (n,), 0, BUFFER_SIZE))
    return torch.from_numpy(swap), torch.from_numpy(slots.astype(np.int64))


@pytest.mark.parametrize("count,n,forced", [(0, 8, None), (46, 8, None), (50, 32, None),
                                            (50, 16, (3, 7, 3, 7, 3, 7, 3, 7))],
                         ids=["filling", "crossing-50", "full", "duplicate-slots"])
def test_replay_push_sample_matches_jax(count, n, forced):
    rng = np.random.RandomState(count + n)
    data = rng.uniform(-1, 1, (BUFFER_SIZE, 4, 4, 3)).astype(np.float32)
    data[count:] = 0.0  # what a filling buffer holds beyond its count
    fakes = rng.uniform(-1, 1, (n, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(count + 3 * n)
    buf = {"data": jnp.asarray(data), "count": jnp.asarray(count, jnp.int32)}
    swap, slots = _jax_draws(key, n)
    if forced is not None:
        slots = torch.tensor(forced * (n // len(forced)), dtype=torch.int64)
        with mock.patch.object(jax.random, "randint",
                               lambda k, shape, lo, hi: jnp.asarray(slots.numpy(), jnp.int32)):
            want_buf, want_out = jax_cg.replay_push_sample(buf, jnp.asarray(fakes), key)
        # several elements share each slot, some of them writers, some not
        for s in set(forced):
            sharing = swap[slots == s]
            assert len(sharing) > 2 and bool(sharing.any()) and not bool(sharing.all())
    else:
        want_buf, want_out = jax_cg.replay_push_sample(buf, jnp.asarray(fakes), key)
    got_buf, got_out = replay_push_sample(
        {"data": torch.from_numpy(data), "count": torch.tensor(count)}, torch.from_numpy(fakes),
        swap, slots)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(got_buf["data"].numpy(), np.asarray(want_buf["data"]))
    assert int(got_buf["count"]) == int(want_buf["count"]) == min(count + n, BUFFER_SIZE)
    if count == 46:  # a swap into a slot this batch fills returns its old (zero) content
        assert not np.array_equal(got_out.numpy(), fakes)


# ------------------------------------------------------------ the recipe
def _cfg(**extra):
    cfg = get_experiment("cyclegan")
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=BATCH, image_size=SIZE),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={**cfg.extra, "resnet_blocks": 2, **extra})


def _jax_state(cfg, count=0, seed=0):
    """A JAX GANTrainState at step 0 from numpy draws, its buffers holding
    ``count`` random images."""
    recipe = jax_build_recipe(cfg)
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(recipe.init, key, synthetic_batch(BATCH, SIZE))
    g_params = _params_like(shapes["g_params"], seed)
    d_params = _params_like(shapes["d_params"], seed + 1)
    rng = np.random.RandomState(seed + 2)

    def buffer():
        data = rng.uniform(-1, 1, (BUFFER_SIZE, SIZE, SIZE, 3)).astype(np.float32)
        data[count:] = 0.0
        return {"data": jnp.asarray(data), "count": jnp.asarray(count, jnp.int32)}

    g_tx, d_tx = jax_make_optimizers(cfg)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.split(key)[1],
                          g_params=g_params, d_params=d_params, spectral={}, frozen={},
                          g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init(d_params),
                          extra={"buf_A": buffer(), "buf_B": buffer()})
    return recipe, state


def jax_step_draws(jax_rng, step, n):
    """The port's ``CycleDraws`` of the JAX step ``step``: its D key split
    into the two buffers' keys, as the JAX trainer and ``pre_d`` split it."""
    _, d_rng = jax.random.split(jax.random.fold_in(jnp.asarray(jax_rng), step))
    ka, kb = jax.random.split(d_rng)
    return CycleDraws(*_jax_draws(ka, n), *_jax_draws(kb, n))


def _batch(seed):
    return {"A": _images(BATCH, SIZE, seed), "B": _images(BATCH, SIZE, seed + 1),
            "T_B": synthetic_batch(BATCH, SIZE, seed=seed)["T_B"]}


def test_losses_and_gradients_at_fixed_weights():
    cfg = _cfg()
    recipe, state = _jax_state(cfg, count=BUFFER_SIZE)
    port = build_recipe(cfg, "cpu")
    port_state = bridge.train_state_from_flax(state, port, torch.Generator())
    assert int(port_state.extra["buf_A"]["count"]) == BUFFER_SIZE
    batch = _batch(20)
    rng = jax.random.PRNGKey(5)
    g_rng, d_rng = jax.random.split(rng)
    (_, (aux, g_m)), g_grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, {}, {}, batch, g_rng)
    extra, aux = recipe.pre_d(state.extra, aux, d_rng)
    (_, d_m), d_grads = jax.jit(jax.value_and_grad(recipe.d_loss, has_aux=True))(
        state.d_params, {}, aux, batch, d_rng)
    ka, kb = jax.random.split(d_rng)
    draws = CycleDraws(*_jax_draws(ka, BATCH), *_jax_draws(kb, BATCH))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _frozen(port.D):
        loss_g, port_aux, got = port.g_loss(tb, draws)
        loss_g.backward()
    new_extra, port_aux = port.pre_d(port_state.extra, port_aux, draws)
    loss_d, d_got = port.d_loss(tb, port_aux)
    loss_d.backward()
    got.update(d_got)
    want = {**g_m, **d_m}
    assert set(got) == set(want) == set(TERMS)
    for k in TERMS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    _assert_grads(port.G, bridge.cyclegan_generators_from_flax(g_grads), CHAIN)
    _assert_grads(port.D, bridge.cyclegan_discriminators_from_flax(d_grads), CHAIN)
    for name in ("buf_A", "buf_B"):
        np.testing.assert_allclose(new_extra[name]["data"].numpy(),
                                   np.asarray(extra[name]["data"]), atol=2e-4)


# ------------------------------------------------------------- CLI, data
def _write_pairs(root, split, count, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    for i in range(count):
        img = (rng.rand(SIZE, 2 * SIZE, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, split, f"{i:03d}.png"))


def test_cli_train_resume_and_test(tmp_path):
    data = str(tmp_path / "data")
    _write_pairs(data, "train", 5, 1)
    _write_pairs(data, "test", 3, 2)
    common = ["--experiment", "cyclegan", "--data-root", data, "--image-size", str(SIZE),
              "--batch-size", "2", "--dtype", "float32", "--device", "cpu",
              "--checkpoint-interval", "1", "--sample-interval", "100"]
    runs = str(tmp_path / "runs")
    cli.main(["train", *common, "--n-epochs", "2", "--out-dir", runs])
    assert sorted(d for d in os.listdir(runs) if d.startswith("step_")) == [
        "step_00000003", "step_00000005"]
    resumed = str(tmp_path / "resumed")
    cli.main(["train", *common, "--n-epochs", "1", "--out-dir", resumed,
              "--resume", os.path.join(runs, "step_00000003")])
    assert latest_checkpoint(resumed) == os.path.join(resumed, "step_00000005")
    ckpt = torch.load(os.path.join(latest_checkpoint(runs), "state.pt"), weights_only=True)
    assert int(ckpt["extra"]["buf_A"]["count"]) == 10 and ckpt["frozen"] is None
    out = str(tmp_path / "served")
    cli.main(["test", *common, "--checkpoint", latest_checkpoint(runs), "--out-dir", out])
    assert sorted(os.listdir(out)) == ["00000.png", "00001.png", "00002.png"]
    stack = np.asarray(Image.open(os.path.join(out, "00000.png")))
    assert stack.shape == (4 * SIZE, SIZE, 3)


def test_unpaired_dataset_matches_jax_bit_for_bit(tmp_path):
    rng = np.random.RandomState(3)
    for side, count in (("trainA", 4), ("trainB", 3)):
        os.makedirs(tmp_path / side)
        for i in range(count):
            img = (rng.rand(40 + i, 30, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / side / f"{i}.png")
    for unaligned in (True, False):
        got = UnpairedImageDataset(str(tmp_path), image_size=32, unaligned=unaligned, seed=5)
        want = JaxUnpairedImageDataset(str(tmp_path), image_size=32, unaligned=unaligned, seed=5)
        assert len(got) == len(want) == 4
        for i in (0, 1, 2, 3, 1):
            g, w = got[i], want[i]
            assert set(g) == set(w) == {"A", "B", "T_B"}
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (i, k)
    with pytest.raises(FileNotFoundError):
        UnpairedImageDataset(str(tmp_path), mode="test")


# ------------------------------------------------------------------ serve
def test_serve_path_and_npz_match_jax(tmp_path):
    cfg = _cfg()
    recipe, state = _jax_state(cfg)
    jax_inf = JaxInferencer(cfg, recipe, state.g_params)
    npz = str(tmp_path / "g_params.npz")
    spec = importlib.util.spec_from_file_location(
        "export_g_params", os.path.join(REPO, "tools", "export_g_params.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.save_g_params(state.g_params, npz)
    nets = build_generators(cfg, "cpu")
    assert not nets.training
    nets.load_state_dict(bridge.load_cyclegan_generators_npz(npz))
    inf = Inferencer(cfg, nets)
    batch = _batch(50)
    got, want = inf(batch), jax_inf(batch)
    assert set(got) == set(want) == {"fake_B", "fake_A"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)
    assert inf.run_test_set([batch], str(tmp_path / "port")) == 2
    assert jax_inf.run_test_set([batch], str(tmp_path / "jax")) == 2
    for name in ("00000.png", "00001.png"):
        a = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        assert a.shape == b.shape == (4 * SIZE, SIZE, 3) and np.abs(a - b).max() <= 1, name
