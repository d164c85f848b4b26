"""The port's ThermalGAN recipe in its three ``d_vae_mode``s and its serve
path against the JAX package's, float32 on the CPU, at 256², batch 1, G2's
dropout off (``deterministic_g``), weights and tolerances as in
``tests/test_torch_thermalgan.py`` (the recipe's gradients: ``RECIPE``).
Also: the detached D_vae stays out of both Adams and unchanged by a step;
the serve path mirrors the JAX Inferencer's normalised temperatures for the
batch-norm variant; ``g_params.npz`` and ``cli test`` serve the family.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_thermalgan import RECIPE, SIZE, _assert_grads, _close, _images, _params_like
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu.train.state import GANTrainState
from tfcgan_tpu.train.state import make_optimizers as jax_make_optimizers
from tfcgan_tpu_torch import bridge, cli
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes.thermalgan import build_generators
from tfcgan_tpu_torch.train.trainer import Trainer, _frozen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the recipe
def _cfg(name="thermalgan", **extra):
    cfg = get_experiment(name)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=1, image_size=SIZE),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={**cfg.extra, "deterministic_g": True, **extra})


def _jax_state(cfg, seed=0):
    """A JAX GANTrainState at step 0 from numpy draws (no flax init run)."""
    recipe = jax_build_recipe(cfg)
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(recipe.init, key, synthetic_batch(1, SIZE))
    g_params = _params_like(shapes["g_params"], seed)
    d_params = _params_like(shapes["d_params"], seed + 1)
    frozen = _params_like(shapes["frozen"], seed + 2)
    g_tx, d_tx = jax_make_optimizers(cfg)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.split(key)[1],
                          g_params=g_params, d_params=d_params, spectral={}, frozen=frozen,
                          g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init(d_params))
    return recipe, state


def _batch(seed=20):
    """Uniform-noise images (no flat blocks for a kink to flip as one), the
    synthetic batch's temperatures."""
    batch = synthetic_batch(1, SIZE, seed=seed)
    return {**batch, "A": _images(1, SIZE, seed + 1), "B": _images(1, SIZE, seed + 2)}


@pytest.mark.parametrize("name,mode", [("thermalgan", None), ("thermalgan_bn", None),
                                       ("thermalgan", "multi_l1")],
                         ids=["detached", "bn-single_mse", "multi_l1"])
def test_losses_and_gradients_at_fixed_weights(name, mode):
    cfg = _cfg(name, **({"d_vae_mode": mode} if mode else {}))
    recipe, state = _jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    want_mode = mode or ("single_mse" if name == "thermalgan_bn" else "detached")
    assert port.d_vae_mode == recipe.d_vae_mode == want_mode
    assert set(dict(port.D.named_children())) == set(state.d_params)
    assert (port.frozen is not None) == ("D_vae" in state.frozen)
    port_state = bridge.train_state_from_flax(state, port, torch.Generator())
    assert port_state.frozen is port.frozen
    batch = _batch()
    rng = jax.random.PRNGKey(0)
    (_, (aux, g_m)), g_grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, {}, state.frozen, batch, rng)
    (_, d_m), d_grads = jax.jit(jax.value_and_grad(recipe.d_loss, has_aux=True))(
        state.d_params, {}, aux, batch, rng)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = port.draw(torch.Generator(), tb)
    assert draws.dropout_masks is None
    with _frozen(port.D):
        loss_g, port_aux, got = port.g_loss(tb, draws)
        loss_g.backward()
    assert all(p.grad is None for p in port.D.parameters())
    loss_d, d_got = port.d_loss(tb, port_aux)
    loss_d.backward()
    got.update(d_got)
    want = {**g_m, **d_m}
    assert set(got) == set(want)
    assert ("d_vae" in got) == (want_mode != "detached")
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert float(want["g_vae_gan"]) > 0 and float(want["g_kl"]) > 0
    _assert_grads(port.G, bridge.thermalgan_generators_from_flax(g_grads), RECIPE)
    _assert_grads(port.D, bridge.thermalgan_discriminators_from_flax(d_grads), RECIPE)
    if port.frozen is not None:
        assert all(p.grad is None for p in port.frozen.parameters())


def test_detached_d_vae_stays_frozen_through_a_step():
    cfg = _cfg()
    port = build_recipe(cfg, "cpu")
    trainer = Trainer(cfg, port)
    state = trainer.init_state(seed=1)
    assert state.frozen is port.frozen and "D_vae" not in dict(port.D.named_children())
    params = {id(p) for opt in (state.opt_g, state.opt_d) for p in opt.param_groups[0]["params"]}
    assert not params & {id(p) for p in port.frozen.parameters()}
    before = {k: v.clone() for k, v in port.frozen.state_dict().items()}
    d_before = port.D["D_pix"].conv0.weight.detach().clone()
    m = trainer.step(state, synthetic_batch(1, SIZE, seed=3))
    assert float(m["g_vae_gan"]) > 0 and "d_vae" not in m
    after = port.frozen.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not torch.equal(d_before, port.D["D_pix"].conv0.weight)


def test_a_training_step_draws_g2_masks():
    cfg = _cfg(deterministic_g=False)
    port = build_recipe(cfg, "cpu")
    assert port.G["G2"].training
    draws = port.draw(torch.Generator().manual_seed(0), {"A": torch.zeros(1, SIZE, SIZE, 3)})
    assert len(draws.dropout_masks) == 9


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("name", ["thermalgan", "thermalgan_bn"])
def test_serve_path_matches_jax(name, tmp_path):
    cfg = _cfg(name)
    recipe, state = _jax_state(cfg)
    jax_inf = JaxInferencer(cfg, recipe, state.g_params)
    nets = build_generators(cfg, "cpu")
    assert not nets.training
    nets.load_state_dict(bridge.thermalgan_generators_from_flax(state.g_params))
    inf = Inferencer(cfg, nets)
    batch = _batch(seed=30)
    got, want = inf(batch), jax_inf(batch)
    _close(got.numpy(), want, 2e-4, "fake_B")
    # the JAX Inferencer normalises the temperatures for the batch-norm
    # variant too, which trained on raw ones: mirrored
    raw = nets["G2"](nets["G1"](torch.from_numpy(batch["A"]), torch.from_numpy(batch["T_B"])))
    assert float((raw - got).abs().max()) > 1e-3
    assert inf.run_test_set([batch], str(tmp_path / "port")) == 1
    assert jax_inf.run_test_set([batch], str(tmp_path / "jax")) == 1
    a = np.asarray(Image.open(tmp_path / "port" / "00000.png")).astype(int)
    b = np.asarray(Image.open(tmp_path / "jax" / "00000.png")).astype(int)
    assert a.shape == b.shape == (3 * SIZE, SIZE, 3) and np.abs(a - b).max() <= 1


def test_npz_and_cli_test_serve_thermalgan(tmp_path):
    cfg = _cfg("thermalgan_bn")
    _, state = _jax_state(cfg)
    npz = str(tmp_path / "g_params.npz")
    spec = importlib.util.spec_from_file_location(
        "export_g_params", os.path.join(REPO, "tools", "export_g_params.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.save_g_params(state.g_params, npz)
    loaded = bridge.load_thermalgan_generators_npz(npz)
    want = bridge.thermalgan_generators_from_flax(state.g_params)
    assert set(loaded) == set(want) == set(build_generators(cfg, "cpu").state_dict())
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    os.makedirs(tmp_path / "data" / "test")
    rng = np.random.RandomState(12)
    Image.fromarray((rng.rand(SIZE, 2 * SIZE, 3) * 255).astype(np.uint8)).save(
        tmp_path / "data" / "test" / "000.png")
    out = str(tmp_path / "out")
    cli.main(["test", "--config", "thermalgan_bn", "--params", npz, "--device", "cpu",
              "--data-root", str(tmp_path / "data"), "--dtype", "float32", "--out-dir", out])
    assert sorted(os.listdir(out)) == ["00000.png"]
    assert np.asarray(Image.open(os.path.join(out, "00000.png"))).shape == (3 * SIZE, SIZE, 3)
