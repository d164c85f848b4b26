"""The port's data axis (``tfcgan_tpu_torch.parallel``) on the CPU: two gloo
ranks, spawned by ``torch_dist_ranks.spawn``, against one process and
against the JAX package on its 8-device CPU mesh (test_torch_parallel_replicas.py
holds the replicas, CycleGAN's buffers and a world-2 checkpoint).

- fft_glo, global batch 8 at 64², float32, deterministic G, one step at
  fixed weights (the JAX state of ``test_torch_train._jax_state`` carried
  over by the bridge) with the JAX step's draws: losses and G gradients of
  world 2 within ``tests/test_train.py``'s 1-vs-8-device bounds of the JAX
  trainer on ``make_mesh(8)`` (metrics rel 2e-3 / abs 1e-5; each G gradient
  element within 3e-3 of its tensor's max|g|, or, where the port's own world
  1 is further from JAX, within world 1's distance + 1e-5: at this batch a
  few elements of G's deepest blocks sit up to 5e-2 of max|g| from JAX in
  one process already, the cross-framework kinks of test_torch_train.py's
  docstring), and within tighter bounds of the port's world 1: metrics rel
  1e-5 / abs 1e-6 and G gradients 1e-4 of max|g| (measured: 1.3e-7 and
  4.8e-6; the two differ only in float32 summation order).
- The collectives: values, and gradients = the ranks' summed upstream ones
  (cut to the rank's rows for the all-gather, routed to the element that
  holds the extreme for max and min), exactly.
- ``TrainBatchNorm`` at world 2 against the JAX module on the whole batch
  (outputs and input gradients, 1e-5), while the local moments miss that
  bound by orders of magnitude; the saliency mask at world 2 equals world 1
  (values, and input gradients to 1e-5 of their max).
- ``shard_batch`` refuses an indivisible batch; ``make_mesh`` refuses a
  spatial or tensor axis that does not divide the world, and a world it
  was not given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_train import _cfg as fftglo_cfg
from test_torch_train import _jax_state, jax_step_draws
from tfcgan_tpu.models.layers import spectral_power_iteration as jax_power_iteration
from tfcgan_tpu.models.thermalgan import TrainBatchNorm as JaxTrainBatchNorm
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tfcgan_tpu_torch.bridge import generator_from_flax, train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.ops.saliency import saliency_mask
from tfcgan_tpu_torch.parallel import Mesh, make_mesh, shard_batch
from tfcgan_tpu_torch.recipes import build_recipe


def _close_metrics(got, want, rel, abs_):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rel, abs=abs_), (k, got[k], want[k])


def _close_grads(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        scale = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(g / scale, w / scale, atol=atol, err_msg=k)


def test_fft_glo_world_two_matches_world_one_and_the_jax_mesh(tmp_path):
    cfg = fftglo_cfg(64, 8)
    recipe, state = _jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    train_state_from_flax(state, port, torch.Generator())
    modules = tmp_path / "modules.pt"
    torch.save({"G": port.G.state_dict(), "D": port.D.state_dict(),
                "lpips": port.lpips.state_dict()}, modules)
    d = jax_step_draws(state.rng, 0, cfg.loss.patch_grid)
    draws = {"neg": d.patch_neg.numpy(), "factors": d.jitter_factors.numpy(),
             "order": list(d.jitter_order)}
    kw = dict(cfg=cfg, modules=str(modules), draws=draws, steps=1, tmp=str(tmp_path))
    w2 = ranks.spawn("fftglo_steps", 2, tmp_path, **kw)
    w1 = ranks.fftglo_steps(0, 1, **kw)
    assert w2[0]["metrics"] == w2[1]["metrics"] and w2[0]["sums"] == w2[1]["sums"]
    assert w2[0]["allreduces"] == 2 and set(w2[0]["bytes"]) == {"G", "D"}  # one flat buffer a phase
    assert w1["allreduces"] == 0

    # the JAX losses and G gradients over the same global batch on 8 devices
    mesh = jax_make_mesh(8)
    batch = jax_shard_batch(synthetic_batch(8, 64, seed=0), mesh)
    spectral = jax_power_iteration(state.d_params, state.spectral)
    g_rng, d_rng = jax.random.split(jax.random.fold_in(state.rng, 0))
    (_, (aux, g_metrics)), g_grads = jax.jit(jax.value_and_grad(recipe.g_loss, has_aux=True))(
        state.g_params, state.d_params, spectral, state.frozen, batch, g_rng)
    (_, d_metrics), _ = jax.jit(jax.value_and_grad(recipe.d_loss, has_aux=True))(
        state.d_params, spectral, aux, batch, d_rng)
    want = {k: float(v) for k, v in {**g_metrics, **d_metrics}.items() if not k.startswith("_")}

    _close_metrics(w2[0]["metrics"][0], want, 2e-3, 1e-5)
    _close_metrics(w2[0]["metrics"][0], w1["metrics"][0], 1e-5, 1e-6)
    g2 = torch.load(tmp_path / "g_grads_2.pt")
    g1 = torch.load(tmp_path / "g_grads_1.pt")
    for name in ("modules.pt", "g_grads_2.pt", "g_grads_1.pt"):  # 424 MB of the suite's disk
        (tmp_path / name).unlink()
    _close_grads(g2, g1, 1e-4)
    # against the JAX mesh: 3e-3 of max|g|, but where one port process is
    # itself further from JAX (G's deepest blocks at 64²: ReLU and
    # instance-norm kinks over 1 x 1 to 4 x 4 maps, up to 5e-2 of max|g| at
    # this batch), world 2 may be no further than world 1 plus 1e-5
    gj = generator_from_flax(jax.device_get(g_grads["G"]))
    assert sorted(g2) == sorted(gj)
    for k in gj:
        w = gj[k].numpy()
        scale = np.abs(w).max() + 1e-8
        err2 = np.abs(g2[k].numpy() - w) / scale
        err1 = np.abs(g1[k].numpy() - w) / scale
        assert (err2 <= np.maximum(3e-3, err1 + 1e-5)).all(), (k, float(err2.max()))


def test_batch_norm_and_saliency_read_the_global_batch(tmp_path):
    check_batch_coupled_ops(tmp_path, world=2)


def check_batch_coupled_ops(tmp_path, world, tensor=1):
    """``TrainBatchNorm``, the saliency mask and the collectives on ``world``
    ranks of a mesh with two data shares, against the whole batch."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 8, 8, 6) * 2 + rng.randn(4, 1, 1, 6) * 3).astype(np.float32)
    w = (1 + 0.02 * rng.randn(6)).astype(np.float32)
    b = (0.1 * rng.randn(6)).astype(np.float32)
    img = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    out = ranks.spawn("batchnorm_and_saliency", world, tmp_path, x=x, w=w, b=b, img=img,
                      tensor=tensor)
    assert all(np.array_equal(o["bn"][i], out[0]["bn"][i]) for o in out for i in (0, 1))

    # the JAX module over the whole batch, and its input gradient
    cot = np.linspace(-1, 1, x.size, dtype=np.float32).reshape(x.shape)
    params = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}
    y, vjp = jax.vjp(lambda v, p: JaxTrainBatchNorm().apply(p, v), jnp.asarray(x), params)
    gx, gp = vjp(jnp.asarray(cot))
    y_port, gx_port = out[0]["bn"]
    np.testing.assert_allclose(y_port, np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(gx_port, np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(out[0]["bn_param_grads"][0], np.asarray(gp["params"]["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[0]["bn_param_grads"][1], np.asarray(gp["params"]["bias"]),
                               rtol=1e-4, atol=1e-4)
    # each rank's own moments miss the bound by far
    assert np.abs(out[0]["bn_local"] - np.asarray(y)).max() > 1e-2

    # the collectives: values, and backward = the ranks' summed upstream
    # gradients (here 1 + 2 = 3 times each rank's own), cut or routed
    base = np.arange(6.0).reshape(3, 2)
    for o in out:
        rank = o["data_rank"]
        c = o["collectives"]
        w6 = np.arange(1.0, 7.0).reshape(3, 2)
        np.testing.assert_array_equal(c["sum"][0], 2 * base + 10)
        np.testing.assert_array_equal(c["sum"][1], 3 * w6)
        np.testing.assert_array_equal(c["gather"][0], np.concatenate([base, base + 10]))
        w12 = np.arange(1.0, 13.0).reshape(6, 2)
        np.testing.assert_array_equal(c["gather"][1], 3 * w12[3 * rank:3 * rank + 3])
        assert float(c["max"][0]) == 15.0 and float(c["min"][0]) == 0.0
        # the extreme is on one rank, one element: it takes the whole summed gradient
        np.testing.assert_array_equal(c["max"][1], (base + 10 * rank == 15) * 3.0)
        np.testing.assert_array_equal(c["min"][1], (base + 10 * rank == 0) * 3.0)

    # the saliency mask: world 2 = world 1, values and input gradients
    whole = torch.from_numpy(img).requires_grad_(True)
    mask = saliency_mask(whole)
    (mask * torch.linspace(-1, 1, mask.numel()).reshape(mask.shape)).sum().backward()
    y2, g2 = out[0]["saliency"]
    np.testing.assert_allclose(y2, mask.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(g2, whole.grad.numpy(), atol=1e-5 * np.abs(g2).max())


def test_refusals():
    two = Mesh(("data",), {"data": 2}, 0, 2, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(synthetic_batch(5, 16), two)
    assert shard_batch(synthetic_batch(4, 16), two)["A"].shape[0] == 2
    for axis in ("spatial", "tensor"):  # a world of 1 has no pair on either axis
        with pytest.raises(ValueError, match=f"not divisible by the '{axis}' axis"):
            make_mesh(**{axis: 2})
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2)  # no torch.distributed group: never a quiet world of one
    one = make_mesh(device="cpu")
    assert one.shape == {"data": 1} and one.group is None
