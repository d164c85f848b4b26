"""Serve, checkpoints and refusals of the port's spatial axis on the CPU
(two gloo ranks as a (1 data x 2 spatial) mesh, spawned by
``torch_dist_ranks.spawn``):

- the fft_glo ``Inferencer`` on the pair, as the JAX ``Inferencer`` on
  ``make_mesh(2, spatial=2)`` serves: sharded over the data axis only (one
  share here) and replicated over the spatial ranks, whole images on each;
  both ranks' fake_B equal, within 2e-4 of max|fake_B| of the JAX one (the
  bound of ``test_torch_parallel_tensor_serve.py``); only rank 0 writes;
- a checkpoint of a spatial step written by rank 0 and restored on the pair
  into an unplaced state, then placed: the step, G, D and both Adams'
  moments equal the saved state's bit for bit on both ranks; ``cli test
  --checkpoint`` of it under ``torchrun`` with ``--spatial 2`` writes, on
  rank 0 only, the stacks that one process writes from it, to one 8-bit
  level; the checkpoint is deleted once read;
- a world of 3 processes is not divisible by ``spatial`` = 2, nor by
  ``spatial`` x ``tensor`` = 2 x 2 in a world of 6 (checked in a world of
  2 x 3: 6 divides by 2 and by 3 but the mesh asks 2 x 2): ``ValueError``.
"""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist_ranks as ranks
from test_torch_cli_train import _write_pairs
from test_torch_parallel_cli import _torchrun
from test_torch_train import _cfg as fftglo_cfg
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import generator_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.evaluation.suite import _read_rgb


def test_serve_and_checkpoint_on_a_spatial_pair(tmp_path):
    cfg = fftglo_cfg(64, 2)
    recipe = jax_build_recipe(cfg)
    shapes = jax.eval_shape(recipe.G.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.RandomState(11)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.02).astype(np.float32), shapes)
    weights = tmp_path / "g.pt"
    torch.save(generator_from_flax(params), weights)
    batch = synthetic_batch(3, 64, seed=12)
    train_cfg = fftglo_cfg(64, 2, deterministic_g=False)
    out = ranks.spawn("spatial_serve_and_checkpoint", 2, tmp_path, cfg=cfg, weights=str(weights),
                      batch=batch, tmp=str(tmp_path), train_cfg=train_cfg)
    weights.unlink()
    ckpt = str(tmp_path / "ckpt" / "step_00000001")
    data = str(tmp_path / "data")
    _write_pairs(data, "test", 2, 64, seed=6)
    test = ["test", "--experiment", "fft_glo", "--data-root", data, "--image-size", "64",
            "--batch-size", "2", "--dtype", "float32", "--device", "cpu", "--checkpoint", ckpt]
    served2, served1 = str(tmp_path / "served2"), str(tmp_path / "served1")
    assert _torchrun([*test, "--spatial", "2", "--out-dir", served2]).count("wrote 2 stacks") == 1
    cli.main([*test, "--out-dir", served1])
    shutil.rmtree(tmp_path / "ckpt")
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(served1, "*.png")))
    assert names == ["00000.png", "00001.png"]
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(served2, "*.png"))) == names
    for name in names:
        a = _read_rgb(os.path.join(served2, name)).astype(int)
        b = _read_rgb(os.path.join(served1, name)).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
    assert [o["writes"] for o in out] == [True, False]
    np.testing.assert_array_equal(out[0]["fake_B"], out[1]["fake_B"])
    want = np.asarray(JaxInferencer(cfg, recipe, {"G": params},
                                    mesh=jax_make_mesh(2, spatial=2))(batch))
    scale = np.abs(want).max()
    np.testing.assert_allclose(out[0]["fake_B"] / scale, want / scale, atol=2e-4, rtol=0)
    for o in out:
        assert o["saved"] == o["restored"] == out[0]["saved"], (o["saved"], o["restored"])
        assert o["saved"][0] == 1


def test_a_world_the_axes_do_not_divide_is_refused(tmp_path):
    for world, spatial, tensor, axis in ((3, 2, 1, "'spatial' axis"),
                                         (6, 2, 2, "'spatial' x 'tensor' axes")):
        (tmp_path / str(world)).mkdir()
        out = ranks.spawn("mesh_error", world, tmp_path / str(world), spatial=spatial,
                          tensor=tensor)
        for err in out:
            assert err is not None and err[0] == "ValueError" and axis in err[1], err
